from molecular_dynamics_neural_operator_tpu_torch.geometry.cells import (
    CellListEdges,
    build_cell_table,
    cell_list_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    contact_map,
    contact_map_from_edges,
    degree_from_adjacency,
    dense_edge_features,
    dense_to_padded_edges,
    edge_features_from_edges,
    padded_edges_device,
    pairwise_distances,
    pairwise_sq_distances,
)

__all__ = [
    "CellListEdges",
    "build_cell_table",
    "cell_list_edges",
    "contact_map",
    "contact_map_from_edges",
    "degree_from_adjacency",
    "dense_edge_features",
    "dense_to_padded_edges",
    "edge_features_from_edges",
    "padded_edges_device",
    "pairwise_distances",
    "pairwise_sq_distances",
]
