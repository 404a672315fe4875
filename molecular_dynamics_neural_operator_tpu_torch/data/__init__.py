from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
    TrajectoryData,
    aminoacid_int_to_onehot,
    compute_node_features,
    load_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.schema import (
    SchemaWarning,
    contact_maps_have_self_loops,
    detect_pointcloud_layout,
    normalize_amino_labels,
)
from molecular_dynamics_neural_operator_tpu_torch.data.synthetic import (
    langevin_trajectory,
    synthetic_trajectory,
    write_langevin_h5,
    write_synthetic_h5,
    write_synthetic_h5_streamed,
    write_trajectory_h5,
)
from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
    WindowDataset,
    batch_iterator,
)

__all__ = ["SchemaWarning", "TrajectoryData", "WindowDataset",
           "aminoacid_int_to_onehot", "batch_iterator",
           "compute_node_features", "contact_maps_have_self_loops",
           "detect_pointcloud_layout", "langevin_trajectory",
           "load_trajectory", "normalize_amino_labels",
           "synthetic_trajectory", "write_langevin_h5", "write_synthetic_h5",
           "write_synthetic_h5_streamed", "write_trajectory_h5"]
