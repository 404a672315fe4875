"""Named system presets (``molecular_dynamics_neural_operator_tpu/presets.py``).

The same five ``ModelConfig``s as the JAX package: BBA (28 residues) in
the dense and sparse graph modes, Trp-cage (20) and villin HP35 (35), and
a ~10k-atom solvated system. Edge capacities are about twice the contact
count expected at 8 Å for a compact fold. The port builds, trains and
rolls out models from all five: BBA, Trp-cage and villin on the dense
all-pairs graph, ``BBA_SPARSE`` on the padded edge list, and
``SOLVATED_10K``, which as in the JAX package names the ranked rebuild;
a 10k-atom rollout sets ``neighbor_impl="cell_list"`` (with
``max_degree``, ``cell_capacity`` and ``num_cells``) so that each step
rebuilds its graph with the O(N) cell list of ``geometry/cells.py`` and
aggregates it with the "blocked" reduction.
"""

from __future__ import annotations

import dataclasses

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig

BBA = ModelConfig(num_residues=28, max_edges=384, graph_mode="dense")

BBA_SPARSE = dataclasses.replace(BBA, graph_mode="sparse")

TRP_CAGE = ModelConfig(num_residues=20, max_edges=256, graph_mode="dense",
                       predict_delta=True)

VILLIN = ModelConfig(num_residues=35, max_edges=512, graph_mode="dense",
                     predict_delta=True)

# ~10k atoms: padded neighbor lists with segment aggregation
SOLVATED_10K = ModelConfig(
    num_residues=10_000,
    max_edges=160_000,  # ~16 neighbors/atom at a typical cutoff
    graph_mode="sparse",
    predict_delta=True,
    window_size=4,
)

PRESETS = {
    "bba": BBA,
    "bba_sparse": BBA_SPARSE,
    "trp_cage": TRP_CAGE,
    "villin": VILLIN,
    "solvated_10k": SOLVATED_10K,
}
