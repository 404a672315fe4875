from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    DenseGraph,
    GKNBatch,
    Graph,
    SparseGraph,
    gkn_apply,
    gkn_apply_single,
    gkn_init,
    residual_prior,
)
from molecular_dynamics_neural_operator_tpu_torch.models.losses import (
    lp_abs,
    lp_rel,
    mse,
)

__all__ = ["DenseGraph", "GKNBatch", "Graph", "SparseGraph", "gkn_apply", "gkn_apply_single",
           "gkn_init", "lp_abs", "lp_rel", "mse", "residual_prior"]
