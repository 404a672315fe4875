from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    BestCheckpointer,
    load_params_npz,
    params_from_jax,
    restore_checkpoint,
    restore_subtree,
    save_checkpoint,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.metrics import (
    MetricLogger,
    format_epoch_line,
    parse_loss_log,
)

__all__ = ["BestCheckpointer", "MetricLogger", "format_epoch_line",
           "load_params_npz", "params_from_jax", "parse_loss_log",
           "restore_checkpoint", "restore_subtree", "save_checkpoint"]
