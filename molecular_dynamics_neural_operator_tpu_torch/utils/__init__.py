from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    load_params_npz,
    params_from_jax,
    restore_subtree,
    save_checkpoint,
)

__all__ = ["load_params_npz", "params_from_jax", "restore_subtree",
           "save_checkpoint"]
