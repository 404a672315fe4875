from molecular_dynamics_neural_operator_tpu_torch.rollout.baseline import (
    copy_last_baseline,
    damped_extrapolation_baseline,
    linear_extrapolation_baseline,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    make_rollout_fn,
    rebuilt_scatter_hint,
    rollout_python_loop,
    rollout_scan,
    rollout_scan_chunked,
    rollout_with_mse,
)

__all__ = ["copy_last_baseline", "damped_extrapolation_baseline",
           "linear_extrapolation_baseline", "make_rollout_fn",
           "rebuilt_scatter_hint", "rollout_python_loop", "rollout_scan", "rollout_scan_chunked",
           "rollout_with_mse"]
