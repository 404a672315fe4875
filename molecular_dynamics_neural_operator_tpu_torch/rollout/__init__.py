from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    make_rollout_fn,
    rollout_scan,
    rollout_scan_chunked,
)

__all__ = ["make_rollout_fn", "rollout_scan", "rollout_scan_chunked"]
