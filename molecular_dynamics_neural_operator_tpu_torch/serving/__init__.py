"""Serving: the continuous-batching rollout server. AOT export of a
rollout (the JAX package's ``serving/export.py``) is not ported yet."""

from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
    RolloutResult,
    RolloutServer,
)

__all__ = ["RolloutResult", "RolloutServer"]
