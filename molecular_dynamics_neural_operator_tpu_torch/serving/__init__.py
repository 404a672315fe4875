"""Serving: the continuous-batching rollout server, and serving bundles
(one exported rollout step with its weights and config, ``export.py``)."""

from molecular_dynamics_neural_operator_tpu_torch.serving.export import (
    ServingBundle,
    export_rollout,
    load_bundle,
    save_bundle,
)
from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
    RolloutResult,
    RolloutServer,
)

__all__ = ["RolloutResult", "RolloutServer", "ServingBundle",
           "export_rollout", "load_bundle", "save_bundle"]
