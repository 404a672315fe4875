"""Checkpoints, metric logs and tracing.

The checkpoint and metric names below are imported on first use, so that
the modules of the hot path import ``utils.profiling`` without pulling in
``utils.checkpoint`` (which imports the trainer, which imports them)."""

import importlib

_FROM = {
    "BestCheckpointer": "checkpoint",
    "load_params_npz": "checkpoint",
    "params_from_jax": "checkpoint",
    "restore_checkpoint": "checkpoint",
    "restore_subtree": "checkpoint",
    "save_checkpoint": "checkpoint",
    "MetricLogger": "metrics",
    "format_epoch_line": "metrics",
    "parse_loss_log": "metrics",
}

__all__ = sorted(_FROM)


def __getattr__(name):
    if name not in _FROM:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_FROM[name]}"), name)
