"""Device selection shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
card is an error, never a silent switch to the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev


def compute_dtype(cfg) -> torch.dtype:
    """The matmul operand type a ``ModelConfig`` names."""
    if cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    if cfg.compute_dtype == "float32":
        return torch.float32
    raise ValueError(f"unknown compute_dtype: {cfg.compute_dtype!r}")


def device_of(tree) -> torch.device:
    """The device of the first tensor leaf of nested dicts."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device
