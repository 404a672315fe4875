"""What every kernel wrapper of the port shares: the C entry points with
their argument types, operand checks, the launch stream and the error
check after a launch."""

from __future__ import annotations

import ctypes

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._build import (
    load_kernels,
)

_signatures: dict = {}
_fns: dict = {}


def register_kernel(name: str, symbol: str, argtypes: list,
                    source: str | None = None) -> None:
    """Declare the C entry point ``symbol`` of ``csrc/<source>.cu``
    (``source`` defaults to ``name``)."""
    _signatures[name] = (symbol, argtypes, source or name)


def kernel_fn(name: str):
    """The registered C entry point ``name`` with its argument types;
    builds and loads the kernels on first use."""
    if name not in _fns:
        symbol, argtypes, source = _signatures[name]
        fn = getattr(load_kernels()[source], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_operand(t: torch.Tensor, name: str, dtype, shape, device) -> int:
    """Validate a kernel operand; returns its device pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain version); raises for anything but CPU
    or CUDA."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def cd_flag(dtype) -> int:
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
