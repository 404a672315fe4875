"""Linear and MLP primitives (``molecular_dynamics_neural_operator_tpu/ops/mlp.py``).

Parameters are plain dicts of f32 tensors with the JAX package's keys
(``{"w": (in, out), "b": (out,)}``; an MLP is ``{"layer_0": ..., ...}``),
so one checkpoint serves both packages.

Cast points follow the JAX package: with a ``compute_dtype`` the input and
the weight are rounded to it, the product is accumulated in f32 and the
bias is added in f32. Rounding the operands and multiplying them as f32
reproduces that exactly (a bf16 x bf16 product is exact in f32).

``_on_tensor_cores`` alone decides which products run on the card's
tensor cores (``_TensorCoreMatmul``: the same rounded operands, an f32
accumulation in another order).
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import count


_exact_only = False


@contextlib.contextmanager
def exact_products():
    """Within the block every product takes the exact f32 path."""
    global _exact_only
    before, _exact_only = _exact_only, True
    try:
        yield
    finally:
        _exact_only = before


def products_exact() -> bool:
    """True inside ``exact_products()``."""
    return _exact_only


def mm_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for 2-D bf16 CUDA operands, accumulated and returned in f32
    (``torch.mm`` with ``out_dtype``, which the CUDA build provides)."""
    return torch.mm(a, b, out_dtype=torch.float32)


class _TensorCoreMatmul(torch.autograd.Function):
    """x @ w with both rounded to bf16, f32 accumulation and result. The
    gradients are rounded to bf16 as the cast of an operand rounds them
    (straight through), after f32 accumulation."""

    @staticmethod
    def forward(ctx, x, w):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.x_shape = x.shape
        return mm_f32_out(xb, wb).reshape(x.shape[:-1] + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        gb = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = mm_f32_out(gb, wb.t()).to(torch.bfloat16).float().reshape(
                ctx.x_shape)
        if ctx.needs_input_grad[1]:
            gw = mm_f32_out(xb.t(), gb).to(torch.bfloat16).float()
        return gx, gw


def _on_tensor_cores(x, w, compute_dtype) -> bool:
    """Whether ``linear_apply`` multiplies on tensor cores: a CUDA bf16
    product whose weight has a multiple of 8 rows, outside
    ``exact_products()``."""
    return (not _exact_only and x.is_cuda
            and compute_dtype == torch.bfloat16 and w.shape[0] % 8 == 0)


def round_to(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x`` rounded to ``compute_dtype`` and returned as f32 (identity for
    ``None`` or f32): the operand of an f32-accumulated product."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return x.float()
    return x.to(compute_dtype).float()


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                device=None):
    """torch ``nn.Linear``-style init: W and b uniform in +-1/sqrt(in_dim)."""
    bound = 1.0 / max(in_dim, 1) ** 0.5
    w = torch.empty(in_dim, out_dim).uniform_(-bound, bound, generator=gen)
    b = torch.empty(out_dim).uniform_(-bound, bound, generator=gen)
    return {"w": w.to(device), "b": b.to(device)}


def linear_apply(params, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """y = x @ w + b with optional low-precision operands, f32 accumulation.
    Each call that takes ``_TensorCoreMatmul`` adds 1 to the program
    counter ``plain_tc_linear``."""
    if _on_tensor_cores(x, params["w"], compute_dtype):
        count("plain_tc_linear")
        y = _TensorCoreMatmul.apply(x, params["w"])
    else:
        y = torch.matmul(round_to(x, compute_dtype),
                         round_to(params["w"], compute_dtype))
    return y + params["b"].float()


def mlp_init(gen: torch.Generator, sizes: Sequence[int], device=None):
    """MLP with layer widths ``sizes`` (e.g. [6, 1024, 1024, 4096])."""
    return {
        f"layer_{i}": linear_init(gen, sizes[i], sizes[i + 1], device)
        for i in range(len(sizes) - 1)
    }


def mlp_apply(params, x: torch.Tensor, activation=torch.relu,
              compute_dtype=None) -> torch.Tensor:
    """Activation between layers, none after the last."""
    n = len(params)
    for i in range(n):
        x = linear_apply(params[f"layer_{i}"], x, compute_dtype)
        if i != n - 1:
            x = activation(x)
    return x
