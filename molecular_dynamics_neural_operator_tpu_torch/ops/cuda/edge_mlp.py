"""The edge-kernel MLP on hand-written Hopper kernels
(``csrc/edge_mlp.cu``, ``csrc/edge_mlp.cuh``): ``edge_mlp`` is one layer
act(a @ w + b) * row_mask for any K, ``edge_mlp_stack`` the three layers
F -> kw -> kw -> n enqueued by one C call, and ``edge_mlp_plain`` the
plain PyTorch version of a layer. Each layer sums its f32 products on the
tensor cores and adds the bias, applies the ReLU and the row mask and
rounds to the compute dtype on its accumulators.

Two layers use them: the persistent rollout and serving step
(``ops/cuda/persistent_rollout.py``, a step's S*E edge rows with the
padded rows masked) and the kernel tensor of the plain model step
(``ops/edge_conv.py::edge_kernel_matrices`` wherever its ``hand_mlp``
says so, every row kept). A wrapper runs the plain version for CPU
tensors only; for CUDA tensors it launches its kernel or raises. The
program counter ``edge_mlp`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._launch import (
    check_operand as _check,
    cd_flag as _cd_flag,
    current_stream as _stream,
    kernel_fn as _kernel,
    on_cpu as _on_cpu,
    raise_on as _raise_on,
    register_kernel,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

_P, _I = ctypes.c_void_p, ctypes.c_int
register_kernel("edge_mlp", "mdno_edge_mlp", [_P] * 5 + [_I] * 5 + [_P])
register_kernel("edge_mlp_stack", "mdno_edge_mlp_stack",
                [_P] * 11 + [_I] * 5 + [_P], source="edge_mlp")


def edge_mlp_plain(a, w, b, relu: bool, row_mask=None):
    """act(a @ w + b) * row_mask in a's dtype, with the products of the
    (already rounded) operands summed in f32."""
    y = a.float() @ w.float() + b
    if relu:
        y = torch.relu(y)
    if row_mask is not None:
        y = y * row_mask[:, None]
    return y.to(a.dtype)


def _check_mlp_alignment(a, w, out, k: int, tag: str) -> None:
    """The bf16 kernels read and write 16 bytes at a time (TMA boxes,
    vector loads and stores): K a multiple of 64 needs a, w and out on
    16-byte boundaries, K <= 16 needs w and out there. A view that starts
    elsewhere raises; no other kernel takes its place."""
    if a.dtype != torch.bfloat16:
        return
    if k % 64 == 0:
        operands = (("a", a), ("w", w), ("out", out))
    elif k <= 16:
        operands = (("w", w), ("out", out))
    else:
        return
    for name, t in operands:
        if t.data_ptr() % 16:
            raise ValueError(f"{tag}: {name} must start on a 16-byte "
                             f"boundary (offset {t.data_ptr() % 16})")


def edge_mlp(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool,
             row_mask: torch.Tensor | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One edge-MLP layer: a (M, K) and w (K, N) in one compute dtype
    (f32 or bf16), b (N,) f32, row_mask (M,) f32 or None; returns out
    (M, N) in the compute dtype. N must be a multiple of 64."""
    m, k = a.shape
    n = w.shape[1]
    if out is None:
        out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    if _on_cpu(a):
        out.copy_(edge_mlp_plain(a, w, b, relu, row_mask))
        return out
    dev, cd = a.device, a.dtype
    if n % 64:
        raise ValueError(f"edge_mlp needs N % 64 == 0, got N={n}")
    _check_mlp_alignment(a, w, out, k, "edge_mlp")
    args = [
        _check(a, "a", cd, (m, k), dev),
        _check(w, "w", cd, (k, n), dev),
        _check(b, "b", torch.float32, (n,), dev),
        None if row_mask is None else _check(row_mask, "row_mask",
                                             torch.float32, (m,), dev),
        _check(out, "out", cd, (m, n), dev),
        m, n, k, int(relu), _cd_flag(cd), _stream(),
    ]
    _raise_on(_kernel("edge_mlp")(*args), "edge_mlp")
    profiling.count("edge_mlp")
    return out


def edge_mlp_stack(ef: torch.Tensor, mlp, row_mask: torch.Tensor | None,
                   h1: torch.Tensor, h2: torch.Tensor,
                   out: torch.Tensor) -> torch.Tensor:
    """The whole edge-kernel MLP of a step: ef (M, F), ``mlp`` three layers
    ``{"w", "b"}`` (F -> kw -> kw -> n), row_mask (M,) f32 or None (every
    row kept); h1, h2 (M, kw) scratch and out (M, n) in the compute dtype.
    Equal to three ``edge_mlp`` calls (ReLU, ReLU, row mask). On the card
    one C call enqueues the three launches; the counter ``edge_mlp``
    counts them."""
    (l0, l1, l2) = mlp
    if _on_cpu(ef):
        edge_mlp(ef, l0["w"], l0["b"], True, out=h1)
        edge_mlp(h1, l1["w"], l1["b"], True, out=h2)
        return edge_mlp(h2, l2["w"], l2["b"], False, row_mask=row_mask,
                        out=out)
    dev, cd, f32 = ef.device, ef.dtype, torch.float32
    m, f = ef.shape
    kw, n = l1["w"].shape[0], l2["w"].shape[1]
    if kw % 64 or n % 64:
        raise ValueError(f"edge_mlp_stack needs widths that are multiples "
                         f"of 64, got {kw} and {n}")
    for a_i, layer, out_i in ((ef, l0, h1), (h1, l1, h2), (h2, l2, out)):
        _check_mlp_alignment(a_i, layer["w"], out_i, layer["w"].shape[0],
                             "edge_mlp_stack")
    args = [
        _check(ef, "ef", cd, (m, f), dev),
        _check(l0["w"], "w1", cd, (f, kw), dev),
        _check(l0["b"], "b1", f32, (kw,), dev),
        _check(l1["w"], "w2", cd, (kw, kw), dev),
        _check(l1["b"], "b2", f32, (kw,), dev),
        _check(l2["w"], "w3", cd, (kw, n), dev),
        _check(l2["b"], "b3", f32, (n,), dev),
        None if row_mask is None else _check(row_mask, "row_mask", f32,
                                             (m,), dev),
        _check(h1, "h1", cd, (m, kw), dev),
        _check(h2, "h2", cd, (m, kw), dev),
        _check(out, "out", cd, (m, n), dev),
        m, kw, n, f, _cd_flag(cd), _stream(),
    ]
    _raise_on(_kernel("edge_mlp_stack")(*args), "edge_mlp_stack")
    profiling.count("edge_mlp", 3)
    return out
