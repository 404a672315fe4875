"""The edge-kernel MLP and both tied conv stacks as one hand-written
Hopper kernel.

Port of the TPU kernel
``molecular_dynamics_neural_operator_tpu/ops/pallas/fused_gkn.py``
(``fused_edge_conv_stack``, adapter ``fused_conv_stack_from_graph``),
reached through ``ModelConfig.conv_impl="pallas"``: forward only,

    ef (E, 6) --MLP--> K (E, w*w), padded rows zero
    2*depth times: x <- relu(mean-aggregate(x_src @ K_e) + x @ root + bias)

and no head. Here the function takes a leading stream axis S (the JAX
package gets it from ``vmap``), the edges as int32 indices instead of the
TPU's one-hot incidence matrices, and R as it is. One call of the C entry
point of ``csrc/fused_gkn.cu`` enqueues the three MLP layers and the
cluster conv stack on the current stream; the wrapper counts it as one
launch.

Cast points follow the XLA path (``gkn_apply_single`` with
``conv_impl="xla"``), as the port's other kernels do, not the Pallas body,
which rounds every product ``xs * K`` to the compute dtype before the f32
sum: so the port's two ``conv_impl`` values agree, in f32 with the JAX
kernel too, and in bf16 within a few roundings of it.

``fused_edge_conv_stack_plain`` is the plain PyTorch version; the wrapper
runs it for CPU tensors only and launches the kernel, or raises, for CUDA
tensors. The program counter ``fused_edge_conv_stack``
(``utils/profiling.py::count``) counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import compute_dtype
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._launch import (
    check_operand as _check,
    cd_flag as _cd_flag,
    current_stream as _stream,
    kernel_fn as _kernel,
    on_cpu as _on_cpu,
    raise_on as _raise_on,
    register_kernel,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._plain import (
    conv_stack_plain,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.edge_mlp import (
    edge_mlp_plain,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    per_capture,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    sparse_inv_degree,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import count

_P, _I = ctypes.c_void_p, ctypes.c_int
register_kernel("fused_gkn", "mdno_fused_edge_conv_stack",
                [_P] * 19 + [_I] * 8 + [_P])


def fused_edge_conv_stack_plain(ef, mask, edges, inv_deg, x0, w1, b1, w2, b2,
                                w3, b3, root1, bias1, root2, bias2,
                                depth: int):
    """Plain version; operands as ``fused_edge_conv_stack``."""
    s, e, f = ef.shape
    a = ef.reshape(s * e, f)
    a = edge_mlp_plain(a, w1, b1, True)
    a = edge_mlp_plain(a, w2, b2, True)
    kmat = edge_mlp_plain(a, w3, b3, False, mask.reshape(-1))
    return conv_stack_plain(x0, kmat, edges, mask, inv_deg,
                            {"root": root1, "bias": bias1},
                            {"root": root2, "bias": bias2}, depth)


def fused_edge_conv_stack(ef, mask, edges, inv_deg, x0, w1, b1, w2, b2, w3,
                          b3, root1, bias1, root2, bias2,
                          depth: int) -> torch.Tensor:
    """ef (S, E, 6), w1 (6, kw), w2 (kw, kw), w3 (kw, w*w), root1/root2
    (w, w) in one compute dtype (f32 or bf16); mask (S, E), inv_deg (S, R),
    x0 (S, R, w), the biases b1/b2 (kw,), b3 (w*w,), bias1/bias2 (w,) in
    f32; edges (S, 2, E) int32 [src; dst], padded slots with mask 0.
    Returns x (S, R, w) f32 after the 2*depth layers."""
    if _on_cpu(x0):
        return fused_edge_conv_stack_plain(
            ef, mask, edges, inv_deg, x0, w1, b1, w2, b2, w3, b3, root1,
            bias1, root2, bias2, depth)
    s, e, f = ef.shape
    _, r, w = x0.shape
    kw = w1.shape[1]
    dev, cd, f32 = x0.device, ef.dtype, torch.float32
    if w % 8 or kw % 64:
        raise ValueError("fused_edge_conv_stack needs a width that is a "
                         "multiple of 8 and a ker_width that is a multiple "
                         f"of 64, got {w} and {kw}")
    h1 = torch.empty(s * e, kw, dtype=cd, device=dev)
    h2 = torch.empty(s * e, kw, dtype=cd, device=dev)
    kmat = torch.empty(s * e, w * w, dtype=cd, device=dev)
    out = torch.empty(s, r, w, dtype=f32, device=dev)
    args = [
        _check(ef, "ef", cd, (s, e, f), dev),
        _check(mask, "mask", f32, (s, e), dev),
        _check(edges, "edges", torch.int32, (s, 2, e), dev),
        _check(inv_deg, "inv_deg", f32, (s, r), dev),
        _check(x0, "x0", f32, (s, r, w), dev),
        _check(w1, "w1", cd, (f, kw), dev), _check(b1, "b1", f32, (kw,), dev),
        _check(w2, "w2", cd, (kw, kw), dev), _check(b2, "b2", f32, (kw,), dev),
        _check(w3, "w3", cd, (kw, w * w), dev),
        _check(b3, "b3", f32, (w * w,), dev),
        _check(root1, "root1", cd, (w, w), dev),
        _check(bias1, "bias1", f32, (w,), dev),
        _check(root2, "root2", cd, (w, w), dev),
        _check(bias2, "bias2", f32, (w,), dev),
        h1.data_ptr(), h2.data_ptr(), kmat.data_ptr(), out.data_ptr(),
        s, r, w, e, kw, f, int(depth), _cd_flag(cd), _stream(),
    ]
    _raise_on(_kernel("fused_gkn")(*args), "fused_edge_conv_stack")
    count("fused_edge_conv_stack")
    return out

# The last parameter set in the kernel's operand types, as one tuple
# (key, sources, cast) that is replaced whole, so that a rollout casts the
# 10 MB of MLP weights once and not at every step, and two threads with two
# models can at worst cast again. The source tensors are held, so their
# identities cannot be reused while the entry lives; an in-place update
# shows in their version counters.
_last_cast = None


def fused_weights(params, cfg: ModelConfig):
    """(w1, b1, w2, b2, w3, b3, root1, bias1, root2, bias2) of ``params``
    as the kernel takes them: weights and roots in the compute dtype,
    biases in f32, contiguous."""
    global _last_cast
    cd = compute_dtype(cfg)
    mlp = params["edge_kernel"]
    if len(mlp) != 3:
        raise ValueError("the edge-kernel MLP must have three layers")
    src = [mlp[f"layer_{i}"][k] for i in range(3) for k in ("w", "b")]
    src += [params[c][k] for c in ("conv1", "conv2") for k in ("root", "bias")]
    key = (cd,) + tuple((id(t), t._version) for t in src)

    def cast():
        with torch.no_grad():
            return tuple(
                t.to(cd if i % 2 == 0 else torch.float32).contiguous()
                for i, t in enumerate(src))

    # inside a captured graph the cast is the graph's own: redone at every
    # replay from the parameters as they are then, and held by the graph
    held = per_capture(key, cast)
    if held is not None:
        return held
    entry = _last_cast
    if entry is None or entry[0] != key:
        entry = _last_cast = (key, src, cast())
    return entry[2]


def fused_conv_stack_from_graph(params, cfg: ModelConfig, x, edges, mask,
                                edge_feats) -> torch.Tensor:
    """Adapter from the GKN sparse graph to the fused kernel: x (..., R, w)
    node features after fc1, edges (..., 2, E), mask (..., E), edge_feats
    (..., E, 6); returns (..., R, w). Padded slots do not count toward a
    node's degree. Needs ``cfg.tie_edge_kernel``: one K drives both conv
    stacks."""
    if not cfg.tie_edge_kernel:
        raise ValueError("pallas conv_impl requires tie_edge_kernel=True")
    cd = compute_dtype(cfg)
    lead = x.shape[:-2]
    r, w = x.shape[-2:]
    e = mask.shape[-1]
    edges = edges.reshape(-1, 2, e)
    mask = mask.reshape(-1, e).float()
    inv_deg = sparse_inv_degree(edges, mask, r)
    out = fused_edge_conv_stack(
        edge_feats.reshape(-1, e, edge_feats.shape[-1]).to(cd).contiguous(),
        mask.contiguous(), edges.to(torch.int32).contiguous(),
        inv_deg.contiguous(), x.reshape(-1, r, w).float().contiguous(),
        *fused_weights(params, cfg), cfg.depth)
    return out.reshape(lead + (r, w))
