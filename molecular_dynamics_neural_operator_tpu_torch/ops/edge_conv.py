"""Edge-conditioned graph convolution (``molecular_dynamics_neural_operator_tpu/ops/edge_conv.py``).

    x_i' = x_i @ root + mean_{j in N(i)} x_j @ reshape(h(e_ji), w, w) + bias

Sparse padded edge lists with one-hot incidence products (the JAX
package's ``"onehot"`` scatter mode), every function batched over any
leading axes. The kernel matrices are computed once per forward and shared
by all 2*depth layers. Every function is differentiable; the whole tied
stack with a hand-written backward is ``ops/conv_stack.py``, and as a
CUDA kernel ``ops/cuda/train_conv.py``.

Not ported yet (they raise ``NotImplementedError``): the ``"segment"`` and
``"blocked"`` scatter modes, ``edge_conv_dense`` and the int8
``quantize_kernels_int8`` serving option.
"""

from __future__ import annotations

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import (
    mlp_apply,
    round_to,
)

# Above this node count the JAX package aggregates with segment_sum.
SCATTER_ONEHOT_MAX_NODES = 512


def _onehot_only(scatter_mode: str) -> None:
    if scatter_mode != "onehot":
        raise NotImplementedError(
            f"scatter_mode={scatter_mode!r} is not ported yet; only "
            "'onehot' is")


def edge_conv_init(gen: torch.Generator, width: int, device=None):
    """Root weight and bias, uniform in +-1/sqrt(width)."""
    bound = 1.0 / max(width, 1) ** 0.5
    root = torch.empty(width, width).uniform_(-bound, bound, generator=gen)
    bias = torch.empty(width).uniform_(-bound, bound, generator=gen)
    return {"root": root.to(device), "bias": bias.to(device)}


def edge_kernel_matrices(mlp_params, edge_feats: torch.Tensor, width: int,
                         compute_dtype=None,
                         tensor_cores: bool = False) -> torch.Tensor:
    """h(e) for every edge as (..., width, width) in ``compute_dtype``
    (f32 if unset). edge_feats: (..., F)."""
    h = mlp_apply(mlp_params, edge_feats, compute_dtype=compute_dtype,
                  tensor_cores=tensor_cores)
    out_dtype = compute_dtype or torch.float32
    return h.reshape(edge_feats.shape[:-1] + (width, width)).to(out_dtype)


def _onehot(idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(..., E) int -> (..., E, num_nodes) f32 incidence."""
    nodes = torch.arange(num_nodes, device=idx.device)
    return (idx[..., :, None] == nodes).float()


def edge_conv_sparse(conv_params, x, kernels, edges, mask, inv_deg,
                     scatter_mode: str = "onehot", compute_dtype=None):
    """One sparse conv layer.

    x: (..., R, w); kernels: (..., E, w, w); edges: (..., 2, E) int
    [src; dst]; mask: (..., E); inv_deg: (..., R). Gathered rows, messages
    and the root product are rounded to ``compute_dtype`` at the JAX
    package's cast points; every sum accumulates in f32.
    """
    _onehot_only(scatter_mode)
    cd = compute_dtype or x.dtype
    r = x.shape[-2]
    g = _onehot(edges[..., 0, :], r)                            # (..., E, R)
    s = _onehot(edges[..., 1, :], r)
    xs = g @ round_to(x, cd)                                    # (..., E, w)
    m = torch.einsum("...ew,...ewv->...ev", round_to(xs, cd),
                     round_to(kernels, cd))
    m = m * mask[..., None]
    agg = s.transpose(-1, -2) @ round_to(m, cd)                 # (..., R, w)
    agg = agg * inv_deg[..., None]
    root = round_to(x, cd) @ round_to(conv_params["root"], cd)
    return agg + root + conv_params["bias"]


def sparse_inv_degree(edges, mask, num_nodes: int,
                      scatter_mode: str = "onehot") -> torch.Tensor:
    """1 / (number of real incoming edges) per target node, min degree 1.
    Padded slots (mask 0) count for nothing, whatever node they name."""
    _onehot_only(scatter_mode)
    s = _onehot(edges[..., 1, :], num_nodes)                    # (..., E, R)
    deg = (mask.float()[..., None, :] @ s).squeeze(-2)          # (..., R)
    return 1.0 / torch.clamp(deg, min=1.0)


def edge_conv_dense(*args, **kwargs):
    raise NotImplementedError("dense graphs are not ported yet")


def quantize_kernels_int8(*args, **kwargs):
    raise NotImplementedError("kernel_quant='int8' is not ported yet")
