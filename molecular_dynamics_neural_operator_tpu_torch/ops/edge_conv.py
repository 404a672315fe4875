"""Edge-conditioned graph convolution (``molecular_dynamics_neural_operator_tpu/ops/edge_conv.py``).

    x_i' = x_i @ root + mean_{j in N(i)} x_j @ reshape(h(e_ji), w, w) + bias

Every function is batched over any leading axes and differentiable. The
kernel matrices are computed once per forward and shared by all 2*depth
layers. Two graph forms:

- dense: the (R, R, w, w) kernel tensor pre-multiplied by the adjacency,
  contracted over sources and channels (``edge_conv_dense``);
- sparse: padded edge lists with a ``scatter_mode``: ``"onehot"``
  (incidence products; the rule below 512 nodes), ``"segment"`` (a
  gather and a scatter-add, above) or ``"blocked"`` (the cell-list block
  layout, where slot n*max_degree + d targets node n, so the scatter is a
  per-node sum: with a kernel tensor in the compute dtype, one product of
  each node's masked slots with its block of the kernel tensor).

The whole tied sparse stack with a hand-written backward is
``ops/conv_stack.py``, and as a CUDA kernel ``ops/cuda/train_conv.py``;
the whole tied dense stack is ``ops/conv_stack.py::dense_tied_stack``.
``quantize_kernels_int8`` is the int8 serving option: the per-edge scale
is folded into the message mask.

Cast points, as in the JAX package: ``"onehot"`` rounds each message to
the compute dtype before its scatter product; ``"segment"`` and
``"blocked"`` sum the f32 messages unrounded; the dense conv contracts the
rounded x with the rounded kernel tensor and accumulates in f32. A bf16
kernel tensor on the card is multiplied on tensor cores (``torch.bmm``
with an f32 result) by the dense conv and the blocked layer, outside
``ops/mlp.py::exact_products``: the same operands and an f32
accumulation, its additions in another order.
"""

from __future__ import annotations

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.edge_mlp import (
    edge_mlp_stack,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import (
    mlp_apply,
    products_exact,
    round_to,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import count

# Above this node count the "auto" rule aggregates with the segment
# scatter instead of (E, N) one-hot products.
SCATTER_ONEHOT_MAX_NODES = 512


def _check_blocked_layout(num_edges: int, num_nodes: int) -> None:
    """The "blocked" modes need the cell-list block layout, E ==
    num_nodes * max_degree; divisibility is the checkable part."""
    if num_edges % num_nodes:
        raise ValueError(
            f"blocked scatter requires the cell-list block layout "
            f"(E == num_nodes * max_degree); got E={num_edges}, "
            f"num_nodes={num_nodes}"
        )


def edge_conv_init(gen: torch.Generator, width: int, device=None):
    """Root weight and bias, uniform in +-1/sqrt(width)."""
    bound = 1.0 / max(width, 1) ** 0.5
    root = torch.empty(width, width).uniform_(-bound, bound, generator=gen)
    bias = torch.empty(width).uniform_(-bound, bound, generator=gen)
    return {"root": root.to(device), "bias": bias.to(device)}


def _edge_mlp_stack(ef, w1, b1, w2, b2, w3, b3):
    """relu(relu(ef @ w1 + b1) @ w2 + b2) @ w3 + b3 through
    ``ops/cuda/edge_mlp.py::edge_mlp_stack`` (its plain version on the
    CPU), every row kept: ef (M, F) and the weights bf16, the biases f32;
    returns (M, N) bf16. Each call adds 1 to the program counter
    ``fused_edge_mlp``."""
    m, kw = ef.shape[0], w2.shape[0]
    out = ef.new_empty(m, w3.shape[1])
    edge_mlp_stack(ef, ({"w": w1, "b": b1}, {"w": w2, "b": b2},
                        {"w": w3, "b": b3}), None, ef.new_empty(m, kw),
                   ef.new_empty(m, kw), out)
    count("fused_edge_mlp")
    return out


# The stack as the operator mdno::edge_mlp_stack, so that ``torch.export``
# keeps the kernels in the program it traces. Defined through
# ``torch.library.Library``: ``custom_op`` would import ``torch._dynamo``
# at the first call, seconds of every process's set-up.
_LIB = torch.library.Library("mdno", "DEF")
_LIB.define("edge_mlp_stack(Tensor ef, Tensor w1, Tensor b1, Tensor w2, "
            "Tensor b2, Tensor w3, Tensor b3) -> Tensor")
_LIB.impl("edge_mlp_stack", _edge_mlp_stack, "CompositeExplicitAutograd")


@torch.library.register_fake("mdno::edge_mlp_stack", lib=_LIB)
def _(ef, w1, b1, w2, b2, w3, b3):
    return ef.new_empty(ef.shape[0], w3.shape[1])


def hand_mlp(mlp_params, edge_feats, width: int, compute_dtype) -> bool:
    """Whether ``edge_kernel_matrices`` makes the kernel tensor through
    the hand-written edge-MLP kernels: a CUDA bf16 call outside
    ``exact_products()`` whose output will not be differentiated (grad
    mode off, or no operand requires grad), of an MLP F -> kw -> kw ->
    width**2 with F <= 16 and kw and width**2 multiples of 64, the shapes
    that take the narrow kernel and then the wgmma kernel."""
    if not (edge_feats.is_cuda and compute_dtype == torch.bfloat16
            and not products_exact() and len(mlp_params) == 3):
        return False
    layers = [mlp_params[f"layer_{i}"] for i in range(3)]
    operands = [edge_feats] + [p[k] for p in layers for k in ("w", "b")]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return False
    f, kw = layers[0]["w"].shape
    n = width * width
    return (f <= 16 and kw % 64 == 0 and n % 64 == 0
            and tuple(layers[1]["w"].shape) == (kw, kw)
            and tuple(layers[2]["w"].shape) == (kw, n))


def edge_kernel_matrices(mlp_params, edge_feats: torch.Tensor, width: int,
                         compute_dtype=None) -> torch.Tensor:
    """h(e) for every edge as (..., width, width) in ``compute_dtype``
    (f32 if unset). edge_feats: (..., F); the leading axes are edge axes,
    (E,) sparse or (R, R) dense. Under ``hand_mlp`` the three layers are
    the hand-written kernels, bias, ReLU and the rounding to bf16 done on
    their accumulators (no f32 (E, width**2) tensor); elsewhere
    ``mlp_apply``. The two round at the same points; their f32 sums run
    in another order."""
    lead = edge_feats.shape[:-1]
    if hand_mlp(mlp_params, edge_feats, width, compute_dtype):
        bf16 = torch.bfloat16
        weights = [t for i in range(3) for t in (
            mlp_params[f"layer_{i}"]["w"].to(bf16).contiguous(),
            mlp_params[f"layer_{i}"]["b"].float().contiguous())]
        h = torch.ops.mdno.edge_mlp_stack(
            edge_feats.reshape(-1, edge_feats.shape[-1]).to(bf16)
            .contiguous(), *weights)
        return h.reshape(lead + (width, width))
    h = mlp_apply(mlp_params, edge_feats, compute_dtype=compute_dtype)
    out_dtype = compute_dtype or torch.float32
    return h.reshape(lead + (width, width)).to(out_dtype)


def quantize_kernels_int8(kernels: torch.Tensor):
    """Symmetric per-edge int8 quantization of kernels (..., E, w, w):
    (k8 int8, scale f32 (..., E)) with k8 * scale ~ kernels, scale =
    max|k| / 127 (at least 1e-30 / 127). ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    k = kernels.float()
    amax = torch.amax(torch.abs(k), dim=(-2, -1))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    k8 = torch.clamp(torch.round(k / scale[..., None, None]), -127.0, 127.0)
    return k8.to(torch.int8), scale


class _DenseAggregate(torch.autograd.Function):
    """x (N, 1, K) @ op (N, K, M), both bf16 on the card, accumulated and
    returned in f32 (``torch.bmm`` with ``out_dtype``). The gradients are
    taken from the bf16-rounded cotangent: dx accumulated in f32 and
    rounded to bf16, as the cast of an operand rounds it; dop, one product
    per element, rounded once to the operand's bf16."""

    @staticmethod
    def forward(ctx, xb, op):
        ctx.save_for_backward(xb, op)
        return torch.bmm(xb, op, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        xb, op = ctx.saved_tensors
        gb = g.to(op.dtype)
        dx = dop = None
        if ctx.needs_input_grad[0]:
            dx = torch.bmm(gb, op.transpose(1, 2),
                           out_dtype=torch.float32).to(xb.dtype)
        if ctx.needs_input_grad[1]:
            dop = torch.bmm(xb.transpose(1, 2), gb)
        return dx, dop


def _bf16_product(op: torch.Tensor) -> bool:
    """Whether ``_row_product`` multiplies ``op`` on bf16 tensor cores:
    a bf16 CUDA tensor outside ``exact_products()``."""
    return op.is_cuda and op.dtype == torch.bfloat16 and not products_exact()


def _row_product(row: torch.Tensor, op: torch.Tensor, cd) -> torch.Tensor:
    """row (..., 1, K) @ op (..., K, M) -> (..., 1, M), accumulated and
    returned in f32. Under ``_bf16_product`` the row is rounded to bf16
    and the product is one ``_DenseAggregate`` over the leading axes,
    with ``op`` read in place; elsewhere the row must come rounded to
    ``cd`` and the product is f32 of the rounded operands."""
    k, m = op.shape[-2], op.shape[-1]
    if _bf16_product(op):
        n = row.numel() // k
        out = _DenseAggregate.apply(row.reshape(n, 1, k).to(op.dtype),
                                    op.reshape(n, k, m))
        return out.reshape(row.shape[:-1] + (m,))
    return row @ round_to(op, cd)


def _dense_aggregate(xr: torch.Tensor, op: torch.Tensor, cd) -> torch.Tensor:
    """sum over (j, w) of xr[j, w] op[(j, w), (i, v)]: xr (..., R, w)
    already rounded to ``cd``, op (..., R*w, R*w) -> (..., R, w) f32."""
    row = xr.reshape(xr.shape[:-2] + (1, op.shape[-1]))
    return _row_product(row, op, cd).reshape(xr.shape)


def edge_conv_dense(conv_params, x, kernels_masked, inv_deg,
                    compute_dtype=None):
    """One dense conv layer.

    x: (..., R, w); kernels_masked: (..., R, R, w, w), the kernel tensor
    times the adjacency adj[j, i], source axis first, [j, i, w, v];
    inv_deg: (..., R) = 1/deg_i.
    out[i] = inv_deg[i] * sum_{j, w} x[j, w] K[j, i, w, v] + x[i] @ root
             + bias.
    The sum is one product of x as a row of R*w with K as an (R*w, R*w)
    matrix over [(j, w), (i, v)]: a ``kernels_masked`` that is the
    [j, i, w, v] view of a tensor stored as [j, w, i, v] (what
    ``masked_dense_kernels`` returns) is read in place; any other layout
    is copied into that one first.
    """
    cd = compute_dtype or x.dtype
    r, w = x.shape[-2], x.shape[-1]
    op = kernels_masked.transpose(-3, -2).reshape(
        kernels_masked.shape[:-4] + (r * w, r * w))
    xr = round_to(x, cd)
    agg = _dense_aggregate(xr, op, cd) * inv_deg[..., None]
    root = xr @ round_to(conv_params["root"], cd)
    return agg + root + conv_params["bias"]


def masked_dense_kernels(kernels: torch.Tensor, adj: torch.Tensor,
                         compute_dtype=None) -> torch.Tensor:
    """kernels (..., R, R, w, w) [j, i, w, v] times adj (..., R, R)
    [j, i], in ``compute_dtype`` (f32 if unset; multiplying by 0/1 is
    exact): stored once as [j, w, i, v] and returned as its [j, i, w, v]
    view, the layout ``edge_conv_dense`` contracts without a copy."""
    cd = compute_dtype or torch.float32
    k = kernels.to(cd).transpose(-3, -2)                  # [j, w, i, v]
    masked = k * adj.to(cd)[..., :, None, :, None]
    return masked.contiguous().transpose(-3, -2)


def _onehot(idx: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(..., E) int -> (..., E, num_nodes) f32 incidence."""
    nodes = torch.arange(num_nodes, device=idx.device)
    return (idx[..., :, None] == nodes).float()


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """vals (..., E, C) summed into (..., num_segments, C) by idx
    (..., E)."""
    lead, e, c = vals.shape[:-2], vals.shape[-2], vals.shape[-1]
    v = vals.reshape(-1, e, c)
    index = idx.long().reshape(-1, e, 1).expand(-1, e, c)
    out = torch.zeros(v.shape[0], num_segments, c, dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add(1, index, v).reshape(lead + (num_segments, c))


def edge_conv_sparse(conv_params, x, kernels, edges, mask, inv_deg,
                     scatter_mode: str = "onehot", compute_dtype=None):
    """One sparse conv layer.

    x: (..., R, w); kernels: (..., E, w, w) (int8 is converted before any
    product); edges: (..., 2, E) int [src; dst]; mask: (..., E), which
    may carry a per-edge scale; inv_deg: (..., R). Gathered rows, messages
    and the root product are rounded to ``compute_dtype`` at the JAX
    package's cast points; every sum accumulates in f32.
    """
    cd = compute_dtype or x.dtype
    r = x.shape[-2]
    src, dst = edges[..., 0, :], edges[..., 1, :]
    if scatter_mode == "onehot":
        xs = _onehot(src, r) @ round_to(x, cd)                  # (..., E, w)
    elif scatter_mode in ("segment", "blocked"):
        xs = torch.take_along_dim(x, src.long()[..., None], dim=-2)
    else:
        raise ValueError(f"unknown scatter_mode: {scatter_mode}")
    if scatter_mode == "blocked" and kernels.dtype != torch.int8:
        agg = _blocked_aggregate(xs, kernels, mask, r, cd)
    else:
        m = torch.einsum("...ew,...ewv->...ev", round_to(xs, cd),
                         round_to(kernels, cd))
        m = m * mask[..., None]
        if scatter_mode == "onehot":
            agg = _onehot(dst, r).transpose(-1, -2) @ round_to(m, cd)
        elif scatter_mode == "blocked":
            # an int8 kernel tensor: its scale rides on the mask
            _check_blocked_layout(m.shape[-2], r)
            agg = m.reshape(m.shape[:-2] + (r, -1, m.shape[-1])).sum(dim=-2)
        else:
            agg = _segment_sum(m, dst, r)
    agg = agg * inv_deg[..., None]
    root = round_to(x, cd) @ round_to(conv_params["root"], cd)
    return agg + root + conv_params["bias"]


def _blocked_aggregate(xs, kernels, mask, num_nodes: int, cd):
    """The blocked layer's messages, mask and per-node sum as one product:
    slot n*D + d targets node n (D = max_degree), so
    agg[n, v] = sum_(d, w) (xs * mask)[n, d, w] K[n, d, w, v], each node's
    masked slots a row of D*w times its (D*w, w) block of the kernel
    tensor (..., E, w, w), read in place. The mask must be 0/1: folded
    into the row before the rounding, it is then exact. Padded slots add
    0. Each layer that takes the bf16 product adds 1 to the program
    counter ``blocked_bf16_aggregate``."""
    _check_blocked_layout(kernels.shape[-3], num_nodes)
    row = xs * mask[..., None]
    row = row.reshape(row.shape[:-2] + (num_nodes, 1, -1))
    op = kernels.reshape(kernels.shape[:-3]
                         + (num_nodes, row.shape[-1], kernels.shape[-1]))
    if _bf16_product(op):
        count("blocked_bf16_aggregate")
    else:
        row = round_to(row, cd)
    return _row_product(row, op, cd)[..., 0, :]


def sparse_inv_degree(edges, mask, num_nodes: int,
                      scatter_mode: str = "onehot") -> torch.Tensor:
    """1 / (number of real incoming edges) per target node, min degree 1.
    Padded slots (mask 0) count for nothing, whatever node they name."""
    mask = mask.float()
    if scatter_mode == "onehot":
        s = _onehot(edges[..., 1, :], num_nodes)                # (..., E, R)
        deg = (mask[..., None, :] @ s).squeeze(-2)              # (..., R)
    elif scatter_mode == "blocked":
        _check_blocked_layout(mask.shape[-1], num_nodes)
        deg = mask.reshape(mask.shape[:-1] + (num_nodes, -1)).sum(dim=-1)
    else:
        deg = _segment_sum(mask[..., None], edges[..., 1, :],
                           num_nodes)[..., 0]
    return 1.0 / torch.clamp(deg, min=1.0)
