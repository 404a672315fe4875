"""Weight-tied edge-conv stack with a hand-written backward
(``molecular_dynamics_neural_operator_tpu/ops/conv_stack.py``).

The GKN applies 2*depth conv layers that all contract the same per-edge
kernel tensor K. Plain autograd would accumulate dK = sum_l xs_l (x) dm_l
one layer at a time, 2*depth passes over a K-sized tensor. This
``autograd.Function`` saves the per-layer activations instead, recomputes
the small per-layer factors xs_l and dm_l in its backward, and forms dK
with one contraction over the layer axis.

The arithmetic is that of ``ops/edge_conv.edge_conv_sparse`` in its
one-hot form, with the same cast points: x, the gathered rows, the
messages, dz and dm are rounded to the compute dtype, every sum is f32,
the relu mask comes from the saved f32 activations, and dK is summed in
f32 and rounded once to K's dtype. Every leading axis is a batch axis.

It is the ``train_conv_impl="xla"`` path's stack and the oracle for the
gradients of the CUDA kernel in ``ops/cuda/train_conv.py``.

``dense_tied_stack`` is its twin on the dense graph: the 2*depth layers
of ``ops/edge_conv.edge_conv_dense`` over one masked kernel tensor, read
in place as (R*w, R*w) matrices, with the same products and roundings
forward and backward as the per-layer path, except that the layers'
bf16 cotangent rows are stacked and dK is one product over the layer
axis, summed in f32 and rounded once.
"""

from __future__ import annotations

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import _onehot
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import round_to
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import count


def conv_stack_forward(depth, cd, x0, kernels, edges, mask, inv_deg,
                       root1, bias1, root2, bias2):
    """The forward sweep: (out (..., R, w), activation stack
    (..., 2*depth+1, R, w)), all f32."""
    r = x0.shape[-2]
    g = _onehot(edges[..., 0, :], r)                            # (..., E, R)
    d = _onehot(edges[..., 1, :], r)
    k = round_to(kernels, cd)
    x = x0.float()
    xs_all = [x]
    for layer in range(2 * depth):
        root, bias = (root1, bias1) if layer < depth else (root2, bias2)
        xr = round_to(x, cd)
        xs = g @ xr                                             # (..., E, w)
        m = torch.einsum("...ew,...ewv->...ev", xs, k) * mask[..., None]
        agg = (d.transpose(-1, -2) @ round_to(m, cd)) * inv_deg[..., None]
        x = torch.relu(agg + xr @ round_to(root, cd) + bias)
        xs_all.append(x)
    return x, torch.stack(xs_all, dim=-3)


def conv_stack_backward(depth, cd, g_out, stack, kernels, edges, mask,
                        inv_deg, root1, root2):
    """The reverse sweep from the saved stack: (dx0, dK in K's dtype,
    droot1, dbias1, droot2, dbias2). droot and dbias keep the leading
    batch axes (per-example partial sums)."""
    r = stack.shape[-2]
    g = _onehot(edges[..., 0, :], r)
    d = _onehot(edges[..., 1, :], r)
    k = round_to(kernels, cd)
    dx = g_out.float()
    lead = stack.shape[:-3]
    w = stack.shape[-1]
    droot = [torch.zeros(lead + (w, w), device=dx.device) for _ in range(2)]
    dbias = [torch.zeros(lead + (w,), device=dx.device) for _ in range(2)]
    xs_l, dm_l = [], []
    for layer in reversed(range(2 * depth)):
        which = 0 if layer < depth else 1
        root = root1 if layer < depth else root2
        x_in = round_to(stack[..., layer, :, :], cd)
        dz = dx * (stack[..., layer + 1, :, :] > 0.0)           # (..., R, w)
        dzr = round_to(dz, cd)
        droot[which] = droot[which] + x_in.transpose(-1, -2) @ dzr
        dbias[which] = dbias[which] + dz.sum(dim=-2)
        dagg = round_to(dz * inv_deg[..., None], cd)
        dm = round_to((d @ dagg) * mask[..., None], cd)         # (..., E, w)
        dxs = torch.einsum("...ev,...ewv->...ew", dm, k)
        dx = (dzr @ round_to(root, cd).transpose(-1, -2)
              + g.transpose(-1, -2) @ round_to(dxs, cd))
        xs_l.append(g @ x_in)
        dm_l.append(dm)
    # one pass forms the whole kernel-tensor gradient: per edge a
    # (w, L) @ (L, w) contraction over the layer axis
    dk = torch.einsum("l...ew,l...ev->...ewv", torch.stack(xs_l),
                      torch.stack(dm_l)).to(kernels.dtype)
    return dx, dk, droot[0], dbias[0], droot[1], dbias[1]


def _sum_lead(t: torch.Tensor, keep: int) -> torch.Tensor:
    """Sum away every axis but the last ``keep``."""
    lead = t.dim() - keep
    return t.sum(dim=tuple(range(lead))) if lead else t


class _TiedConvStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, depth, cd, x0, kernels, edges, mask, inv_deg,
                root1, bias1, root2, bias2):
        out, stack = conv_stack_forward(depth, cd, x0, kernels, edges, mask,
                                        inv_deg, root1, bias1, root2, bias2)
        ctx.save_for_backward(stack, kernels, edges, mask, inv_deg, root1,
                              root2)
        ctx.depth, ctx.cd = depth, cd
        return out

    @staticmethod
    def backward(ctx, g_out):
        stack, kernels, edges, mask, inv_deg, root1, root2 = ctx.saved_tensors
        dx, dk, dr1, db1, dr2, db2 = conv_stack_backward(
            ctx.depth, ctx.cd, g_out, stack, kernels, edges, mask, inv_deg,
            root1, root2)
        return (None, None, dx, dk, None, None, None, _sum_lead(dr1, 2),
                _sum_lead(db1, 1), _sum_lead(dr2, 2), _sum_lead(db2, 1))


def tied_conv_stack(depth: int, compute_dtype, x0, kernels, edges, mask,
                    inv_deg, root1, bias1, root2, bias2):
    """relu(conv1)^depth then relu(conv2)^depth with one shared K.

    x0 (..., R, w) f32; kernels (..., E, w, w) in the compute dtype; edges
    (..., 2, E) int [src; dst]; mask (..., E); inv_deg (..., R); root (w, w)
    and bias (w,) f32. Returns (..., R, w) f32. Differentiable in x0,
    kernels, roots and biases."""
    return _TiedConvStack.apply(depth, compute_dtype, x0, kernels, edges,
                                mask, inv_deg, root1, bias1, root2, bias2)


def _rows_times(rows: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """rows (N, L, K) @ op (N, K, M) in f32: on bf16 tensor cores with an
    f32 accumulation and result for bf16 operands (CUDA only), a plain
    f32 product otherwise."""
    if op.dtype == torch.float32:
        return torch.bmm(rows, op)
    return torch.bmm(rows, op, out_dtype=torch.float32)


class _DenseTiedStack(torch.autograd.Function):
    """The dense tied stack over op (N, R*w, R*w) in bf16 on the card or
    f32. Forward: each layer is ``edge_conv_dense``'s, op times the layer
    input rounded to op's dtype as a row (N, 1, R*w), read in place.
    Backward: per layer the cotangent through the ReLU, droot and dbias,
    the row cotangent gb = (dz * inv_deg) rounded to op's dtype, and dx as
    ``_DenseAggregate`` and autograd form them (gb @ op^T in f32 rounded
    to op's dtype, plus the root term, rounded as the input's cast
    rounds it); then dK is one product of the saved rows as columns
    (N, R*w, L) with the stacked gb (N, L, R*w), f32 accumulated and
    rounded once to op's dtype."""

    @staticmethod
    def forward(ctx, depth, x0, op, inv_deg, root1, bias1, root2, bias2):
        count("dense_tied_stack")
        cd = op.dtype
        n, k = op.shape[0], op.shape[-2]
        x, rows, outs = x0, [], []
        for layer in range(2 * depth):
            root, bias = (root1, bias1) if layer < depth else (root2, bias2)
            xr = round_to(x, cd)
            row = xr.reshape(n, 1, k).to(cd)
            agg = _rows_times(row, op).reshape(xr.shape) * inv_deg[..., None]
            x = torch.relu(agg + xr @ round_to(root, cd) + bias)
            rows.append(row)
            outs.append(x)
        ctx.depth = depth
        ctx.save_for_backward(op, inv_deg, root1, root2, *rows, *outs)
        return x

    @staticmethod
    def backward(ctx, g_out):
        op, inv_deg, root1, root2, *saved = ctx.saved_tensors
        depth = ctx.depth
        layers = 2 * depth
        rows, outs = saved[:layers], saved[layers:]
        cd = op.dtype
        n, k = op.shape[0], op.shape[-2]
        shape, w = g_out.shape, g_out.shape[-1]
        roots = (round_to(root1, cd), round_to(root2, cd))
        gbs = torch.empty((n, layers, k), dtype=cd, device=op.device)
        droot = [torch.zeros_like(root1), torch.zeros_like(root2)]
        dbias = [torch.zeros_like(root1[0]), torch.zeros_like(root2[0])]
        dx = g_out.float()
        for layer in reversed(range(layers)):
            which = int(layer >= depth)
            dz = dx.masked_fill(outs[layer] <= 0.0, 0.0)
            xr = rows[layer].reshape(shape).float()
            dr = round_to(xr.reshape(-1, w).transpose(0, 1)
                          @ dz.reshape(-1, w), cd)
            db = dz.sum(dim=tuple(range(dz.dim() - 1)))
            droot[which] = droot[which] + dr
            dbias[which] = dbias[which] + db
            gb = (dz * inv_deg[..., None]).reshape(n, 1, k).to(cd)
            gbs[:, layer] = gb[:, 0]
            dagg = _rows_times(gb, op.transpose(1, 2)).to(cd).float()
            dx = round_to(dagg.reshape(shape) + dz @ roots[which].T, cd)
        # one product over the layer axis: (N, K, L) @ (N, L, K)
        dk = torch.bmm(torch.cat(rows, dim=1).transpose(1, 2), gbs)
        return (None, dx, dk, None, droot[0], dbias[0], droot[1], dbias[1])


def dense_tied_stack(depth: int, x0, kernels_masked, inv_deg, root1, bias1,
                     root2, bias2):
    """relu(conv1)^depth then relu(conv2)^depth on the dense graph with one
    masked kernel tensor.

    x0 (..., R, w) f32; kernels_masked (..., R, R, w, w) [j, i, w, v] in
    bf16 on the card or f32, the view ``masked_dense_kernels`` returns
    (read in place); inv_deg (..., R); root (w, w) and bias (w,) f32.
    Returns (..., R, w) f32. Differentiable in x0, the kernel tensor,
    roots and biases. Each call adds 1 to the program counter
    ``dense_tied_stack``."""
    r, w = x0.shape[-2], x0.shape[-1]
    op = kernels_masked.transpose(-3, -2).reshape(-1, r * w, r * w)
    return _DenseTiedStack.apply(depth, x0, op, inv_deg, root1, bias1,
                                 root2, bias2)
