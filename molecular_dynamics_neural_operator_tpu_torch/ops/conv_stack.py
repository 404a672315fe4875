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
"""

from __future__ import annotations

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import _onehot
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import round_to


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
