"""Edge-axis model parallelism for large systems
(``molecular_dynamics_neural_operator_tpu/parallel/edge_sharded.py``).

Each rank of the mesh's "model" axis owns a contiguous slice of the
padded edge list: the edge-kernel MLP runs on local edges only, each conv
layer sums its messages over local edges and all-reduces the (R, width)
partial aggregates over "model", the node state stays replicated (it is
small), and the degrees are all-reduced once. The batch axis goes over
"data", the edge axis over "model", as the JAX package's ``in_specs``.

Gradients. The loss is computed whole on every "model" rank, so the
JAX package's typing of values that are the same on every device and
values that differ by device (``shard_map``) is written out here as the
conjugate pair of tensor parallelism:

- ``_ReduceFromModel``, all-reduce forward and identity backward, on the
  partial aggregates: the cotangent of a replicated aggregate is the same
  on every rank and is each partial sum's cotangent.
- ``_CopyToModel``, identity forward and all-reduce backward, where a
  replicated tensor enters rank-local edges: ``x`` before ``x[src]``, and
  the edge-MLP parameters applied to the local ``edge_feats``. Each rank's
  cotangent there covers its own edges; their sum is the whole gradient.

An all-reduce that summed cotangents everywhere (``torch.distributed.nn``'s)
would make every gradient upstream of it ``model``-size times too large;
one with no backward would leave each rank with its own edges' share.

This path is plain PyTorch, as the JAX package's is plain XLA. The cast
points are the ``"segment"`` scatter's: messages summed in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import compute_dtype
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    _encode_nodes,
    _head,
    check_supported,
)
from molecular_dynamics_neural_operator_tpu_torch.models.losses import (
    lp_rel,
    mse,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    _segment_sum,
    edge_kernel_matrices,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import round_to
from molecular_dynamics_neural_operator_tpu_torch.parallel import comm
from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (
    _rows,
    axis_index,
    axis_size,
    mesh_device,
    sum_over_data,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    value_and_grad,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import tree_map
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
    apply_update,
)


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x, group):
    if comm.size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    if comm.size(group) == 1:
        return x
    return _ReduceFromModel.apply(x, group)


def _forward_edge_shard(params, cfg: ModelConfig, aa, window, edges, mask,
                        edge_feats, group, blocked_offset=None):
    """The forward with a LOCAL edge shard, batched over any leading axes
    of window (..., T, R, 3), edges (..., 2, E_local), mask (..., E_local)
    and edge_feats (..., E_local, F); the one implementation of the train
    step and the edge-sharded rollout. Returns (..., R, out_width), the
    same on every rank of ``group``.

    ``blocked_offset``: the shard is an atom-aligned slice of the
    cell-list block layout (slot a * max_degree + d targets local atom a,
    the global atom ``blocked_offset + a``), so the edges-to-nodes sum is
    a per-atom sum placed into the global node array, with no scatter.
    Never for an edge list packed front to back."""
    check_supported(cfg)
    cd = compute_dtype(cfg)
    r = aa.shape[-1]
    x = _encode_nodes(params, cfg, aa, window)            # (..., R, w)
    w = cfg.width

    def kernel_tensor(name):
        local_params = tree_map(lambda p: copy_to_model(p, group),
                                params[name])
        return edge_kernel_matrices(local_params, edge_feats, w, cd)

    kernels = kernel_tensor("edge_kernel")
    kernels2 = kernels if cfg.tie_edge_kernel \
        else kernel_tensor("edge_kernel2")
    src, dst = edges[..., 0, :], edges[..., 1, :]
    if blocked_offset is not None:
        n_local = mask.shape[-1] // cfg.max_degree
        lo = int(blocked_offset)

        def place(block):
            # (..., n_local, C) into rows lo.. of (..., R, C)
            return F.pad(block, (0, 0, lo, r - lo - n_local))

        def local_aggregate(m):
            return place(m.reshape(m.shape[:-2]
                                   + (n_local, cfg.max_degree, -1)).sum(-2))

        deg = place(mask.reshape(mask.shape[:-1] + (n_local, cfg.max_degree))
                    .sum(-1)[..., None])
    else:
        def local_aggregate(m):
            return _segment_sum(m, dst, r)

        deg = _segment_sum(mask[..., None], dst, r)
    deg = comm.all_reduce(deg.detach(), group)[..., 0]
    inv_deg = 1.0 / torch.clamp(deg, min=1.0)
    src_idx = src.long()[..., None]

    def layer(x, conv, ks):
        xs = torch.take_along_dim(copy_to_model(x, group), src_idx, dim=-2)
        m = torch.einsum("...ew,...ewv->...ev", round_to(xs, cd),
                         round_to(ks, cd)) * mask[..., None]
        agg = reduce_from_model(local_aggregate(m), group)
        root = round_to(x, cd) @ round_to(conv["root"], cd)
        return torch.relu(agg * inv_deg[..., None] + root + conv["bias"])

    for _ in range(cfg.depth):
        x = layer(x, params["conv1"], kernels)
    if not cfg.legacy_no_lstm:
        for _ in range(cfg.depth):
            x = layer(x, params["conv2"], kernels2)
    return _head(params, cfg, window, x, False)


def _local_inputs(mesh, data_axis, model_axis, dev, window, edges, mask,
                  edge_feats, *rest):
    """This rank's rows (by its "data" coordinate) and edge slots (by its
    "model" coordinate) of the global batch, on ``dev``."""
    e = edges.shape[-1]
    n_model = axis_size(mesh, model_axis)
    if e % n_model:
        raise ValueError(f"edge capacity {e} must divide by the "
                         f"'{model_axis}' axis size {n_model}")
    local_e = e // n_model
    j = axis_index(mesh, model_axis)
    cols = slice(j * local_e, (j + 1) * local_e)
    rows = _rows(mesh, window.shape[0], data_axis)

    def put(t, *cols_at):
        # slice where the array lies, then send this rank's part alone
        return torch.as_tensor(t)[(rows,) + cols_at].to(dev)

    return (put(window), put(edges, slice(None), cols), put(mask, cols),
            put(edge_feats, cols)) + tuple(put(t) for t in rest)


def make_edge_sharded_forward(cfg: ModelConfig, mesh,
                              data_axis: str = "data",
                              model_axis: str = "model"):
    """Batched forward with the batch over ``data_axis`` and the edge axis
    over ``model_axis``. Inputs are the GLOBAL arrays: params (every rank
    the same), aa (R,), window (B, T, R, 3), edges (B, 2, E), mask (B, E),
    edge_feats (B, E, F); each rank takes its part. Returns the global
    (B, R, out_width) on every rank (gathered over ``data_axis``). The
    train step differentiates the local forward."""
    group = mesh.get_group(model_axis)
    data_group = mesh.get_group(data_axis)
    dev = mesh_device(mesh)

    def fwd(params, aa, window, edges, mask, edge_feats):
        w, e, m, f = _local_inputs(mesh, data_axis, model_axis, dev, window,
                                   edges, mask, edge_feats)
        out = _forward_edge_shard(params, cfg, torch.as_tensor(aa, device=dev),
                                  w, e, m, f, group)
        return comm.all_gather(out, data_group)

    return fwd


def make_edge_sharded_train_step(cfg: ModelConfig, tx, mesh,
                                 data_axis: str = "data",
                                 model_axis: str = "model"):
    """Data- and edge-parallel train step: the forward with local edges,
    the batch-sum relative L2 loss, gradients through the conjugate
    collectives, then one reduction over ``data_axis`` alone (gradients
    and ``rel_l2`` summed, ``mse`` averaged) and the update, the same on
    every rank. ``step(state, aa, window, edges, mask, edge_feats, y)``
    takes the GLOBAL arrays and returns (state, {"rel_l2", "mse"})."""
    group = mesh.get_group(model_axis)
    data_group = mesh.get_group(data_axis)
    n_data = axis_size(mesh, data_axis)
    dev = mesh_device(mesh)

    def loss_fn(params, aa, window, edges, mask, edge_feats, y):
        out = _forward_edge_shard(params, cfg, aa, window, edges, mask,
                                  edge_feats, group)
        b = out.shape[0]
        return lp_rel(out.reshape(b, -1), y.reshape(b, -1),
                      size_average=False), mse(out, y)

    def step(state: TrainState, aa, window, edges, mask, edge_feats, y):
        local = _local_inputs(mesh, data_axis, model_axis, dev, window,
                              edges, mask, edge_feats, y)
        (l2, m), grads = value_and_grad(loss_fn, state.params,
                                        torch.as_tensor(aa, device=dev),
                                        *local)
        grads, l2, m, _ = sum_over_data(grads, l2, m, None, data_group,
                                        n_data)
        return apply_update(state, grads, tx), {"rel_l2": l2, "mse": m}

    return step
