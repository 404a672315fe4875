"""Train and eval steps and the host epoch loops
(``molecular_dynamics_neural_operator_tpu/train/loop.py``).

The loss is the sum over the batch of per-example relative L2 errors on
the (R*3)-flattened coordinates, with plain MSE tracked alongside.
Per-epoch numbers are means over batches. Edge features are built on the
device from the window inside the step; the host ships coordinates and the
graph only: an edge list, or under ``graph_mode="dense"`` an adjacency.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    prefetch_to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
    batch_iterator,
)
from molecular_dynamics_neural_operator_tpu_torch.device import device_of
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    dense_edge_features,
    edge_features_from_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    DenseGraph,
    GKNBatch,
    SparseGraph,
    gkn_apply,
)
from molecular_dynamics_neural_operator_tpu_torch.models.losses import (
    lp_rel,
    mse,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    stays_eager,
)
from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
    graphed_step,
    with_noise,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import tree_map
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
    apply_update,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import span


def featurize_batch(cfg: ModelConfig, batch: dict,
                    graph_frame: str = "first") -> GKNBatch:
    """Build the GKNBatch from a batch dict of tensors: a ``DenseGraph``
    from ``"adj"``, else a ``SparseGraph`` from ``"edges"`` and ``"mask"``.
    graph_frame: which window frame the edge features come from, "first"
    (the training dataset's convention) or "last" (the rollout's)."""
    if graph_frame not in ("first", "last"):
        raise ValueError(f"unknown graph_frame: {graph_frame!r} "
                         "(expected 'first' or 'last')")
    window = batch["window"]
    frame = window[:, 0] if graph_frame == "first" else window[:, -1]
    if "adj" in batch:
        graph = DenseGraph(adj=batch["adj"],
                           edge_feats=dense_edge_features(frame))
    else:
        graph = SparseGraph(edges=batch["edges"], mask=batch["mask"],
                            edge_feats=edge_features_from_edges(
                                frame, batch["edges"]))
    return GKNBatch(aa=batch["aa"], window=window, graph=graph, y=batch["y"])


def _loss_fn(params, cfg: ModelConfig, gbatch: GKNBatch):
    out = gkn_apply(params, cfg, gbatch)  # (B, R, 3)
    b = out.shape[0]
    l2 = lp_rel(out.reshape(b, -1), gbatch.y.reshape(b, -1),
                size_average=False)
    return l2, (mse(out, gbatch.y), out)


def _detach(aux):
    if isinstance(aux, torch.Tensor):
        return aux.detach()
    return tuple(_detach(a) for a in aux)


def value_and_grad(loss_fn, params, *args):
    """``jax.value_and_grad(loss_fn, has_aux=True)`` for a tree of tensors:
    ((loss, aux), grads) with loss_fn(params, *args) -> (scalar loss, aux),
    aux a tensor or nested tuples of them. Loss and aux come back detached;
    grads is a tree like params, zeros where the loss does not reach a
    leaf."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(leaves, *args)
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), leaves)
    return (loss.detach(), _detach(aux)), grads


def loss_and_grads(params, cfg: ModelConfig, gbatch: GKNBatch):
    """((l2, (mse, out)), grads) of ``_loss_fn`` at ``params``; grads is a
    tree like params."""
    return value_and_grad(_loss_fn, params, cfg, gbatch)


def make_train_step(cfg: ModelConfig, tx, graph_frame: str = "first",
                    noise_std: float = 0.0):
    """Returns (state, batch) -> (state, metrics); batch is a dict of
    tensors on the parameters' device, metrics are 0-d tensors there (no
    host read). ``noise_std > 0`` corrupts the input window with
    random-walk noise (train/noise.py) while the target stays clean; edge
    features follow the noised coordinates, edge connectivity stays the
    stored contact map.

    On the card the step replays a CUDA graph per batch shape over a
    static state (``train/graphed.py``), on the dense and the sparse
    graph alike; the cell list stays eager
    (``ops/cuda/graphs.py::stays_eager``). ``step.eager`` is the step
    issued op by op, the oracle."""

    def body(state: TrainState, batch: dict):
        batch = with_noise(batch, noise_std)
        gbatch = featurize_batch(cfg, batch, graph_frame)
        (l2, (m, _)), grads = loss_and_grads(state.params, cfg, gbatch)
        return apply_update(state, grads, tx), {"rel_l2": l2, "mse": m}

    return graphed_step(body, noise_std, eager_only=stays_eager(cfg),
                        name="teacher-forced train step")


def make_eval_step(cfg: ModelConfig, graph_frame: str = "first"):
    """Eval step honoring an optional per-example 0/1 weight vector
    ``batch["w"]`` (batch_iterator's ``pad_last``): padded duplicate rows
    contribute nothing. "n" is the count of real examples."""

    @torch.no_grad()
    def step(params, batch: dict):
        gbatch = featurize_batch(cfg, batch, graph_frame)
        out = gkn_apply(params, cfg, gbatch)
        b = out.shape[0]
        w = batch.get("w")
        if w is None:
            w = torch.ones(b, device=out.device)
        diff = (out - gbatch.y).reshape(b, -1)
        truth = gbatch.y.reshape(b, -1)
        per_rel = (torch.linalg.vector_norm(diff, dim=1)
                   / torch.linalg.vector_norm(truth, dim=1))
        l2 = (per_rel * w).sum()
        per_sq = (diff * diff).sum(dim=1)
        m = (per_sq * w).sum() / (w.sum() * diff.shape[1])
        return {"rel_l2": l2, "mse": m, "n": w.sum()}

    return step


def _read_metrics(acc: list) -> list:
    """Every per-step metric in one transfer, which also waits for the
    device to finish the steps."""
    keys = list(acc[0])
    flat = torch.stack([m[k].float() for m in acc for k in keys]).tolist()
    return [dict(zip(keys, flat[i * len(keys):(i + 1) * len(keys)]))
            for i in range(len(acc))]


def train_epoch(state, train_step, dataset, indices, batch_size, *,
                shuffle=True, drop_last=True, seed=0, epoch=0,
                put: Optional[Callable] = None, rollout_horizon: int = 0,
                prefetch: int = 2):
    """Host loop over one epoch. Batches flow through
    ``prefetch_to_device`` to the parameters' device, and per-step metrics
    are read from the device once, at the end of the epoch, so the device
    queue runs ahead of the host: that read is the epoch's one wait for
    the device. The returned metrics include ``steps_per_sec`` and
    ``examples_per_sec``, timed from the end of the first step (warm-up:
    kernel build, allocator) to the end of the last, on the card by two
    CUDA events read after that wait.

    Spans (``utils/profiling.py``): ``train.epoch`` around it all,
    ``train.step`` each step's call, ``train.read_metrics`` the read;
    ``prefetch_to_device`` adds the input's."""
    with span("train.epoch"):
        batches = batch_iterator(
            dataset, indices, batch_size, shuffle=shuffle,
            drop_last=drop_last, seed=seed, epoch=epoch,
            rollout_horizon=rollout_horizon)
        dev = device_of(state.params)
        cuda = dev.type == "cuda"
        acc = []
        t0 = first = None
        for batch in prefetch_to_device(batches, size=prefetch, put=put,
                                        device=dev):
            with span("train.step"):
                state, metrics = train_step(state, batch)
            acc.append(metrics)
            if t0 is None:
                if cuda:
                    first = torch.cuda.Event(enable_timing=True)
                    first.record()
                t0 = time.perf_counter()
        if not acc:
            return state, {"rel_l2": 0.0, "mse": 0.0,
                           "steps_per_sec": 0.0, "examples_per_sec": 0.0}
        n = len(acc)
        if cuda:
            last = torch.cuda.Event(enable_timing=True)
            last.record()
        with span("train.read_metrics"):
            acc = _read_metrics(acc)
        if cuda:
            last.synchronize()
            elapsed = first.elapsed_time(last) / 1e3
        else:
            elapsed = time.perf_counter() - t0
    total = {k: sum(m[k] for m in acc) / n for k in ("rel_l2", "mse")}
    rate = (n - 1) / elapsed if elapsed > 0 and n > 1 else 0.0
    total["steps_per_sec"] = rate
    total["examples_per_sec"] = rate * batch_size
    return state, total


def eval_epoch(params, eval_step, dataset, indices, batch_size, *,
               drop_last=False, put: Optional[Callable] = None):
    """Evaluation keeps the remainder batch by default, padded to the
    batch size with weight 0. An empty evaluation returns NaN, not 0.0, so
    a meaningless loss never looks like the best one."""
    acc = []
    for batch in prefetch_to_device(
            batch_iterator(dataset, indices, batch_size, shuffle=False,
                           drop_last=drop_last, pad_last=not drop_last),
            size=2, put=put, device=device_of(params)):
        acc.append(eval_step(params, batch))
    if not acc:
        return {"rel_l2": float("nan"), "mse": float("nan")}
    acc = _read_metrics(acc)
    if "n" in acc[0]:
        # rel_l2 is a per-batch sum over real examples, averaged over the
        # batch count; mse is a per-batch mean, weighted by real counts
        total_n = sum(m["n"] for m in acc)
        rel = sum(m["rel_l2"] for m in acc) / len(acc)
        return {"rel_l2": rel,
                "mse": sum(m["mse"] * m["n"] for m in acc) / total_n}
    return {k: sum(m[k] for m in acc) / len(acc) for k in ("rel_l2", "mse")}
