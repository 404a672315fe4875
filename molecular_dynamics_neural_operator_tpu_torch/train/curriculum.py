"""The K-step rollout curriculum
(``molecular_dynamics_neural_operator_tpu/train/curriculum.py``).

Teacher forcing alone trains on true windows and then rolls out on the
model's own predictions, the mismatch behind the reference's rollout
collapse. Here a train step unrolls K free-rollout steps: step 1 on the
dataset's stored graph (or one rebuilt from the window's last frame),
steps 2..K on graphs rebuilt from the model's own predictions exactly as
the rollout does (``rollout/scan.py``; all pairs under
``graph_mode="dense"``), and the loss is a weighted sum of the per-step
relative L2 errors. K = 1 is the teacher-forced objective.

The JAX package's ``lax.scan`` over the steps is a Python loop here (K is
static), ``stop_gradient`` is ``.detach()`` and the burn-in of
``grad_steps`` runs under ``torch.no_grad()``. Under
``train_conv_impl="pallas"`` every step's conv stack is the training
kernel of ``ops/cuda/train_conv.py``: K forward launches and, through
autograd, one backward launch per supervised step. Every metric stays a
device tensor; nothing here reads the device.

Spans and counters (``utils/profiling.py``): ``train.curriculum`` around
each call of the K-step train step (on the card it encloses the step's
``graph.replay``, whose graph is named ``curriculum``); issued op by op,
``curriculum.unroll`` around each of the K model steps and
``curriculum.rebuild`` around each rebuilt graph inside it. A step call
adds 1 to ``curriculum_steps``, K to ``curriculum_unrolled``, the
supervised steps to ``curriculum_supervised`` and, on the dense graph,
B * R^2 for each model step to ``dense_pairs``: host integers from the
batch's shapes, counted outside any graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.parallel import comm
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    GKNBatch,
    gkn_apply,
    gkn_apply_single,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    _build_graph,
    _step,
    rebuilt_scatter_hint,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    stays_eager,
)
from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
    graphed_step,
    with_noise,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    featurize_batch,
    value_and_grad,
)
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
    apply_update,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import (
    count,
    span,
)

def _example_rel(pred, truth):
    """Relative L2 of one example on its flattened coordinates."""
    return (torch.linalg.vector_norm((pred - truth).reshape(-1))
            / torch.linalg.vector_norm(truth.reshape(-1)))


def _weights(step_weights, n: int) -> torch.Tensor:
    """(n,) f32 weights of the supervised steps, normalised to sum 1;
    ones by default. They stay on the host: each enters the loss as a
    scalar operand, so a step on the card copies nothing to it."""
    w = (torch.ones(n) if step_weights is None
         else torch.as_tensor(step_weights, dtype=torch.float32))
    if w.shape != (n,):
        raise ValueError(
            f"step_weights must have one weight per SUPERVISED step "
            f"(grad_steps={n}), got shape {tuple(w.shape)}")
    return w / w.sum()


def curriculum_loss_single(params, cfg: ModelConfig, aa, window, graph0,
                           y_seq, threshold: float = 8.0,
                           step_weights: Optional[Sequence[float]] = None,
                           coord_clip: Optional[float] = None):
    """K-step rollout loss of one example: window (T, R, 3), graph0 the
    stored graph of its first step, y_seq (K, R, 3) the true continuation.
    Returns (weighted loss, MSE over the K steps). ``coord_clip`` bounds
    the coordinates fed back through the unroll, as the rollout's clip
    does."""
    k = y_seq.shape[0]
    weights = _weights(step_weights, k)
    out = gkn_apply_single(params, cfg, aa, window, graph0)
    loss = weights[0] * _example_rel(out, y_seq[0])
    sq = torch.sum((out - y_seq[0]) ** 2)
    if k > 1:
        if coord_clip is not None:
            out = torch.clamp(out, -coord_clip, coord_clip)
        window = torch.cat([window[1:], out[None]], dim=0)
        for t in range(1, k):
            window, out, _ = _step(params, cfg, aa, window, threshold,
                                   "last", clip=coord_clip)
            loss = loss + weights[t] * _example_rel(out, y_seq[t])
            sq = sq + torch.sum((out - y_seq[t]) ** 2)
    return loss, sq / (k * y_seq.shape[-2] * y_seq.shape[-1])


def curriculum_loss_batched(params, cfg: ModelConfig, gbatch: GKNBatch,
                            y_seq, threshold: float = 8.0,
                            step_weights: Optional[Sequence[float]] = None,
                            coord_clip: Optional[float] = None,
                            return_overflow: bool = False,
                            loss_space: str = "absolute",
                            grad_steps: Optional[int] = None,
                            burnin_dtype: Optional[str] = None,
                            unroll_scans: bool = False,
                            teacher_scatter_hint: Optional[str] = None,
                            axis_name=None):
    """The whole batch's K-step loss, y_seq (B, K, R, 3): (loss summed over
    the batch, MSE averaged over every step and example) and, with
    ``return_overflow``, (loss, (mse, overflow)), overflow a 0-d bool
    tensor that flags an edge list truncated at ``cfg.max_edges`` in any
    rebuild.

    - ``grad_steps=j`` (1 <= j <= K, default K) supervises only the last j
      steps: the first K - j are a burn-in whose window reaches the
      supervised span detached, so nothing flows back into it; it runs
      under ``torch.no_grad()``.
    - ``burnin_dtype`` runs the burn-in at another compute dtype (only
      where there is one).
    - ``step_weights`` gives one weight per supervised step, normalised to
      sum 1.
    - ``loss_space="delta"`` divides each step's error by the true
      displacement of that step, ``||y_t - y_{t-1}||`` (step 1: from the
      window's last frame), detached and floored at 10 % of its batch mean
      and at 1e-6; ``"absolute"`` divides by ``||y_t||``.
    - ``unroll_scans`` is accepted for the JAX package's signature: the
      loop is unrolled here anyway.
    - ``teacher_scatter_hint`` is the first step's aggregation
      (``gkn_apply``'s ``scatter_hint``): a first-step graph rebuilt on the
      device passes ``rebuilt_scatter_hint``; the free steps always do.
    - ``axis_name``: the process group of the data axis
      (``mesh.get_group("data")``) when this loss runs on one rank's rows
      of a data-parallel batch. The delta floor then pools the
      displacement mean over the GLOBAL batch (the mean of the ranks'
      equal-sized means, the JAX package's ``pmean``), so every rank
      trains the single-process objective; a per-rank mean would train
      another loss.
    """
    del unroll_scans
    b, k = y_seq.shape[0], y_seq.shape[1]
    j = k if grad_steps is None else int(grad_steps)
    if not 1 <= j <= k:
        raise ValueError(f"grad_steps must be in [1, K={k}], got {grad_steps}")
    burn = k - j
    weights = _weights(step_weights, j)
    if loss_space not in ("absolute", "delta"):
        raise ValueError(f"loss_space must be 'absolute' or 'delta', "
                         f"got {loss_space!r}")

    def rel(pred, truth, prev_true):
        diff = torch.sqrt(torch.sum((pred - truth) ** 2, dim=(1, 2)))
        if loss_space == "delta":
            denom = torch.sqrt(torch.sum((truth - prev_true) ** 2,
                                         dim=(1, 2))).detach()
            pooled = torch.mean(denom)
            if axis_name is not None:
                pooled = comm.all_reduce(pooled, axis_name) / comm.size(
                    axis_name)
            denom = torch.maximum(denom, 0.1 * pooled)
            denom = torch.clamp(denom, min=1e-6)
        else:
            denom = torch.sqrt(torch.sum(truth ** 2, dim=(1, 2)))
        return diff / denom

    cfg_burn = cfg
    if burnin_dtype is not None and burn > 0:
        cfg_burn = dataclasses.replace(cfg, compute_dtype=burnin_dtype)

    def burn_in(t: int):
        """No gradient reaches a burn-in step."""
        return torch.no_grad() if t < burn else contextlib.nullcontext()

    def free_step(cfg_x, window, y_t):
        with span("curriculum.rebuild"):
            graph, ov = _build_graph(cfg_x, window[:, -1], threshold)
        out = gkn_apply(params, cfg_x, GKNBatch(aa=gbatch.aa, window=window,
                                                graph=graph, y=y_t),
                        scatter_hint=rebuilt_scatter_hint(
                            cfg_x, window.shape[-2]))
        if coord_clip is not None:
            out = torch.clamp(out, -coord_clip, coord_clip)
        return torch.cat([window[:, 1:], out[:, None]], dim=1), out, ov.any()

    # step 1: the stored graph (or the caller's rebuilt one); it opens the
    # burn-in unless every step is supervised. What the burn-in hands on
    # was made under no_grad: the window reaches the supervised span
    # detached, as the JAX package's stop_gradient leaves it.
    with burn_in(0), span("curriculum.unroll"):
        out = gkn_apply(params, cfg_burn, gbatch,
                        scatter_hint=teacher_scatter_hint)
    if burn == 0:
        loss_vec = weights[0] * rel(out, y_seq[:, 0], gbatch.window[:, -1])
    else:
        loss_vec = torch.zeros(b, device=y_seq.device)
    sq = torch.sum((out.detach() - y_seq[:, 0]) ** 2, dim=(1, 2))
    overflow = torch.zeros((), dtype=torch.bool, device=y_seq.device)
    if k > 1:
        if coord_clip is not None:
            out = torch.clamp(out, -coord_clip, coord_clip)
        window = torch.cat([gbatch.window[:, 1:], out[:, None]], dim=1)
        for t in range(1, k):
            with burn_in(t), span("curriculum.unroll"):
                window, out, ov = free_step(cfg_burn if t < burn else cfg,
                                            window, y_seq[:, t])
            if t >= burn:
                loss_vec = loss_vec + weights[t - burn] * rel(
                    out, y_seq[:, t], y_seq[:, t - 1])
            sq = sq + torch.sum((out.detach() - y_seq[:, t]) ** 2,
                                dim=(1, 2))
            overflow = overflow | ov
    loss = torch.sum(loss_vec)
    msem = torch.mean(sq / (k * y_seq.shape[-2] * y_seq.shape[-1]))
    if return_overflow:
        return loss, (msem, overflow)
    return loss, msem


def make_curriculum_loss(cfg: ModelConfig, rollout_steps: int,
                         threshold: float = 8.0,
                         step_weights: Optional[Sequence[float]] = None,
                         graph_frame: str = "first",
                         coord_clip: Optional[float] = None,
                         loss_space: str = "absolute",
                         grad_steps: Optional[int] = None,
                         burnin_dtype: Optional[str] = None,
                         unroll_scans: bool = False, axis_name=None):
    """loss_fn(params, batch) -> (loss, (mse, overflow)) of the K-step
    curriculum on a batch dict, the loss of ``make_curriculum_train_step``
    and of the data-parallel step (``parallel/mesh.py``, which passes the
    data axis' group as ``axis_name``). A batch whose ``y_seq`` has
    another K than ``rollout_steps`` raises ``ValueError``."""
    if grad_steps is not None and not 1 <= grad_steps <= rollout_steps:
        raise ValueError(
            f"grad_steps must be in [1, rollout_steps={rollout_steps}], "
            f"got {grad_steps}")
    if graph_frame not in ("first", "last", "rebuild"):
        raise ValueError(f"unknown graph_frame: {graph_frame!r} "
                         "(expected 'first', 'last' or 'rebuild')")
    opts = dict(threshold=threshold, step_weights=step_weights,
                coord_clip=coord_clip, return_overflow=True,
                loss_space=loss_space, grad_steps=grad_steps,
                burnin_dtype=burnin_dtype, unroll_scans=unroll_scans,
                axis_name=axis_name)

    def loss_fn(params, batch):
        k = batch["y_seq"].shape[1]
        if k != rollout_steps:
            raise ValueError(
                f"batch carries y_seq with K={k} but the step was built "
                f"with rollout_steps={rollout_steps}: assemble batches with "
                f"batch_iterator(..., rollout_horizon={rollout_steps})")
        if graph_frame != "rebuild":
            return curriculum_loss_batched(
                params, cfg, featurize_batch(cfg, batch, graph_frame),
                batch["y_seq"], **opts)
        graph, ov0 = _build_graph(cfg, batch["window"][:, -1], threshold)
        gbatch = GKNBatch(aa=batch["aa"], window=batch["window"],
                          graph=graph, y=batch["y"])
        loss, (m, ovf) = curriculum_loss_batched(
            params, cfg, gbatch, batch["y_seq"], **opts,
            teacher_scatter_hint=rebuilt_scatter_hint(
                cfg, batch["window"].shape[-2]))
        return loss, (m, ovf | ov0.any())

    return loss_fn


def make_curriculum_train_step(cfg: ModelConfig, tx, rollout_steps: int,
                               threshold: float = 8.0,
                               step_weights: Optional[Sequence[float]] = None,
                               graph_frame: str = "first",
                               coord_clip: Optional[float] = None,
                               loss_space: str = "absolute",
                               grad_steps: Optional[int] = None,
                               noise_std: float = 0.0,
                               burnin_dtype: Optional[str] = None,
                               unroll_scans: bool = False):
    """(state, batch) -> (state, metrics) for batches that carry ``y_seq``
    (B, K, R, 3) with K = ``rollout_steps`` (``batch_iterator(...,
    rollout_horizon=K)``); a batch with another K raises ``ValueError``.
    Metrics are ``rel_l2``, ``mse`` and ``edge_overflow``, 0-d tensors on
    the device (no host read).

    ``graph_frame``: the first step's graph is the stored one with edge
    features from the window's first (``"first"``) or last (``"last"``)
    frame, or is rebuilt on the device from the last frame
    (``"rebuild"``), as the rollout builds it. ``noise_std > 0`` corrupts
    the initial window with the random walk of ``train/noise.py``; the
    free steps feed back the model's own predictions. The other options
    are ``curriculum_loss_batched``'s. On the card the step, its K
    rebuilds included, replays a CUDA graph as ``make_train_step``'s
    does; ``step.eager`` is the step issued op by op. Both count and
    trace each call as the module docstring says."""
    loss_fn = make_curriculum_loss(
        cfg, rollout_steps, threshold=threshold, step_weights=step_weights,
        graph_frame=graph_frame, coord_clip=coord_clip,
        loss_space=loss_space, grad_steps=grad_steps,
        burnin_dtype=burnin_dtype, unroll_scans=unroll_scans)

    def body(state: TrainState, batch: dict):
        batch = with_noise(batch, noise_std)
        (l2, (m, overflow)), grads = value_and_grad(loss_fn, state.params,
                                                    batch)
        return apply_update(state, grads, tx), {
            "rel_l2": l2, "mse": m, "edge_overflow": overflow}

    inner = graphed_step(body, noise_std, eager_only=stays_eager(cfg),
                         name="curriculum")
    supervised = rollout_steps if grad_steps is None else int(grad_steps)

    def counted(run):
        def step(state: TrainState, batch: dict):
            with span("train.curriculum"):
                out = run(state, batch)
            count("curriculum_steps")
            count("curriculum_unrolled", rollout_steps)
            count("curriculum_supervised", supervised)
            if cfg.graph_mode == "dense":
                b, r = batch["window"].shape[0], batch["window"].shape[-2]
                count("dense_pairs", rollout_steps * b * r * r)
            return out
        return step

    step = counted(inner)
    step.eager, step.graphed = counted(inner.eager), inner.graphed
    return step
