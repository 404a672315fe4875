"""The curriculum training recipe
(``molecular_dynamics_neural_operator_tpu/train/recipe.py``).

A teacher-forced (K = 1) warm-up, then the K-step curriculum, with the
stabilisers the trainer configuration turns on (gradient clip, skipping
non-finite updates) and the coordinate clip inside the unroll.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    prefetch_to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
    batch_iterator,
)
from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.train.curriculum import (
    make_curriculum_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import tree_map
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    create_train_state,
)


def train_curriculum_recipe(cfg, tcfg, dataset, train_indices, *,
                            steps: int, k: int = 4,
                            warmup_frac: float = 0.25,
                            coord_clip: float | None = 1000.0,
                            threshold: float = 8.0, seed: int = 0,
                            log_every: int = 200, log_prefix: str = "",
                            min_warmup: int = 200,
                            loss_space: str = "absolute",
                            grad_steps="default",
                            burnin_dtype: str | None = None,
                            noise_std: float = 0.0,
                            divergence_limit: int = 4,
                            on_divergence: str = "abort",
                            max_backoffs: int = 2,
                            explosion_factor: float = 1e4,
                            graph_frame: str = "first", device=None):
    """Train ``steps`` optimizer steps: the first ``warmup_frac`` of them
    (at least ``min_warmup``) teacher-forced (K = 1), the rest with the
    K-step curriculum. The switch to K happens exactly at the step
    boundary, mid-epoch if it falls there. Returns (state, seconds, loss of
    the last step).

    The parameters start from ``gkn_init(seed)`` on ``device`` (the card
    unless ``"cpu"``). The loss is read from the device every
    ``log_every`` steps and printed, and after the last step.

    ``grad_steps="default"`` is 1 for K > 1 (backpropagation through the
    last step only, after a K - 1 step burn-in) and full backpropagation
    for K = 1; ``None`` is full backpropagation through all K steps.

    ``divergence_limit``: once that many consecutive logged losses are bad
    (non-finite, or above ``explosion_factor`` times the best logged
    loss), ``on_divergence="abort"`` raises ``RuntimeError`` and
    ``"backoff"`` restores the last parameters with a good logged loss,
    halves the learning rate with a fresh optimizer, and goes on from the
    same step count, at most ``max_backoffs`` times before it aborts.
    0 turns the check off."""
    if grad_steps == "default":
        grad_steps = 1 if k > 1 else None

    lr_scale, backoffs = 1.0, 0

    def build(tcfg_eff):
        state, tx, _ = create_train_state(
            seed, cfg, tcfg_eff, device=device,
            steps_per_epoch=max(1, len(train_indices) // tcfg.batch_size))
        opts = dict(threshold=threshold, coord_clip=coord_clip,
                    loss_space=loss_space, noise_std=noise_std,
                    graph_frame=graph_frame)
        step_k1 = make_curriculum_train_step(cfg, tx, rollout_steps=1,
                                             **opts)
        step_k = make_curriculum_train_step(
            cfg, tx, rollout_steps=k, grad_steps=grad_steps,
            burnin_dtype=burnin_dtype, **opts)
        return state, step_k1, step_k

    state, step_k1, step_k = build(tcfg)
    dev = resolve_device(device)
    # On the card a step copies the state it is given into its CUDA
    # graph's own and writes each later step's parameters there, into the
    # tensors it returned: a good state from a step is kept as a copy.
    good_params = state.params
    warmup = max(min_warmup, int(steps * warmup_frac))

    t0 = time.time()
    seen, epoch, last_loss = 0, 0, None
    bad_logs, first_bad, best_loss = 0, None, None
    while seen < steps:
        k_now = 1 if seen < warmup else k
        batches = batch_iterator(dataset, train_indices, tcfg.batch_size,
                                 seed=seed, epoch=epoch,
                                 rollout_horizon=k_now)
        for batch in prefetch_to_device(batches, size=2, device=dev):
            state, m = (step_k1 if k_now == 1 else step_k)(state, batch)
            seen += 1
            if seen % log_every == 0:
                last_loss = float(m["rel_l2"])
                print(f"{log_prefix}step {seen}: loss {last_loss:.4f} "
                      f"(K={k_now}, {time.time() - t0:.0f}s)", flush=True)
                if divergence_limit:
                    exploded = (best_loss is not None and last_loss
                                > explosion_factor * max(best_loss, 1e-30))
                    if math.isfinite(last_loss) and not exploded:
                        bad_logs, first_bad = 0, None
                        good_params = tree_map(torch.clone,
                                               state.params)
                        best_loss = (last_loss if best_loss is None
                                     else min(best_loss, last_loss))
                    else:
                        bad_logs += 1
                        if first_bad is None:
                            first_bad = seen
                        if bad_logs >= divergence_limit:
                            if (on_divergence == "backoff"
                                    and backoffs < max_backoffs):
                                backoffs += 1
                                lr_scale *= 0.5
                                print(f"{log_prefix}DIVERGED at step <= "
                                      f"{first_bad}: restoring last-good "
                                      f"params, lr x{lr_scale} (backoff "
                                      f"{backoffs}/{max_backoffs})",
                                      flush=True)
                                state, step_k1, step_k = build(
                                    dataclasses.replace(
                                        tcfg, lr=tcfg.lr * lr_scale))
                                state = state._replace(params=good_params)
                                bad_logs, first_bad = 0, None
                                break  # a fresh epoch iterator
                            raise RuntimeError(
                                f"training diverged: the logged loss has "
                                f"been non-finite or exploded (>"
                                f"{explosion_factor:g}x the best logged "
                                f"loss) for {bad_logs} consecutive "
                                f"checkpoints (since step <= {first_bad}) "
                                f"- lower the lr or tighten grad/coord "
                                f"clipping")
            if seen >= steps:
                last_loss = float(m["rel_l2"])
                break
            if k_now == 1 and seen >= warmup:
                # the iterator was built for K = 1: restart it at K
                break
        epoch += 1
    return state, time.time() - t0, last_loss
