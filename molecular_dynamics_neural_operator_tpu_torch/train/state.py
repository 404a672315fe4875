"""Train state: params + optimizer state + step + seed
(``molecular_dynamics_neural_operator_tpu/train/state.py``).

Parameters are nested dicts of f32 tensors (leaves that require no grad:
a train step differentiates a detached copy). ``rng`` is the integer seed
the per-step noise generator is derived from; it never advances.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    clone_opt_state,
    make_optimizer,
    tree_leaves,
    tree_map,
    tree_unflatten,
)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    rng: int


def apply_update(state: TrainState, grads, tx) -> TrainState:
    """One optimizer application: tx.update -> params + updates ->
    step + 1, with no value read back from the device. ``state`` is left
    as it was: the update writes into a copy of its optimizer state."""
    updates, opt_state = tx.update(grads, clone_opt_state(state.opt_state),
                                   state.params)
    params = tree_unflatten(state.params, torch._foreach_add(
        tree_leaves(state.params), tree_leaves(updates)))
    return TrainState(params, opt_state, state.step + 1, state.rng)


def create_train_state(seed: int, model_cfg: ModelConfig,
                       train_cfg: TrainConfig, steps_per_epoch: int = 1,
                       device=None, params=None):
    """Init params (``gkn_init`` from ``seed``, or the given ``params``)
    and the optimizer on ``device`` (the card unless ``device="cpu"``).
    Returns (state, optimizer, schedule)."""
    dev = resolve_device(device)
    if params is None:
        params = gkn_init(model_cfg, seed=seed, device=dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev), params)
    tx, schedule = make_optimizer(
        lr=train_cfg.lr,
        weight_decay=train_cfg.weight_decay,
        scheduler_step=train_cfg.scheduler_step,
        scheduler_gamma=train_cfg.scheduler_gamma,
        steps_per_epoch=steps_per_epoch,
        grad_clip_norm=train_cfg.grad_clip_norm,
        skip_nonfinite_updates=train_cfg.skip_nonfinite_updates,
        grad_accum=train_cfg.grad_accum,
    )
    state = TrainState(params=params, opt_state=tx.init(params), step=0,
                       rng=seed)
    return state, tx, schedule
