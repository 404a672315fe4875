"""Optimizer and LR schedule (``molecular_dynamics_neural_operator_tpu/train/optim.py``).

Adam with classic L2 weight decay (the decay is added to the gradient
before the moments, not decoupled) and a staircase StepLR expressed per
train step. The update is written out rather than taken from
``torch.optim.Adam``: the JAX package's chain (optax) puts eps outside the
square root of the bias-corrected second moment, multiplies by the
learning rate of the current apply count, and wraps the chain in a
gradient accumulator and a finiteness guard whose states this module keeps
in one ``OptState``, so a train step is a pure function of (state, grads).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def step_lr_schedule(lr: float, step_size_epochs: int, gamma: float,
                     steps_per_epoch: int):
    """StepLR: lr * gamma^(step // (step_size_epochs * steps_per_epoch))."""
    boundary = max(1, step_size_epochs * steps_per_epoch)

    def schedule(count: int) -> float:
        return lr * gamma ** (int(count) // boundary)

    return schedule


class Chain(NamedTuple):
    """Which wrappers the optimizer has: the layout of the JAX package's
    optax state for the same chain (``utils/checkpoint.py``)."""

    clip: bool = False
    skip_nonfinite: bool = False
    accum: int = 1


class OptState(NamedTuple):
    """count: optimizer applies so far (the schedule's and the bias
    correction's step); mu, nu: Adam moments, trees like the parameters;
    mini_step and acc: micro-batches gathered so far and their running
    mean (``grad_accum`` > 1 only, else 0 and None); gradient_step: applies
    made by the accumulator; notfinite_count, last_finite and
    total_notfinite: the finiteness guard's consecutive and total skips
    and whether the last gradient was finite; chain: the optimizer's
    wrappers."""

    count: int
    mu: Any
    nu: Any
    mini_step: int
    acc: Any
    gradient_step: int = 0
    notfinite_count: int = 0
    last_finite: bool = True
    total_notfinite: int = 0
    chain: Chain = Chain()


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order) in the nesting of ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


class Optimizer:
    """``init(params) -> OptState``; ``update(grads, state, params) ->
    (updates, new_state)`` with ``new_params = params + updates``, as the
    JAX package's ``tx``. Nothing is modified in place."""

    def __init__(self, schedule, weight_decay: float, grad_clip_norm: float,
                 skip_nonfinite_updates: bool, grad_accum: int):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.grad_accum = max(1, int(grad_accum or 1))

    def init(self, params) -> OptState:
        zeros = tree_map(torch.zeros_like, params)
        acc = tree_map(torch.zeros_like, params) if self.grad_accum > 1 \
            else None
        return OptState(0, zeros, tree_map(torch.zeros_like, params), 0, acc,
                        chain=Chain(bool(self.grad_clip_norm
                                         and self.grad_clip_norm > 0),
                                    bool(self.skip_nonfinite_updates),
                                    self.grad_accum))

    def _adam(self, grads, state: OptState, params):
        """One apply of clip -> L2 decay -> Adam -> learning rate, each
        operation as one ``torch._foreach`` call over all leaves."""
        g, p = tree_leaves(grads), tree_leaves(params)
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
            # g * clip / norm where the norm exceeds the clip, else g
            g = torch._foreach_mul(g, torch.where(
                norm < self.grad_clip_norm, torch.ones_like(norm),
                self.grad_clip_norm / norm))
        g = torch._foreach_add(g, p, alpha=self.weight_decay)
        count = state.count + 1
        mu = torch._foreach_mul(tree_leaves(state.mu), B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        nu = torch._foreach_mul(tree_leaves(state.nu), B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - B2)
        # the bias corrections in f32, as the JAX package's chain takes
        # them: 1 - 0.999^count loses five digits to the rounding of 0.999
        c1 = float(1 - np.float32(B1) ** np.float32(count))
        c2 = float(1 - np.float32(B2) ** np.float32(count))
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu, c1)
        torch._foreach_div_(updates, denom)
        # the learning rate of the apply count before this apply
        torch._foreach_mul_(updates, -self.schedule(state.count))
        return (tree_unflatten(params, updates), state._replace(
            count=count, mu=tree_unflatten(params, mu),
            nu=tree_unflatten(params, nu)))

    def _accumulated(self, grads, state: OptState, params):
        """Average ``grad_accum`` micro-batch gradients, then apply."""
        if self.grad_accum == 1:
            return self._adam(grads, state, params)
        k = state.mini_step
        acc = tree_map(lambda a, g: a + (g - a) / (k + 1), state.acc, grads)
        if k + 1 < self.grad_accum:
            return (tree_map(torch.zeros_like, params),
                    state._replace(mini_step=k + 1, acc=acc))
        updates, new = self._adam(acc, state, params)
        return updates, new._replace(
            mini_step=0, acc=tree_map(torch.zeros_like, acc),
            gradient_step=state.gradient_step + 1)

    def update(self, grads, state: OptState, params):
        if self.skip_nonfinite_updates:
            finite = all(bool(torch.isfinite(g).all())
                         for g in tree_leaves(grads))
            if not finite:
                # the apply is skipped: moments, counts and the
                # accumulation window stay as they were
                return tree_map(torch.zeros_like, params), state._replace(
                    notfinite_count=state.notfinite_count + 1,
                    last_finite=False,
                    total_notfinite=state.total_notfinite + 1)
            state = state._replace(notfinite_count=0, last_finite=True)
        return self._accumulated(grads, state, params)


def make_optimizer(
    lr: float = 0.01,
    weight_decay: float = 5e-4,
    scheduler_step: int = 50,
    scheduler_gamma: float = 0.8,
    steps_per_epoch: int = 1,
    grad_clip_norm: float = 0.0,
    skip_nonfinite_updates: bool = False,
    grad_accum: int = 1,
):
    """Returns (optimizer, schedule). ``grad_clip_norm > 0`` clips the
    global gradient norm first. ``skip_nonfinite_updates`` skips the whole
    step on a non-finite gradient, outermost, so a bad micro-batch never
    enters the accumulation window. ``grad_accum > 1`` averages that many
    micro-batch gradients per apply; ``steps_per_epoch`` stays in
    micro-steps and the schedule's boundary is rescaled by ceil division,
    because the apply count only advances on real applies."""
    schedule = step_lr_schedule(
        lr, scheduler_step, scheduler_gamma,
        -(-steps_per_epoch // max(1, grad_accum)))
    return Optimizer(schedule, weight_decay, grad_clip_norm,
                     skip_nonfinite_updates, grad_accum), schedule
