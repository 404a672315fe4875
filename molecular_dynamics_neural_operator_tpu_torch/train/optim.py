"""Optimizer and LR schedule (``molecular_dynamics_neural_operator_tpu/train/optim.py``).

Adam with classic L2 weight decay (the decay is added to the gradient
before the moments, not decoupled) and a staircase StepLR expressed per
train step. The update is written out rather than taken from
``torch.optim.Adam``: the JAX package's chain (optax) puts eps outside the
square root of the bias-corrected second moment, multiplies by the
learning rate of the current apply count, and wraps the chain in a
gradient accumulator and a finiteness guard whose states this module keeps
in one ``OptState``.

Everything the update decides, it decides on the device, as a jitted optax
chain does: the counters are 0-d int32 tensors, the schedule and the bias
corrections are f32 tensors of the apply count, the finiteness guard is one
``isfinite`` reduction, and both the guard and the accumulator select with
``torch.where`` (``optax.apply_if_finite``, ``optax.MultiSteps``). No value
is read back to the host, so an update can be captured in a CUDA graph.
``update`` writes the moments, the accumulation window and the counters
into the state it is given, so that a skipped apply leaves the state's
moments the very tensors they were; ``train/state.py::apply_update``
updates a copy and keeps the caller's state intact.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
# optax.apply_if_finite gives up and applies after this many consecutive
# non-finite gradients; the JAX package sets it this high
MAX_CONSECUTIVE_ERRORS = 100_000


def step_lr_schedule(lr: float, step_size_epochs: int, gamma: float,
                     steps_per_epoch: int):
    """StepLR: lr * gamma^(step // (step_size_epochs * steps_per_epoch)),
    as optax's staircase ``exponential_decay``: the count (an int or an
    integer tensor) divided by the boundary in f32, floored, and the
    power in f32. Returns a 0-d f32 tensor on the count's device."""
    boundary = max(1, step_size_epochs * steps_per_epoch)

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count)
        p = torch.floor(count.to(torch.float32) / boundary)
        decayed = lr * torch.pow(gamma, p)
        return torch.where(count <= 0, torch.full_like(decayed, lr), decayed)

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
    wrappers. Every counter is a 0-d tensor on the parameters' device
    (int32, ``last_finite`` bool)."""

    count: Any
    mu: Any
    nu: Any
    mini_step: Any
    acc: Any
    gradient_step: Any
    notfinite_count: Any
    last_finite: Any
    total_notfinite: Any
    chain: Chain = Chain()


COUNTERS = ("count", "mini_step", "gradient_step", "notfinite_count",
            "last_finite", "total_notfinite")


def counter(value, device, dtype=torch.int32) -> torch.Tensor:
    """A 0-d counter tensor on ``device``, made without a host copy."""
    return torch.full((), value, dtype=dtype, device=device)


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


def opt_state_leaves(state: OptState) -> list:
    """Every tensor of ``state``: the counters, then mu, nu and acc."""
    out = [getattr(state, k) for k in COUNTERS]
    out += tree_leaves(state.mu) + tree_leaves(state.nu)
    if state.acc is not None:
        out += tree_leaves(state.acc)
    return out


def clone_opt_state(state):
    """A copy of an optimizer state (an ``OptState``, or any nesting of
    dicts, tuples and tensors) with tensors of its own."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, dict):
        return {k: clone_opt_state(v) for k, v in state.items()}
    if isinstance(state, Chain):
        return state
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(clone_opt_state(v) for v in state))
    if isinstance(state, (tuple, list)):
        return type(state)(clone_opt_state(v) for v in state)
    return state


def _select_(cond: torch.Tensor, new: list, old: list) -> None:
    """old[i] <- where(cond, new[i], old[i]), in place."""
    for n, o in zip(new, old):
        torch.where(cond, n, o, out=o)


class Optimizer:
    """``init(params) -> OptState``; ``update(grads, state, params) ->
    (updates, state)`` with ``new_params = params + updates``, as the JAX
    package's ``tx``. ``update`` writes the new moments, window and
    counters into ``state``'s own tensors and returns a state holding
    them; it reads nothing back from the device."""

    def __init__(self, schedule, weight_decay: float, grad_clip_norm: float,
                 skip_nonfinite_updates: bool, grad_accum: int):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip_norm = grad_clip_norm
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.grad_accum = max(1, int(grad_accum or 1))

    def init(self, params) -> OptState:
        dev = tree_leaves(params)[0].device
        acc = tree_map(torch.zeros_like, params) if self.grad_accum > 1 \
            else None
        return OptState(
            counter(0, dev), tree_map(torch.zeros_like, params),
            tree_map(torch.zeros_like, params), counter(0, dev), acc,
            counter(0, dev), counter(0, dev), counter(True, dev, torch.bool),
            counter(0, dev),
            chain=Chain(bool(self.grad_clip_norm and self.grad_clip_norm > 0),
                        bool(self.skip_nonfinite_updates), self.grad_accum))

    def _adam(self, g: list, state: OptState, params: list):
        """One apply of clip -> L2 decay -> Adam -> learning rate on the
        gradient leaves ``g``, each operation one ``torch._foreach`` call
        over all leaves. Returns (updates, mu, nu) as new leaf lists."""
        if self.grad_clip_norm and self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
            # g * clip / norm where the norm exceeds the clip, else g
            g = torch._foreach_mul(g, torch.where(
                norm < self.grad_clip_norm, torch.ones_like(norm),
                self.grad_clip_norm / norm))
        g = torch._foreach_add(g, params, alpha=self.weight_decay)
        mu = torch._foreach_mul(tree_leaves(state.mu), B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        nu = torch._foreach_mul(tree_leaves(state.nu), B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - B2)
        # the bias corrections in f32 of the incremented count, as the JAX
        # package's chain takes them: 1 - 0.999^count loses five digits to
        # the rounding of 0.999
        count = (state.count + 1).to(torch.float32)
        c1 = 1 - torch.pow(B1, count)
        c2 = 1 - torch.pow(B2, count)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        updates = torch._foreach_div(mu, c1)
        torch._foreach_div_(updates, denom)
        # the learning rate of the apply count before this apply
        torch._foreach_mul_(updates, -self.schedule(state.count))
        return updates, mu, nu

    def _inner(self, g: list, state: OptState, params: list, apply):
        """The accumulator around Adam (``optax.MultiSteps``), written into
        ``state`` where the 0-d bool ``apply`` holds (None: always).
        Returns the update leaves."""
        mu_old, nu_old = tree_leaves(state.mu), tree_leaves(state.nu)
        if self.grad_accum == 1:
            updates, mu, nu = self._adam(g, state, params)
            if apply is None:
                for n, o in ((mu, mu_old), (nu, nu_old)):
                    torch._foreach_copy_(o, n)
                state.count.add_(1)
                return updates
            _select_(apply, mu + nu, mu_old + nu_old)
            state.count.add_(apply.to(torch.int32))
            return updates
        k = state.mini_step
        acc_old = tree_leaves(state.acc)
        # acc + (g - acc) / (k + 1), the running mean of the window
        acc = torch._foreach_sub(g, acc_old)
        torch._foreach_div_(acc, (k + 1).to(torch.float32))
        torch._foreach_add_(acc, acc_old)
        updates, mu, nu = self._adam(acc, state, params)
        emit = k == self.grad_accum - 1
        take = emit if apply is None else emit & apply
        _select_(take, mu + nu, mu_old + nu_old)
        state.count.add_(take.to(torch.int32))
        keep = torch.ones((), dtype=torch.bool, device=k.device) \
            if apply is None else apply
        # the window restarts after an apply: (1 - emit) * acc
        acc = torch._foreach_mul(acc, (~emit).to(torch.float32))
        _select_(keep, acc, acc_old)
        state.gradient_step.add_(take.to(torch.int32))
        torch.where(keep, (k + 1) % self.grad_accum, k, out=k)
        return torch._foreach_mul(updates, emit.to(torch.float32))

    def update(self, grads, state: OptState, params):
        g, p = tree_leaves(grads), tree_leaves(params)
        if not self.skip_nonfinite_updates:
            updates = self._inner(g, state, p, None)
            return tree_unflatten(params, updates), state
        finite = torch.stack([torch.isfinite(x).all() for x in g]).all()
        bad = state.notfinite_count + 1
        torch.where(finite, torch.zeros_like(bad), bad,
                    out=state.notfinite_count)
        # a skipped apply leaves moments, counts and the accumulation
        # window as they were
        apply = finite | (state.notfinite_count > MAX_CONSECUTIVE_ERRORS)
        updates = self._inner(g, state, p, apply)
        updates = [torch.where(apply, u, torch.zeros_like(u))
                   for u in updates]
        state.last_finite.copy_(finite)
        state.total_notfinite.add_((~finite).to(torch.int32))
        return tree_unflatten(params, updates), state


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
