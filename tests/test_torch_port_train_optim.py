"""The port's optimizer (train/optim.py) against the JAX package's optax
chain: the same seeded gradients go through both for five updates, so
bias correction, eps placement, the schedule's boundary, clipping, the
finiteness guard and gradient accumulation all show."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.train.optim import (
    make_optimizer as jax_make_optimizer,
    step_lr_schedule as jax_step_lr_schedule,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    make_optimizer,
    step_lr_schedule,
    tree_map,
)

# elementwise f32 arithmetic in the same order; pow and sqrt may differ in
# the last place between XLA and torch
RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"a": {"w": (6, 5), "b": (5,)}, "c": (3,)}


def _tree(rng, scale=1.0):
    def make(shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return {"a": {"w": make(SHAPES["a"]["w"]), "b": make(SHAPES["a"]["b"])},
            "c": make(SHAPES["c"])}


def _run_both(kw, grads_seq, params0):
    jtx, _ = jax_make_optimizer(**kw)
    tx, _ = make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, params0)
    jstate = jtx.init(jparams)
    params = tree_map(torch.as_tensor, params0)
    state = tx.init(params)
    for i, g in enumerate(grads_seq):
        jupd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate,
                                  jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        upd, state = tx.update(tree_map(torch.as_tensor, g), state, params)
        params = tree_map(lambda p, u: p + u, params, upd)
        for got, want in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(),
                                                      params)),
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got, np.asarray(want), RTOL, ATOL,
                                       err_msg=f"after update {i + 1}")
    return state


@pytest.mark.parametrize("kw", [
    dict(),
    dict(lr=0.05, weight_decay=0.0, scheduler_step=1, steps_per_epoch=2,
         scheduler_gamma=0.5),
    dict(grad_clip_norm=0.5),
    dict(grad_clip_norm=1e6),
], ids=["defaults", "schedule-boundary-at-2", "clip", "clip-inactive"])
def test_five_updates_match_optax(kw):
    rng = np.random.default_rng(0)
    state = _run_both(kw, [_tree(rng) for _ in range(5)], _tree(rng, 0.3))
    assert state.count == 5


def test_nonfinite_gradient_skips_the_apply_and_leaves_the_state_alone():
    rng = np.random.default_rng(1)
    grads = [_tree(rng) for _ in range(5)]
    grads[2]["a"]["w"][1, 1] = np.nan
    kw = dict(skip_nonfinite_updates=True, grad_clip_norm=1.0)
    state = _run_both(kw, grads, _tree(rng, 0.3))
    assert state.count == 4  # four applies out of five steps

    tx, _ = make_optimizer(**kw)
    params = tree_map(torch.as_tensor, _tree(rng))
    s0 = tx.init(params)
    upd, s1 = tx.update(tree_map(torch.as_tensor, grads[2]), s0, params)
    # moments, counts and accumulator stay; only the guard's counters move,
    # as optax.apply_if_finite's do
    assert (s1.count, s1.mini_step, s1.gradient_step) == (0, 0, 0)
    assert s1.mu is s0.mu and s1.nu is s0.nu and s1.acc is s0.acc
    assert (s1.notfinite_count, s1.last_finite, s1.total_notfinite) == \
        (1, False, 1)
    assert all(not u.any() for u in (upd["a"]["w"], upd["a"]["b"], upd["c"]))
    _, s2 = tx.update(tree_map(torch.as_tensor, grads[3]), s1, params)
    assert (s2.count, s2.notfinite_count, s2.last_finite,
            s2.total_notfinite) == (1, 0, True, 1)


@pytest.mark.parametrize("kw", [
    dict(grad_accum=2),
    dict(grad_accum=2, scheduler_step=1, steps_per_epoch=3,
         scheduler_gamma=0.5, lr=0.02),
    dict(grad_accum=2, skip_nonfinite_updates=True),
], ids=["accum-2", "accum-2-ceil-boundary", "accum-2-guarded"])
def test_grad_accum_matches_optax(kw):
    rng = np.random.default_rng(2)
    grads = [_tree(rng) for _ in range(5)]
    if kw.get("skip_nonfinite_updates"):
        grads[1]["c"][0] = np.inf
    state = _run_both(kw, grads, _tree(rng, 0.3))
    skipped = 1 if kw.get("skip_nonfinite_updates") else 0
    assert state.count == (5 - skipped) // 2
    assert state.mini_step == (5 - skipped) % 2


@pytest.mark.parametrize("args", [(0.01, 50, 0.8, 7), (0.1, 1, 0.5, 3),
                                  (0.01, 0, 0.8, 4)])
def test_step_lr_schedule_matches_optax(args):
    want, got = jax_step_lr_schedule(*args), step_lr_schedule(*args)
    # optax takes gamma^n in f32, the port in double: 1e-5 relative
    for count in (0, 1, 2, 3, 6, 349, 350, 351):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5)


# The optimizer keeps its counters on the device (0-d tensors) and decides
# the schedule, the bias corrections, the finiteness guard and the
# accumulation window there; these cases hold that form against optax at
# the training tolerances, f32.
DEVICE_RTOL, DEVICE_ATOL = 2e-4, 1e-5


def _run_device_form(kw, grads_seq, params0):
    """Both optimizers over ``grads_seq``; every parameter within the
    device form's tolerances after every update. Returns both states and
    both parameter trees."""
    jtx, _ = jax_make_optimizer(**kw)
    tx, _ = make_optimizer(**kw)
    jparams = jax.tree.map(jnp.asarray, params0)
    jstate = jtx.init(jparams)
    params = tree_map(torch.as_tensor, params0)
    state = tx.init(params)
    for i, g in enumerate(grads_seq):
        jupd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate,
                                  jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, jupd)
        upd, state = tx.update(tree_map(torch.as_tensor, g), state, params)
        params = tree_map(lambda p, u: p + u, params, upd)
        for got, want in zip(jax.tree.leaves(tree_map(lambda t: t.numpy(),
                                                      params)),
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got, np.asarray(want), DEVICE_RTOL,
                                       DEVICE_ATOL,
                                       err_msg=f"after update {i + 1}")
    return state, jstate, params, jparams


def test_device_counters_cross_step_lr_boundaries():
    """Nine applies over boundaries at 3 and 6: the learning rate halves
    twice, decided from the 0-d count on the device."""
    rng = np.random.default_rng(3)
    kw = dict(lr=0.05, scheduler_step=1, steps_per_epoch=3,
              scheduler_gamma=0.5, weight_decay=1e-3)
    state, _, _, _ = _run_device_form(kw, [_tree(rng) for _ in range(9)],
                                      _tree(rng, 0.3))
    assert state.count.dtype == torch.int32 and state.count.dim() == 0
    assert int(state.count) == 9
    _, schedule = make_optimizer(**kw)
    lrs = [float(schedule(torch.tensor(c, dtype=torch.int32)))
           for c in (2, 3, 5, 6, 8)]
    np.testing.assert_allclose(lrs, [0.05, 0.025, 0.025, 0.0125, 0.0125],
                               rtol=1e-6)


@pytest.mark.parametrize("bad", [[1], [3, 4, 5]],
                         ids=["inside-the-window", "three-in-a-row"])
def test_device_guard_inside_an_accumulation_window(bad):
    """A non-finite micro-batch inside a ``grad_accum=3`` window never
    enters it; three in a row leave the window, the moments and the apply
    count as they were and count three consecutive skips."""
    rng = np.random.default_rng(4)
    grads = [_tree(rng) for _ in range(9)]
    for i in bad:
        grads[i]["a"]["b"][2] = np.nan if i % 2 else np.inf
    kw = dict(grad_accum=3, skip_nonfinite_updates=True, grad_clip_norm=1.0)
    tx, _ = make_optimizer(**kw)
    params = tree_map(torch.as_tensor, _tree(rng, 0.3))
    state = tx.init(params)
    for i, g in enumerate(grads):
        before = (int(state.count), int(state.mini_step),
                  [t.clone() for t in (state.mu["c"], state.acc["c"])])
        upd, state = tx.update(tree_map(torch.as_tensor, g), state, params)
        params = tree_map(lambda p, u: p + u, params, upd)
        if i in bad:
            assert (int(state.count), int(state.mini_step)) == before[:2]
            assert torch.equal(state.mu["c"], before[2][0])
            assert torch.equal(state.acc["c"], before[2][1])
            assert not bool(state.last_finite)
    good = len(grads) - len(bad)
    assert int(state.total_notfinite) == len(bad)
    assert int(state.count) == good // 3
    assert int(state.mini_step) == good % 3
    if bad == [3, 4, 5]:
        # the guard's consecutive count went to 3 and restarted
        assert int(state.notfinite_count) == 0
    _run_device_form(kw, grads, _tree(np.random.default_rng(5), 0.3))


def test_device_counters_checkpoint_as_the_jax_package():
    """A TrainState whose counters are 0-d tensors is written key for key,
    dtype for dtype and value for value as the JAX package writes the same
    state, and each package reads the other's file back."""
    import tempfile
    from pathlib import Path

    from molecular_dynamics_neural_operator_tpu.train.state import (
        TrainState as JaxTrainState,
    )
    from molecular_dynamics_neural_operator_tpu.utils import (
        checkpoint as jcheckpoint,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils import (
        checkpoint,
    )

    rng = np.random.default_rng(6)
    grads = [_tree(rng) for _ in range(5)]
    grads[2]["c"][1] = np.nan
    kw = dict(grad_accum=2, skip_nonfinite_updates=True, grad_clip_norm=1.0)
    state, jstate, params, jparams = _run_device_form(
        kw, grads, _tree(rng, 0.3))
    port = TrainState(params, state, 5, 7)
    jax_state = JaxTrainState(jparams, jstate, jnp.int32(5),
                              jax.random.PRNGKey(7))
    with tempfile.TemporaryDirectory() as tmp:
        checkpoint.save_checkpoint(Path(tmp) / "port.npz", port)
        jcheckpoint.save_checkpoint(Path(tmp) / "jax.npz", jax_state)
        with np.load(Path(tmp) / "port.npz") as got, \
                np.load(Path(tmp) / "jax.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                assert got[key].dtype == want[key].dtype, key
                assert got[key].shape == want[key].shape, key
                if np.issubdtype(want[key].dtype, np.floating):
                    np.testing.assert_allclose(got[key], want[key],
                                               DEVICE_RTOL, DEVICE_ATOL,
                                               err_msg=key)
                else:
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)
        back, _ = jcheckpoint.restore_checkpoint(Path(tmp) / "port.npz",
                                                 jax_state)
        assert int(back.opt_state.notfinite_count) == 0
        assert int(back.opt_state.total_notfinite) == 1
        tx, _ = make_optimizer(**kw)
        template = TrainState(tree_map(torch.zeros_like, params),
                              tx.init(tree_map(torch.zeros_like, params)),
                              0, 0)
        again, _ = checkpoint.restore_checkpoint(Path(tmp) / "jax.npz",
                                                 template)
    for name in ("count", "mini_step", "gradient_step", "notfinite_count",
                 "last_finite", "total_notfinite"):
        got, want = getattr(again.opt_state, name), getattr(state, name)
        assert got.dim() == 0 and got.dtype == want.dtype, name
        assert torch.equal(got, want), name
    assert again.step == 5 and again.rng == 7
