"""The training slice of the port as a whole against the JAX package on
the CPU: train steps, the eval step with a padded remainder, the epoch
loops, the input noise and the checkpoint format."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
    TrainConfig as JaxTrainConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.train import (
    create_train_state as jax_create_train_state,
)
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jcheckpoint,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    batch_iterator,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    prefetch_to_device,
    to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    create_train_state,
    eval_epoch,
    make_eval_step,
    make_train_step,
    noise,
    train_epoch,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    load_params_npz,
    params_from_jax,
    save_checkpoint,
)

BASE = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
            max_edges=128, graph_mode="sparse", compute_dtype="float32",
            predict_delta=True)
TRAIN = dict(lr=1e-3, batch_size=5)
# f32, three Adam steps: the gradients agree to 2e-4 relative (see
# test_torch_port_train_model.py) and Adam's normalised update carries that
# into the parameters
RTOL, ATOL = 2e-4, 1e-5


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _both(impl):
    opts = {**BASE, "train_conv_impl": impl}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jds = JaxWindowDataset(
        jax_synthetic_trajectory(num_frames=24, num_residues=12, seed=4),
        window_size=4, graph_mode="sparse", max_edges=128, use_native=False)
    ds = WindowDataset(
        synthetic_trajectory(num_frames=24, num_residues=12, seed=4),
        window_size=4, graph_mode="sparse", max_edges=128)
    jstate, jtx, _ = jax_create_train_state(jax.random.PRNGKey(0), jcfg,
                                            JaxTrainConfig(**TRAIN))
    state, tx, _ = create_train_state(
        0, cfg, TrainConfig(**TRAIN), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               "cpu"))
    return jcfg, cfg, jds, ds, jstate, jtx, state, tx


def _assert_params_close(params, jparams):
    want = dict(_flat(jax.tree.map(np.asarray, jparams)))
    for name, p in _flat(params):
        np.testing.assert_allclose(p.numpy(), want[name], RTOL, ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_three_train_steps_match_jax(impl):
    jcfg, cfg, jds, ds, jstate, jtx, state, tx = _both(impl)
    jstep = jloop.make_train_step(jcfg, jtx, donate=False)
    step = make_train_step(cfg, tx)
    for i in range(3):
        idx = np.arange(5) + 5 * i
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    jds.get_batch(idx).items()})
        state, m = step(state, to_device(ds.get_batch(idx), "cpu"))
        for k in ("rel_l2", "mse"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"{k} at step {i}")
        _assert_params_close(state.params, jstate.params)
    assert state.step == int(jstate.step) == 3
    assert state.opt_state.count == 3


def test_train_step_leaves_its_input_state_untouched():
    _, cfg, _, ds, _, _, state, tx = _both("pallas")
    before = {n: p.clone() for n, p in _flat(state.params)}
    new, _ = make_train_step(cfg, tx)(
        state, to_device(ds.get_batch(np.arange(5)), "cpu"))
    for n, p in _flat(state.params):
        assert torch.equal(p, before[n]) and not p.requires_grad
    assert any(not torch.equal(p, before[n]) for n, p in _flat(new.params))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_eval_step_with_a_padded_remainder_matches_jax(impl):
    jcfg, cfg, jds, ds, jstate, _, state, _ = _both(impl)
    batches = list(batch_iterator(ds, np.arange(7), 5, shuffle=False,
                                  drop_last=False, pad_last=True))
    assert batches[-1]["w"].tolist() == [1, 1, 0, 0, 0]
    jstep, step = jloop.make_eval_step(jcfg), make_eval_step(cfg)
    for b in batches:
        want = jstep(jstate.params, {k: jnp.asarray(v) for k, v in b.items()})
        got = step(state.params, to_device(b, "cpu"))
        assert set(got) == {"rel_l2", "mse", "n"}
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=k)
    # without weights every row counts
    full = dict(batches[0])
    del full["w"]
    assert float(step(state.params, to_device(full, "cpu"))["n"]) == 5


def test_train_epoch_and_eval_epoch_totals_match_jax():
    jcfg, cfg, jds, ds, jstate, jtx, state, tx = _both("pallas")
    train_idx, valid_idx = np.arange(13), np.arange(13, 20)
    jstate, jm = jloop.train_epoch(
        jstate, jloop.make_train_step(jcfg, jtx, donate=False), jds,
        train_idx, 5, seed=3, epoch=1)
    state, m = train_epoch(state, make_train_step(cfg, tx), ds, train_idx, 5,
                           seed=3, epoch=1)
    assert state.step == 2  # 13 // 5, the remainder is dropped
    for k in ("rel_l2", "mse"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-4, err_msg=k)
    assert m["steps_per_sec"] > 0 and m["examples_per_sec"] > 0
    _assert_params_close(state.params, jstate.params)

    want = jloop.eval_epoch(jstate.params, jloop.make_eval_step(jcfg), jds,
                            valid_idx, 5)
    got = eval_epoch(state.params, make_eval_step(cfg), ds, valid_idx, 5)
    for k in ("rel_l2", "mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_empty_epochs():
    _, cfg, _, ds, _, _, state, tx = _both("xla")
    same, m = train_epoch(state, make_train_step(cfg, tx), ds, np.arange(3),
                          5)
    assert same is state and m["rel_l2"] == 0.0 and m["steps_per_sec"] == 0.0
    ev = eval_epoch(state.params, make_eval_step(cfg), ds,
                    np.zeros(0, np.int64), 5)
    assert math.isnan(ev["rel_l2"]) and math.isnan(ev["mse"])


def test_prefetch_keeps_order_and_every_batch():
    batches = [{"i": np.array([i])} for i in range(7)]
    for size in (0, 1, 3, 10):
        got = [int(b["i"]) for b in prefetch_to_device(iter(batches), size,
                                                       device="cpu")]
        assert got == list(range(7))
    assert isinstance(to_device(batches[0], "cpu")["i"], torch.Tensor)


def test_noise_structure_and_reproducibility():
    shape, std = (512, 8, 12, 3), 0.5
    gen = noise.step_generator(3, 7, "cpu")
    walk = noise.window_random_walk_noise(gen, shape, std)
    assert walk.shape == shape and walk.dtype == torch.float32
    # a cumulative sum over the frame axis of i.i.d. increments of std
    # std / sqrt(T): 18k samples per frame, so 3 % holds the std estimates
    inc = torch.diff(walk, dim=-3, prepend=torch.zeros(512, 1, 12, 3))
    assert abs(inc.std().item() - std / math.sqrt(8)) < 0.03 * std
    assert abs(walk[:, -1].std().item() - std) < 0.03 * std
    assert abs(walk[:, 0].std().item() - std / math.sqrt(8)) < 0.03 * std
    frames = inc.movedim(-3, 0).reshape(8, -1)
    corr = torch.corrcoef(frames)
    # sample correlations of independent frames: std 1/sqrt(18k) = 0.007
    assert (corr - torch.eye(8)).abs().max() < 0.04

    window = torch.randn(4, 8, 12, 3)
    a = noise.noised_window(window, 3, 7, std)
    assert torch.equal(a, noise.noised_window(window, 3, 7, std))
    assert not torch.equal(a, noise.noised_window(window, 3, 8, std))
    assert not torch.equal(a, noise.noised_window(window, 4, 7, std))
    assert noise.noised_window(window, 3, 7, 0.0) is window
    single = noise.noised_window(window[0], 3, 7, std)
    assert single.shape == (8, 12, 3)


def test_noisy_train_step_is_a_pure_function_of_seed_and_step():
    _, cfg, _, ds, _, _, state, tx = _both("xla")
    batch = to_device(ds.get_batch(np.arange(5)), "cpu")
    step = make_train_step(cfg, tx, noise_std=0.1)
    a, ma = step(state, batch)
    b, mb = step(state, batch)
    clean, mc = make_train_step(cfg, tx)(state, batch)
    assert float(ma["rel_l2"]) == float(mb["rel_l2"])
    assert float(ma["rel_l2"]) != float(mc["rel_l2"])
    for (_, p), (_, q) in zip(_flat(a.params), _flat(b.params)):
        assert torch.equal(p, q)


def test_checkpoints_cross_between_the_packages_both_ways(tmp_path):
    jcfg = JaxModelConfig(**BASE)
    jparams = jgkn.gkn_init(jax.random.PRNGKey(3), jcfg)
    # the port writes, the JAX package restores
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    save_checkpoint(tmp_path / "port.npz", params, {"epoch": 4})
    like = jgkn.gkn_init(jax.random.PRNGKey(9), jcfg)
    restored, meta = jcheckpoint.restore_checkpoint(tmp_path / "port.npz",
                                                    like)
    assert meta == {"epoch": 4}
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sub, _ = jcheckpoint.restore_subtree(tmp_path / "port.npz", like,
                                         ".params")
    assert jax.tree.structure(sub) == jax.tree.structure(jparams)
    # the JAX package writes, the port loads
    jcheckpoint.save_checkpoint(tmp_path / "jax.npz", jparams)
    loaded = load_params_npz(tmp_path / "jax.npz", device="cpu")
    want = dict(_flat(params))
    got = dict(_flat(loaded))
    assert set(got) == set(want) and len(got) == 21
    for name in got:
        assert torch.equal(got[name], want[name]), name


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(0, ModelConfig(**BASE), TrainConfig())
    state, _, schedule = create_train_state(0, ModelConfig(**BASE),
                                            TrainConfig(), steps_per_epoch=3,
                                            device="cpu")
    assert state.step == 0 and state.params["fc1"]["w"].device.type == "cpu"
    assert schedule(149) == 0.01 and schedule(150) == pytest.approx(0.008)
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JaxTrainConfig())
