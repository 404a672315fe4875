"""The port's FNO (``models/fno.py``) and ``cli.train --operator fno``
against the JAX package on the CPU in f32, from the JAX package's
weights (``params_from_jax``).

Tolerances, as in the other port tests: forward outputs rtol 1e-5 of the
output's scale; losses and a parameter after an Adam update, and every
gradient leaf, rtol 2e-4 with atol 1e-5 (a gradient leaf's atol scaled by
its largest element above 1): the two packages take their f32 sums and
FFTs in other orders."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import configs as jconfigs
from molecular_dynamics_neural_operator_tpu.cli import train as jtrain
from molecular_dynamics_neural_operator_tpu.models import fno as jfno
from molecular_dynamics_neural_operator_tpu.train import optim as joptim
from molecular_dynamics_neural_operator_tpu.train.state import (
    TrainState as JaxTrainState,
)
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jcheckpoint,
)
from molecular_dynamics_neural_operator_tpu_torch import configs
from molecular_dynamics_neural_operator_tpu_torch.cli import train as ptrain
from molecular_dynamics_neural_operator_tpu_torch.data import (
    write_synthetic_h5,
)
from molecular_dynamics_neural_operator_tpu_torch.models import fno
from molecular_dynamics_neural_operator_tpu_torch.train import optim
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import checkpoint

FWD_TOL = 1e-5
RTOL, ATOL = 2e-4, 1e-5
BASE = dict(width=8, modes1=6, modes2=6, depth=2, in_channels=4,
            num_residues=20)
B = 3


def _cfgs(**kw):
    opts = {**BASE, **kw}
    return jconfigs.FNOConfig(**opts), configs.FNOConfig(**opts)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jfno.fno_init(jax.random.PRNGKey(seed), jcfg))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _assert_tree_close(got, want):
    want = dict(_flat(jax.tree.map(np.asarray, want)))
    got = dict(_flat(got))
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(g.detach().numpy(), want[name], RTOL,
                                   ATOL * scale, err_msg=name)


def _assert_fwd(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= FWD_TOL * max(1.0, np.abs(want).max()), err


def _channels(r=20, c=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 20.0, size=(B, r, r, c)).astype(np.float32)


def _coords(r=20, t=4, k=0, seed=0):
    """A window batch: B windows of t frames of a slowly moving chain and
    their targets (``y``, and ``y_seq`` of k frames)."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(B, 1, r, 3)) * 2.0, axis=2)
    frames = base + 0.05 * rng.normal(size=(B, t + max(k, 1), r, 3)).cumsum(1)
    frames = frames.astype(np.float32)
    batch = {"window": frames[:, :t], "y": frames[:, t]}
    if k:
        batch["y_seq"] = frames[:, t:t + k]
    return batch


# ---- parameters -------------------------------------------------------------

def test_params_from_jax_takes_an_fno_tree():
    jcfg, _ = _cfgs()
    jparams = _params(jcfg)
    params = checkpoint.params_from_jax(jparams, "cpu")
    want = dict(_flat(jparams))
    got = dict(_flat(params))
    assert set(got) == set(want)
    assert {"spectral_0/w_real", "spectral_0/w_imag",
            "pointwise_1/w"} <= set(got)
    for name, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


@pytest.mark.parametrize("head_init", ["default", "zero"])
def test_fno_init_matches_jax_structure(head_init):
    jcfg, cfg = _cfgs(head_init=head_init)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jfno.fno_init(jax.random.PRNGKey(0), jcfg))
    params = fno.fno_init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params) == want
    assert bool(params["proj2"]["w"].any()) == (head_init == "default")


@pytest.mark.parametrize("opts,match", [
    (dict(modes1=21), "retained modes"),
    (dict(modes2=12), "retained modes"),
    (dict(predict_delta=True, predict_prior="extrapolate", in_channels=1),
     "in_channels >= 2"),
    (dict(head_init="bogus"), "unknown head_init"),
])
def test_fno_init_guards_match_jax(opts, match):
    jcfg, cfg = _cfgs(**opts)
    with pytest.raises(ValueError, match=match):
        jfno.fno_init(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match=match):
        fno.fno_init(cfg, device="cpu")


# ---- the forward ------------------------------------------------------------

FORWARD = {
    "auto": dict(),
    "dft": dict(spectral_impl="dft"),
    "fft": dict(spectral_impl="fft"),
    # 2 * modes1 > R: the row blocks overlap, the second write wins
    "fft_overlap": dict(spectral_impl="fft", modes1=12, modes2=11),
    "odd_grid_fft": dict(spectral_impl="fft", num_residues=21),
    "delta_last": dict(predict_delta=True, head_scale=0.1),
    "delta_extrapolate": dict(predict_delta=True,
                              predict_prior="extrapolate",
                              prior_damping=0.5),
    "head_zero": dict(predict_delta=True, head_init="zero"),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_fno_apply_matches_jax(case):
    jcfg, cfg = _cfgs(**FORWARD[case])
    jparams = _params(jcfg)
    x = _channels(r=cfg.num_residues)
    want, jlat = jfno.fno_apply(jparams, jcfg, jnp.asarray(x),
                                return_latent=True)
    got, lat = fno.fno_apply(checkpoint.params_from_jax(jparams, "cpu"), cfg,
                             torch.as_tensor(x), return_latent=True)
    assert got.shape == want.shape == (B, cfg.num_residues,
                                       cfg.num_residues, 1)
    _assert_fwd(got, want)
    _assert_fwd(lat, jlat)
    if case == "head_zero":
        np.testing.assert_array_equal(got.numpy(), x[..., -1:])


@pytest.mark.parametrize("r", [20, 21])
@pytest.mark.parametrize("impl", ["fft", "dft"])
def test_spectral_conv_matches_jax_and_both_forms_agree(impl, r):
    jcfg, _ = _cfgs(num_residues=r)
    sp = _params(jcfg)["spectral_0"]
    x = np.random.default_rng(1).normal(size=(B, r, r, 8)).astype(np.float32)
    want = jfno._spectral_conv(sp, jnp.asarray(x), 6, 6, impl=impl)
    tsp = checkpoint.params_from_jax(sp, "cpu")
    got = fno._spectral_conv(tsp, torch.as_tensor(x), 6, 6, impl=impl)
    _assert_fwd(got, want)
    other = fno._spectral_conv(tsp, torch.as_tensor(x), 6, 6,
                               impl="dft" if impl == "fft" else "fft")
    _assert_fwd(other, want)


def test_overlapping_modes_are_refused_by_dft_as_in_jax():
    jcfg, cfg = _cfgs(spectral_impl="dft", modes1=12, modes2=11)
    jparams = _params(jcfg)
    x = _channels()
    with pytest.raises(ValueError, match="spectral_impl='dft' requires"):
        jfno.fno_apply(jparams, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="spectral_impl='dft' requires"):
        fno.fno_apply(checkpoint.params_from_jax(jparams, "cpu"), cfg,
                      torch.as_tensor(x))
    with pytest.raises(ValueError, match="unknown spectral impl"):
        fno._spectral_conv(checkpoint.params_from_jax(
            jparams["spectral_0"], "cpu"), torch.as_tensor(x[..., :1]).expand(
                B, 20, 20, 8), 6, 6, impl="fast")


def test_distance_channels_and_sym_zero_diag_match_jax():
    batch = _coords()
    want = jax.vmap(jfno.distance_matrix_channels)(
        jnp.asarray(batch["window"]))
    got = fno.distance_matrix_channels(torch.as_tensor(batch["window"]))
    _assert_fwd(got, want)
    p = _channels()[..., 0]
    np.testing.assert_allclose(fno.sym_zero_diag(torch.as_tensor(p)).numpy(),
                               np.asarray(jfno.sym_zero_diag(jnp.asarray(p))),
                               rtol=0, atol=0)


def test_rollout_matches_jax_for_16_steps():
    jcfg, cfg = _cfgs(predict_delta=True, head_scale=0.05)
    jparams = _params(jcfg, 2)
    ch0 = _channels(seed=3)[0]
    want, jfinal = jfno.fno_rollout_scan(jparams, jcfg, jnp.asarray(ch0), 16)
    got, final = fno.fno_rollout_scan(
        checkpoint.params_from_jax(jparams, "cpu"), cfg,
        torch.as_tensor(ch0), 16)
    assert got.shape == (16, 20, 20)
    _assert_fwd(got, want)
    _assert_fwd(final, jfinal)
    assert torch.equal(got, got.transpose(-1, -2))
    assert not got.diagonal(dim1=-2, dim2=-1).any()


# ---- the steps --------------------------------------------------------------

def _optimizers(**kw):
    opts = dict(lr=1e-3, weight_decay=5e-4, scheduler_step=50,
                scheduler_gamma=0.8, steps_per_epoch=1, **kw)
    return joptim.make_optimizer(**opts)[0], optim.make_optimizer(**opts)[0]


def _states(jcfg, seed=0, **kw):
    jtx, tx = _optimizers(**kw)
    jparams = jfno.fno_init(jax.random.PRNGKey(seed), jcfg)
    jstate = JaxTrainState(jparams, jtx.init(jparams),
                           jnp.zeros((), jnp.int32),
                           jax.random.PRNGKey(seed))
    params = checkpoint.params_from_jax(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    return jstate, jtx, TrainState(params, tx.init(params), 0, seed), tx


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


STEPS = ["window", "fno_batch", "curriculum_k3"]


@pytest.mark.parametrize("kind", STEPS)
def test_train_steps_match_jax_after_one_adam_update(kind):
    jcfg, cfg = _cfgs(predict_delta=True, head_scale=0.1)
    jstate, jtx, state, tx = _states(jcfg)
    if kind == "window":
        jstep = jfno.make_fno_window_train_step(jcfg, jtx)
        step = fno.make_fno_window_train_step(cfg, tx)
        batch = _coords()
        jb, tb = _jnp(batch), _torch(batch)
    elif kind == "fno_batch":
        jstep = jfno.make_fno_train_step(jcfg, jtx)
        step = fno.make_fno_train_step(cfg, tx)
        x, y = _channels(seed=5), _channels(seed=6)[..., :1]
        jb = jfno.FNOBatch(jnp.asarray(x), jnp.asarray(y))
        tb = fno.FNOBatch(torch.as_tensor(x), torch.as_tensor(y))
    else:
        jstep = jfno.make_fno_curriculum_train_step(jcfg, jtx, 3)
        step = fno.make_fno_curriculum_train_step(cfg, tx, 3)
        batch = _coords(k=3)
        jb, tb = _jnp(batch), _torch(batch)
    jstate, jm = jstep(jstate, jb)
    state, m = step(state, tb)
    for k in ("rel_l2", "mse"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL,
                                   err_msg=k)
    _assert_tree_close(state.params, jstate.params)
    assert state.step == int(jstate.step) == 1


class _GradRecorder:
    """An optimizer that leaves the parameters as they are and keeps the
    gradients as its state: after a step, ``state.opt_state`` holds them,
    in either package (both ``apply_update``s call ``tx.update(grads,
    opt_state, params)`` and add the updates)."""

    def __init__(self, zeros):
        self.zeros = zeros

    def update(self, grads, opt_state, params=None):
        return self.zeros(grads), grads


def _jax_grads_tx():
    return _GradRecorder(lambda g: jax.tree.map(jnp.zeros_like, g))


def _port_grads_tx():
    return _GradRecorder(lambda g: optim.tree_map(torch.zeros_like, g))


@pytest.mark.parametrize("k", [1, 3])
def test_curriculum_gradients_match_jax(k):
    """The curriculum's loss and every gradient from the same parameters;
    K = 1 gives the teacher-forced step's loss and gradients."""
    jcfg, cfg = _cfgs(predict_delta=True, head_scale=0.1)
    jparams = _params(jcfg, 4)
    params = checkpoint.params_from_jax(jparams, "cpu")
    batch = _coords(k=k, seed=7)
    jstate = JaxTrainState(jparams, None, jnp.zeros((), jnp.int32),
                           jax.random.PRNGKey(0))
    jstate, jm = jfno.make_fno_curriculum_train_step(
        jcfg, _jax_grads_tx(), k)(jstate, _jnp(batch))
    state, m = fno.make_fno_curriculum_train_step(cfg, _port_grads_tx(), k)(
        TrainState(params, None, 0, 0), _torch(batch))
    for key in ("rel_l2", "mse"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL,
                                   err_msg=key)
    _assert_tree_close(state.opt_state, jstate.opt_state)
    _assert_tree_close(state.params, jparams)  # left as they were
    if k == 1:
        one = dict(batch, y=batch["y_seq"][:, 0])
        teacher, tm = fno.make_fno_window_train_step(cfg, _port_grads_tx())(
            TrainState(params, None, 0, 0), _torch(one))
        for key in ("rel_l2", "mse"):
            np.testing.assert_allclose(float(m[key]), float(tm[key]),
                                       rtol=1e-6, err_msg=key)
        for (name, g), (_, t) in zip(_flat(state.opt_state),
                                     _flat(teacher.opt_state)):
            np.testing.assert_allclose(g.numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=name)


def test_curriculum_refuses_a_batch_of_another_k():
    _, cfg = _cfgs()
    _, tx = _optimizers()
    step = fno.make_fno_curriculum_train_step(cfg, tx, 2)
    state = TrainState(fno.fno_init(cfg, device="cpu"), None, 0, 0)
    with pytest.raises(ValueError, match="rollout_steps=2"):
        step(state, _torch(_coords(k=3)))


def test_eval_step_matches_jax():
    jcfg, cfg = _cfgs(predict_delta=True)
    jparams = _params(jcfg, 6)
    batch = _coords(seed=8)
    want = jfno.make_fno_window_eval_step(jcfg)(jparams, _jnp(batch))
    got = fno.make_fno_window_eval_step(cfg)(
        checkpoint.params_from_jax(jparams, "cpu"), _torch(batch))
    for k in ("rel_l2", "mse"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


# ---- checkpoints ------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fno_train_state_checkpoints_cross_packages(direction, tmp_path):
    """A TrainState after one Adam update, with clipping and the
    finiteness guard in its chain, read by the other package."""
    jcfg, cfg = _cfgs()
    chain = dict(grad_clip_norm=1.0, skip_nonfinite_updates=True)
    jstate, jtx, state, tx = _states(jcfg, 1, **chain)
    batch = _coords(seed=9)
    jstate, _ = jfno.make_fno_window_train_step(jcfg, jtx)(jstate,
                                                           _jnp(batch))
    state, _ = fno.make_fno_window_train_step(cfg, tx)(state, _torch(batch))
    path = tmp_path / "fno.npz"
    if direction == "jax_to_port":
        jcheckpoint.save_checkpoint(path, jstate, {"epoch": 0})
        got, meta = checkpoint.restore_checkpoint(path, state)
        want = jstate
    else:
        checkpoint.save_checkpoint(path, state, {"epoch": 0})
        want, meta = jcheckpoint.restore_checkpoint(path, jstate)
        got = state
    assert meta == {"epoch": 0}
    flat = jcheckpoint._flatten_with_paths(want)
    port = checkpoint._train_state_flat(got)
    assert set(port) == set(flat)
    assert ".params/spectral_1/w_imag" in port
    for key, w in flat.items():
        if key != ".rng":
            np.testing.assert_allclose(port[key], w, RTOL, ATOL, err_msg=key)
    params, _ = checkpoint.restore_subtree(
        path, fno.fno_init(cfg, device="cpu"), ".params", device="cpu")
    for name, p in _flat(params):
        np.testing.assert_array_equal(p.numpy(), port[f".params/{name}"],
                                      err_msg=name)


# ---- cli.train --operator fno -----------------------------------------------

CLI_ARGS = ["--operator", "fno", "--epochs", "2", "--batch_size", "16",
            "--lr", "1e-3", "--window_size", "4", "--fno_width", "8",
            "--fno_modes", "6", "--fno_depth", "2", "--fno_predict_delta",
            "--head_scale", "0.1", "--num_movie_frames", "3"]
CLI_CASES = {"teacher": [], "curriculum": ["--rollout_steps", "2"]}


@pytest.fixture(scope="module")
def fno_runs(tmp_path_factory):
    """{case: (jax run dir, port run dir)}: both CLIs from the same JAX
    TrainState (``--resume`` of an epoch -1 checkpoint), matplotlib
    hidden so that both write the movie's maps as ``.npz``."""
    base = tmp_path_factory.mktemp("fno")
    h5 = base / "traj.h5"
    write_synthetic_h5(h5, num_frames=120, num_residues=28, seed=13)
    runs = {}
    for case, extra in CLI_CASES.items():
        argv = ["--data_path", str(h5)] + CLI_ARGS + extra
        args = jtrain.parse_args(argv + ["--run_path", str(base / "x")])
        _, _, tcfg = jtrain.build_configs(args)
        jcfg = jconfigs.FNOConfig(
            width=8, modes1=6, modes2=6, depth=2, in_channels=4,
            num_residues=28, predict_delta=True, head_scale=0.1)
        jtx, _ = joptim.make_optimizer(
            tcfg.lr, grad_clip_norm=tcfg.grad_clip_norm,
            skip_nonfinite_updates=tcfg.skip_nonfinite_updates)
        jparams = jfno.fno_init(jax.random.PRNGKey(5), jcfg)
        init = base / f"{case}_init.npz"
        jcheckpoint.save_checkpoint(init, JaxTrainState(
            jparams, jtx.init(jparams), jnp.zeros((), jnp.int32),
            jax.random.PRNGKey(0)), {"epoch": -1})
        jdir, pdir = base / f"{case}_jax", base / f"{case}_port"
        argv += ["--resume", str(init)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "matplotlib", None)
            jtrain.main(argv + ["--run_path", str(jdir)])
            ptrain.main(argv + ["--run_path", str(pdir), "--device", "cpu"])
        runs[case] = (jdir, pdir)
    return runs


def _metrics(run):
    return [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_fno_cli_epochs_match_jax(case, fno_runs):
    jdir, pdir = fno_runs[case]
    want, got = _metrics(jdir), _metrics(pdir)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("avg_train_loss", "avg_valid_loss"):
            assert np.isfinite(g[k])
            np.testing.assert_allclose(g[k], w[k], RTOL, ATOL,
                                       err_msg=f"{k} epoch {g['epoch']}")
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    for e in (0, 1):
        with np.load(jdir / f"epoch{e}_maps.npz") as j, \
                np.load(pdir / f"epoch{e}_maps.npz") as p:
            for k in ("forecast", "real"):
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CLI_CASES))
@pytest.mark.parametrize("name", ["best.npz", "last.npz"])
def test_fno_cli_checkpoints_match_jax(case, name, fno_runs):
    jdir, pdir = fno_runs[case]
    with np.load(jdir / name) as j, np.load(pdir / name) as p:
        assert set(p.files) == set(j.files)
        for k in j.files:
            if k == ".rng":
                continue
            if j[k].dtype == np.float32:
                np.testing.assert_allclose(p[k], j[k], RTOL, ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    meta = [json.loads((d / f"{name}.json").read_text())["metadata"]
            for d in (jdir, pdir)]
    assert meta[0]["epoch"] == meta[1]["epoch"]


def test_fno_cli_config_json_matches_jax(fno_runs):
    jdir, pdir = fno_runs["curriculum"]
    jtext = (jdir / "config.json").read_text()
    ptext = (pdir / "config.json").read_text()
    want, got = json.loads(jtext), json.loads(ptext)
    assert got["train"].pop("run_path") == str(pdir)
    assert want["train"].pop("run_path") == str(jdir)
    assert got == want
    assert got["fno"]["width"] == 8 and got["train"]["rollout_steps"] == 2
    back = configs.experiment_from_json(ptext)
    assert dataclasses.asdict(back.fno) == dataclasses.asdict(
        jconfigs.experiment_from_json(jtext).fno)
