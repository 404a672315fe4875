"""The PyTorch port's rollouts against the JAX package's, on the CPU in f32.

The port's plain rollout (``rollout/scan.py``) and its kernel rollout
(``ops/cuda/persistent_rollout.py``, which on CPU tensors runs each
kernel's plain version) are held against the JAX ``rollout_scan`` and the
JAX Pallas ``persistent_rollout`` in interpret mode, at the small config of
tests/test_persistent_rollout.py, and once at full width on the trained
bench checkpoint.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.models import gkn_init
from molecular_dynamics_neural_operator_tpu.ops.pallas.persistent_rollout import (  # noqa: E501
    persistent_rollout as jax_persistent_rollout,
)
from molecular_dynamics_neural_operator_tpu.rollout import (
    make_rollout_fn as jax_make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu.rollout import (
    rollout_scan as jax_rollout_scan,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry import contact
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    make_rollout_fn,
    rollout_scan,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    load_params_npz,
    params_from_jax,
)

CKPT = Path(__file__).resolve().parents[1] / "tools" / "bench_ckpt.npz"
SMALL = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", compute_dtype="float32",
             predict_delta=True)
# tests/test_persistent_rollout.py's tolerance between the two JAX paths:
# f32 sums in another order, fed back through the window for a few steps
TOL = 2e-4


def _setup(r, seed, traj_seed=None, **kw):
    opts = {**SMALL, "num_residues": r, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jparams = jax.tree.map(np.asarray,
                           gkn_init(jax.random.PRNGKey(seed), jcfg))
    traj = synthetic_trajectory(num_frames=16, num_residues=r,
                                seed=seed + 5 if traj_seed is None
                                else traj_seed)
    return jcfg, cfg, jparams, params_from_jax(jparams, "cpu"), traj


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("r", [12, 11])
def test_rollouts_match_jax_scan_and_pallas_interpret(r, batched):
    """Seeds, windows and step counts of tests/test_persistent_rollout.py
    (single stream and multi-stream), where the two JAX paths agree."""
    if batched:
        jcfg, cfg, jparams, params, traj = _setup(r, 4, traj_seed=9)
        w0 = np.stack([traj.positions[i:i + 4] for i in (0, 5, 10)])
        steps = 5
    else:
        jcfg, cfg, jparams, params, traj = _setup(r, 0, traj_seed=5)
        w0 = traj.positions[:4]
        steps = 6
    aa = traj.aminoacids
    want, want_final, want_diags = jax_make_rollout_fn(
        jcfg, steps, batched=batched)(jparams, jnp.asarray(aa),
                                      jnp.asarray(w0))
    pallas, pallas_diags = jax_persistent_rollout(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(w0), steps,
        interpret=True)

    got, final, diags = make_rollout_fn(cfg, steps, batched=batched,
                                        device="cpu")(params, aa, w0)
    kcoords, kfinal, kdiags = pr.make_persistent_rollout_fn(
        cfg, steps, device="cpu")(params, aa, w0)

    for coords, fin in ((got, final), (kcoords, kfinal)):
        assert coords.shape == want.shape
        _close(coords, want)
        _close(coords, pallas)
        _close(fin, want_final)
    np.testing.assert_array_equal(diags["edge_overflow"].numpy(),
                                  np.asarray(want_diags["edge_overflow"]))
    assert bool(kdiags["edge_overflow"]) == bool(pallas_diags["edge_overflow"])


@pytest.mark.parametrize("opts", [
    dict(predict_prior="extrapolate", prior_damping=0.5),
    dict(predict_prior="extrapolate", head_scale=0.05),
    dict(predict_delta=False),
], ids=["damped", "head-scale", "absolute"])
def test_kernel_rollout_matches_jax_pallas_interpret(opts):
    jcfg, cfg, jparams, params, traj = _setup(12, 3, **opts)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    clip = None if cfg.predict_delta else 50.0
    want, _ = jax_persistent_rollout(jparams, jcfg, jnp.asarray(aa),
                                     jnp.asarray(w0), 5, clip=clip,
                                     interpret=True)
    got, _ = pr.persistent_rollout(params, cfg, aa, w0, 5, clip=clip,
                                   device="cpu")
    _close(got, want)


@pytest.mark.parametrize("collect", ["contact_maps", "both"])
def test_collect_modes_match_jax(collect):
    jcfg, cfg, jparams, params, traj = _setup(12, 1)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    want, _, _ = jax_rollout_scan(jparams, jcfg, jnp.asarray(aa),
                                  jnp.asarray(w0), 5, collect=collect)
    got, _, _ = rollout_scan(params, cfg, torch.as_tensor(aa),
                             torch.as_tensor(w0), 5, collect=collect)
    if collect == "both":
        _close(got[0], want[0])
        got, want = got[1], want[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_overflow_flag_matches_jax():
    jcfg, cfg, jparams, params, traj = _setup(12, 0, max_edges=16)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    _, _, want = jax_rollout_scan(jparams, jcfg, jnp.asarray(aa),
                                  jnp.asarray(w0), 2, clip=100.0)
    _, _, got = make_rollout_fn(cfg, 2, clip=100.0, device="cpu")(
        params, aa, w0)
    _, kdiags = pr.persistent_rollout(params, cfg, aa, w0, 2, clip=100.0,
                                      device="cpu")
    assert bool(want["edge_overflow"])
    assert bool(got["edge_overflow"]) and bool(kdiags["edge_overflow"])


def test_final_window_when_steps_fewer_than_window():
    _, cfg, _, params, traj = _setup(12, 2)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    coords, final, _ = pr.make_persistent_rollout_fn(cfg, 2, device="cpu")(
        params, aa, w0)
    np.testing.assert_array_equal(
        final.numpy(), np.concatenate([w0[2:], coords.numpy()]))
    _, ref_final, _ = make_rollout_fn(cfg, 2, device="cpu")(params, aa, w0)
    np.testing.assert_array_equal(final.numpy(), ref_final.numpy())


@pytest.mark.parametrize("opts,err", [
    (dict(window_diff=True), ValueError),
    (dict(legacy_no_lstm=True), ValueError),
    (dict(kernel_quant="int8"), ValueError),
    (dict(tie_edge_kernel=False), ValueError),
    # "dh" is ported; a value neither package knows is still refused
    pytest.param(dict(electrostatics="pb"), ValueError,
                 id="opts4-NotImplementedError"),
])
def test_kernel_rollout_keeps_the_jax_kernels_guards(opts, err):
    cfg = dataclasses.replace(ModelConfig(**SMALL), **opts)
    with pytest.raises(err):
        pr.make_persistent_rollout_fn(cfg, 2, device="cpu")


def test_full_width_bench_checkpoint_matches_jax_scan():
    """Bench model (w64/kw1024/depth6/E224, trained checkpoint), f32, 8
    steps from the seed-13 window: identical edge lists at every step."""
    opts = dict(compute_dtype="float32", graph_mode="sparse", max_edges=224,
                predict_delta=True)
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    params = load_params_npz(CKPT, device="cpu")
    with np.load(CKPT) as raw:
        flat = {k: raw[k].astype(np.float32) for k in raw.files}
    jparams: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = jparams
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(value)
    traj = synthetic_trajectory(num_frames=4000, seed=13)
    aa, w0 = traj.aminoacids, traj.positions[:10]
    steps = 8
    want, _, want_diags = jax.jit(lambda p, a, w: jax_rollout_scan(
        p, jcfg, a, w, steps, clip=100.0))(jparams, jnp.asarray(aa),
                                            jnp.asarray(w0))
    got, _, diags = make_rollout_fn(cfg, steps, clip=100.0, device="cpu")(
        params, aa, w0)
    kgot, _, _ = pr.make_persistent_rollout_fn(cfg, steps, clip=100.0,
                                               device="cpu")(params, aa, w0)
    # f32 sums over 1024 hidden units and 12 conv layers in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(kgot.numpy(), got.numpy())
    assert not bool(want_diags["edge_overflow"])
    assert not bool(diags["edge_overflow"])
    # the graph of step k comes from the frame predicted at step k - 1
    frames = np.concatenate([w0[-1:], got.numpy()[:-1]])
    jframes = np.concatenate([w0[-1:], np.asarray(want)[:-1]])
    adj = contact.contact_map(torch.as_tensor(frames), 8.0)
    edges, mask = contact.padded_edges_device(adj, 224)
    for k in range(steps):
        jedges, jmask = jgeo.padded_edges_device(
            jgeo.contact_map(jnp.asarray(jframes[k]), 8.0), 224)
        np.testing.assert_array_equal(edges[k].numpy(), np.asarray(jedges))
        np.testing.assert_array_equal(mask[k].numpy(), np.asarray(jmask))
