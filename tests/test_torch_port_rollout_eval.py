"""What judges a trained rollout, in the port against the JAX package on
the CPU: ``rollout_with_mse``, ``rollout_python_loop``, the three trivial
forecasters of ``rollout/baseline.py``, and ``langevin_trajectory``, the
synthetic family with real per-frame motion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    langevin_trajectory as jax_langevin_trajectory,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models.gkn import gkn_init
from molecular_dynamics_neural_operator_tpu.rollout import (
    baseline as jbaseline,
)
from molecular_dynamics_neural_operator_tpu.rollout import scan as jscan
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    langevin_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    copy_last_baseline,
    damped_extrapolation_baseline,
    linear_extrapolation_baseline,
    rollout_python_loop,
    rollout_scan,
    rollout_with_mse,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

SMALL = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", compute_dtype="float32",
             predict_delta=True)
# tests/test_torch_port_rollout.py's tolerance: f32 sums in another order,
# fed back through the window for a few steps
TOL = 2e-4


def _trajectories():
    return {
        "synthetic": jax_synthetic_trajectory(num_frames=16, num_residues=12,
                                              seed=5),
        "langevin": jax_langevin_trajectory(num_frames=16, num_residues=12,
                                            seed=13),
    }


def _setup(kind: str, **kw):
    opts = {**SMALL, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jparams = jax.tree.map(np.asarray,
                           gkn_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, jparams, _trajectories()[kind]


@pytest.mark.parametrize("clip", [None, 12.0], ids=["no-clip", "clip"])
@pytest.mark.parametrize("kind", ["synthetic", "langevin"])
def test_rollout_with_mse_matches_jax(kind, clip):
    jcfg, cfg, jparams, traj = _setup(kind)
    w0, truth = traj.positions[:4], traj.positions[4:10]
    want = jscan.rollout_with_mse(jparams, jcfg, jnp.asarray(traj.aminoacids),
                                  jnp.asarray(w0), jnp.asarray(truth),
                                  clip=clip)
    got = rollout_with_mse(params_from_jax(jparams, "cpu"), cfg,
                           torch.as_tensor(traj.aminoacids),
                           torch.as_tensor(w0), torch.as_tensor(truth),
                           clip=clip)
    (coords, mses, final), (wc, wm, wf) = got, want
    assert coords.shape == (6, 12, 3) and mses.shape == (6,)
    assert final.shape == (4, 12, 3)
    for a, b in ((coords, wc), (mses, wm), (final, wf)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    if clip is not None:
        assert float(coords.abs().max()) <= clip
    # the per-step MSE is that of the coordinates it returns
    torch.testing.assert_close(
        mses, ((coords - torch.as_tensor(truth)) ** 2).mean(dim=(1, 2)))
    empty = rollout_with_mse(params_from_jax(jparams, "cpu"), cfg,
                             torch.as_tensor(traj.aminoacids),
                             torch.as_tensor(w0), torch.as_tensor(truth[:0]))
    assert empty[0].shape == (0, 12, 3) and empty[1].shape == (0,)
    assert torch.equal(empty[2], torch.as_tensor(w0))


@pytest.mark.parametrize("graph_frame", ["last", "first"])
def test_rollout_python_loop_is_the_scan_and_matches_jax(graph_frame):
    """The host loop gives the rollout's coordinates to the bit (the same
    step, only read back each time) and the JAX package's loop within the
    rollout tolerance."""
    jcfg, cfg, jparams, traj = _setup("langevin")
    w0, aa = traj.positions[:4], traj.aminoacids
    params = params_from_jax(jparams, "cpu")
    coords, final = rollout_python_loop(params, cfg, torch.as_tensor(aa),
                                        torch.as_tensor(w0), 5,
                                        graph_frame=graph_frame)
    assert isinstance(coords, np.ndarray) and coords.shape == (5, 12, 3)
    scan, scan_final, _ = rollout_scan(params, cfg, torch.as_tensor(aa),
                                       torch.as_tensor(w0), 5,
                                       graph_frame=graph_frame)
    np.testing.assert_array_equal(coords, scan.numpy())
    assert torch.equal(final, scan_final)
    want, want_final = jscan.rollout_python_loop(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(w0), 5,
        graph_frame=graph_frame)
    np.testing.assert_allclose(coords, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["synthetic", "langevin"])
def test_baselines_match_jax_exactly(kind):
    """The same numpy arithmetic and the same contact test: equal bits."""
    traj = _trajectories()[kind]
    prev, last, truth = (traj.positions[3], traj.positions[4],
                         traj.positions[5:15])
    cases = [
        (copy_last_baseline(last, truth),
         jbaseline.copy_last_baseline(last, truth)),
        (linear_extrapolation_baseline(prev, last, truth, threshold=7.0),
         jbaseline.linear_extrapolation_baseline(prev, last, truth,
                                                 threshold=7.0)),
    ]
    for gamma in (0.0, 0.5, 1.0):
        cases.append((
            damped_extrapolation_baseline(prev, last, truth, gamma),
            jbaseline.damped_extrapolation_baseline(prev, last, truth,
                                                    gamma)))
    for (mse, acc), (jmse, jacc) in cases:
        assert mse.shape == acc.shape == (10,)
        np.testing.assert_array_equal(mse, jmse)
        np.testing.assert_array_equal(acc, jacc)
        assert ((acc > 0) & (acc <= 1)).all()
    # gamma 0 is copy-last and gamma 1 the linear forecast
    np.testing.assert_array_equal(cases[2][0][1], cases[0][0][1])
    np.testing.assert_array_equal(
        cases[4][0][0], linear_extrapolation_baseline(prev, last, truth)[0])


def test_baselines_score_what_they_forecast():
    """Against a truth that moves at constant velocity, the linear
    forecast is exact and copy-last is not."""
    rng = np.random.default_rng(0)
    last = rng.normal(scale=6.0, size=(12, 3)).astype(np.float32)
    v = rng.normal(scale=0.5, size=(12, 3)).astype(np.float32)
    prev = last - v
    truth = np.stack([last + v * t for t in range(1, 6)]).astype(np.float32)
    mse, acc = linear_extrapolation_baseline(prev, last, truth)
    np.testing.assert_allclose(mse, 0.0, atol=1e-10)
    assert (acc == 1.0).all()
    mse_c, _ = copy_last_baseline(last, truth)
    assert (np.diff(mse_c) > 0).all()
    # torch tensors are taken as well as arrays
    mse_t, acc_t = copy_last_baseline(torch.as_tensor(last),
                                      torch.as_tensor(truth))
    np.testing.assert_array_equal(mse_t, mse_c)


@pytest.mark.parametrize("kw", [
    dict(num_frames=40, num_residues=12, seed=3, burn_in=50),
    dict(num_frames=30, num_residues=28, seed=13),
    dict(num_frames=20, num_residues=16, seed=1, friction=0.02, kT=0.3,
         threshold=7.0, burn_in=10),
], ids=["jax-test", "bba-size", "ballistic"])
def test_langevin_trajectory_is_bit_identical_to_jax(kw):
    got, want = langevin_trajectory(**kw), jax_langevin_trajectory(**kw)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.aminoacids, want.aminoacids)
    np.testing.assert_array_equal(got.rmsd, want.rmsd)
    assert len(got.edge_indices) == len(want.edge_indices) == kw["num_frames"]
    for a, b in zip(got.edge_indices, want.edge_indices):
        np.testing.assert_array_equal(a, b)
    # real per-frame motion, unlike the breathing family's slow modes
    step = np.linalg.norm(np.diff(got.positions, axis=0), axis=-1).mean()
    assert step > 1e-3
