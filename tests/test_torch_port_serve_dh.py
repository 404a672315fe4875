"""``electrostatics="dh"`` in the PyTorch port against the JAX package, on
the CPU in f32: the Debye-Hückel functions, the node encoder, the forward,
the plain rollout and the kernel rollout (plain versions on CPU tensors)
against the JAX scan and the Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.ops.pallas.persistent_rollout import (  # noqa: E501
    persistent_rollout as jax_persistent_rollout,
)
from molecular_dynamics_neural_operator_tpu.preprocess import grid_jax
from molecular_dynamics_neural_operator_tpu.rollout import (
    rollout_scan as jax_rollout_scan,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.preprocess import grid
from molecular_dynamics_neural_operator_tpu_torch.rollout import rollout_scan
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

SMALL = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", compute_dtype="float32",
             predict_delta=True, electrostatics="dh")
# f32 sums over <= 128 edges and 32 hidden units through 4 conv layers in
# another order (tests/test_torch_port_model.py)
RTOL, ATOL = 1e-5, 2e-5
# the JAX package's own tolerance between its scan and its Pallas kernel
# with dh (tests/test_persistent_rollout.py): f32 sums in another order,
# fed back through the window for a few steps
ROLL_TOL = 2e-4


def _setup(seed=2, **kw):
    opts = {**SMALL, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(seed), jcfg))
    traj = synthetic_trajectory(num_frames=24, num_residues=12, seed=8)
    return jcfg, cfg, jparams, params_from_jax(jparams, "cpu"), traj


def test_constants_and_kappa_match_jax():
    np.testing.assert_array_equal(grid.AMINO_ACID_CHARGES,
                                  grid_jax.AMINO_ACID_CHARGES)
    assert grid.DH_MIN_DIST == grid_jax.DH_MIN_DIST
    assert grid._BJERRUM_A_K == grid_jax._BJERRUM_A_K
    for args in ((), (0.05, 80.0, 298.0), (1.0, 4.0, 350.0)):
        assert grid.debye_kappa(*args) == grid_jax.debye_kappa(*args)
    assert grid.bjerrum_length(78.0, 310.0) == 16712.2 / (78.0 * 310.0)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["single", "batched"])
@pytest.mark.parametrize("opts", [
    {}, dict(eps_s=40.0, temperature=298.0, ionic_strength_M=0.5,
             min_dist=2.5)], ids=["defaults", "other-solvent"])
def test_debye_huckel_at_atoms_matches_jax(batch, opts):
    rng = np.random.default_rng(0)
    # residues 0 and 1 closer than the clamp
    pos = (rng.normal(size=batch + (12, 3)) * 6).astype(np.float32)
    pos[..., 1, :] = pos[..., 0, :] + 0.3
    q = grid.AMINO_ACID_CHARGES[rng.integers(0, 20, 12)]
    want = grid_jax.debye_huckel_at_atoms(jnp.asarray(pos), jnp.asarray(q),
                                          **opts)
    got = grid.debye_huckel_at_atoms(torch.as_tensor(pos),
                                     torch.as_tensor(q), **opts)
    assert got.shape == batch + (12,)
    # 11 f32 terms a site, summed in another order; exp and sqrt of the
    # two libraries differ in the last place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_potential_sums_the_sources_charges_and_skips_self():
    pos = torch.tensor([[0.0, 0, 0], [3.0, 0, 0], [0, 5.0, 0]])
    q = torch.tensor([1.0, 0.0, -1.0])
    phi = grid.debye_huckel_at_atoms(pos, q)
    lb, kappa = grid.bjerrum_length(), grid.debye_kappa()
    g = lambda d: lb * np.exp(-kappa * d) / d  # noqa: E731
    want = [-g(5.0), g(3.0) - g(np.sqrt(34.0)), g(5.0)]
    np.testing.assert_allclose(phi.numpy(), want, rtol=1e-5)
    # per-example charges broadcast against the batch
    phi2 = grid.debye_huckel_at_atoms(pos.expand(2, 3, 3),
                                      torch.stack([q, -q]))
    np.testing.assert_allclose(phi2[1].numpy(), -phi.numpy(), rtol=1e-6)


def test_residue_charges_wrap_at_twenty():
    aa = torch.tensor([1, 21, 3, 8, 19])
    np.testing.assert_array_equal(grid.residue_charges(aa).numpy(),
                                  np.float32([1.0, 1.0, -1.0, 0.1, 0.0]))


def test_gkn_init_gives_fc1_a_row_for_the_potential():
    jcfg, cfg, jparams, _, _ = _setup()
    params = gkn.gkn_init(cfg, seed=0, device="cpu")
    assert params["fc1"]["w"].shape == (8, 16) == jparams["fc1"]["w"].shape
    got = jax.tree.map(lambda t: tuple(t.shape), params)
    assert got == jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert gkn.gkn_init(ModelConfig(), device="cpu")["fc1"]["w"].shape[0] == 7


def _jax_graph(cfg, frame):
    adj = jgeo.contact_map(frame, 8.0)
    edges, mask = jgeo.padded_edges_device(adj, cfg.max_edges)
    return jgkn.SparseGraph(edges=edges, mask=mask,
                            edge_feats=jgeo.edge_features_from_edges(
                                frame, edges))


def test_encode_nodes_and_forward_match_jax():
    jcfg, cfg, jparams, params, traj = _setup()
    aa, window = traj.aminoacids, traj.positions[:4]
    want_x = jgkn._encode_nodes(jparams, jcfg, jnp.asarray(aa),
                                jnp.asarray(window))
    got_x = gkn._encode_nodes(params, cfg, torch.as_tensor(aa),
                              torch.as_tensor(window))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), RTOL, ATOL)
    # the potential is read: other charges, other features
    other = gkn._encode_nodes(params, cfg, torch.as_tensor((aa + 1) % 20),
                              torch.as_tensor(window))
    assert not np.allclose(other.numpy(), got_x.numpy(), atol=1e-3)

    jgraph = _jax_graph(jcfg, jnp.asarray(window[-1]))
    want = jgkn.gkn_apply_single(jparams, jcfg, jnp.asarray(aa),
                                 jnp.asarray(window), jgraph)
    graph = gkn.SparseGraph(*(torch.as_tensor(np.array(t)) for t in jgraph))
    got = gkn.gkn_apply_single(params, cfg, torch.as_tensor(aa),
                               torch.as_tensor(window), graph)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_one_sequence_per_stream_matches_one_stream_at_a_time():
    """aa (S, R): what the server's scan impl hands the model."""
    _, cfg, _, params, traj = _setup()
    rng = np.random.default_rng(1)
    aas = torch.as_tensor(rng.integers(0, 20, (3, 12)))
    windows = torch.as_tensor(np.stack(
        [traj.positions[i:i + 4] for i in (0, 6, 12)]))
    got, _, _ = rollout_scan(params, cfg, aas, windows, 3)
    for i in range(3):
        want, _, _ = rollout_scan(params, cfg, aas[i], windows[i], 3)
        # the same sums over a batch of 3: f32 order differences
        np.testing.assert_allclose(got[i].numpy(), want.numpy(), RTOL, ATOL)
    assert not np.allclose(got[0].numpy(), rollout_scan(
        params, cfg, aas[1], windows[0], 3)[0].numpy(), atol=1e-4)


def test_rollout_scan_with_dh_matches_jax_with_equal_edge_lists():
    jcfg, cfg, jparams, params, traj = _setup()
    aa, w0 = traj.aminoacids, traj.positions[:4]
    steps = 8
    want, want_final, _ = jax.jit(lambda p, a, w: jax_rollout_scan(
        p, jcfg, a, w, steps))(jparams, jnp.asarray(aa), jnp.asarray(w0))
    got, final, diags = rollout_scan(params, cfg, torch.as_tensor(aa),
                                     torch.as_tensor(w0), steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLL_TOL,
                               atol=ROLL_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final),
                               rtol=ROLL_TOL, atol=ROLL_TOL)
    assert not bool(diags["edge_overflow"])
    frames = np.concatenate([w0[-1:], got.numpy()[:-1]])
    jframes = np.concatenate([w0[-1:], np.asarray(want)[:-1]])
    for k in range(steps):
        np.testing.assert_array_equal(
            np.asarray(jgeo.contact_map(jnp.asarray(frames[k]), 8.0)),
            np.asarray(jgeo.contact_map(jnp.asarray(jframes[k]), 8.0)))


@pytest.mark.parametrize("streams", [1, 3])
def test_kernel_rollout_with_dh_matches_jax_pallas_interpret(streams):
    jcfg, cfg, jparams, params, traj = _setup()
    aa = traj.aminoacids
    w0 = np.stack([traj.positions[i:i + 4] for i in (0, 5, 10)][:streams])
    if streams == 1:
        w0 = w0[0]
    steps = 5
    want, want_diags = jax_persistent_rollout(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(w0), steps,
        interpret=True)
    pr.reset_launch_counts()
    got, final, diags = pr.make_persistent_rollout_fn(
        cfg, steps, device="cpu")(params, aa, w0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROLL_TOL,
                               atol=ROLL_TOL)
    assert bool(diags["edge_overflow"]) == bool(want_diags["edge_overflow"])
    assert pr.launch_counts()["graph_encode"] == 0
    # and against the port's own plain rollout
    plain, plain_final, _ = rollout_scan(params, cfg, torch.as_tensor(aa),
                                         torch.as_tensor(w0), steps)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(final.numpy(), plain_final.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_rollout_weights_carry_charges_and_the_phi_row():
    _, cfg, _, params, traj = _setup()
    aa = np.asarray(traj.aminoacids) + 20  # labels wrap at 20
    weights = pr.rollout_weights(params, cfg, aa % 20, "cpu")
    assert weights["fc1"]["w"].shape == (8, 16)
    np.testing.assert_array_equal(
        weights["charges"].numpy(), grid.AMINO_ACID_CHARGES[aa % 20])
    plain_cfg = ModelConfig(**{**SMALL, "electrostatics": "none"})
    plain = pr.rollout_weights(gkn.gkn_init(plain_cfg, device="cpu"),
                               plain_cfg, aa % 20, "cpu")
    assert plain["charges"] is None and plain["fc1"]["w"].shape == (7, 16)


def test_prepared_rollout_reuses_weights_and_buffers_and_chains_exactly():
    _, cfg, _, params, traj = _setup()
    aa = traj.aminoacids
    w0 = torch.as_tensor(np.stack([traj.positions[:4], traj.positions[6:10]]))
    prepared = pr.PreparedRollout(params, cfg, aa, device="cpu")
    whole, whole_final, _ = prepared(w0, 7)
    bufs = prepared.buffers(2, 12)
    first, carry, _ = prepared(w0, 4)
    rest, final, diags = prepared(carry, 3)
    assert prepared.buffers(2, 12) is bufs
    assert torch.equal(torch.cat([first, rest], dim=1), whole)
    assert torch.equal(final, whole_final)
    assert not bool(diags["edge_overflow"])
    one_shot, _, _ = pr.rollout_kernels(params, cfg, aa, w0, 7, device="cpu")
    assert torch.equal(one_shot, whole)
    run = pr.make_persistent_rollout_fn(cfg, 7, device="cpu").prepare(
        params, aa)
    assert torch.equal(run(w0)[0], whole)
    # the overflow flag is per call, not sticky across calls
    tight = ModelConfig(**{**SMALL, "max_edges": 16})
    tight_run = pr.PreparedRollout(params, tight, aa, device="cpu")
    assert bool(tight_run(w0, 1)[2]["edge_overflow"])
    far = w0 * 100.0
    assert not bool(tight_run(far, 1)[2]["edge_overflow"])
