"""The port's cell-list rebuild (``geometry/cells.py``) and the paths that
take it, against the JAX package on the CPU in f32.

The cell list itself must equal the JAX package's exactly: the same edges
in the same slots, the same mask and both overflow flags, for every
example of a batch. Through the model the tolerances are those of the
other port tests: rtol 2e-4 and atol 1e-5 (a gradient leaf's atol
scaled by its largest element above 1); the served request against a
dedicated rollout, 1e-4 / 1e-5 (a batch of streams may sum its products
in another order)."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.cli import rollout as jrollout
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.geometry import cells as jcells
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.rollout import scan as jscan
from molecular_dynamics_neural_operator_tpu.train import (
    curriculum as jcurriculum,
)
from molecular_dynamics_neural_operator_tpu_torch.cli import rollout as prollout
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    write_synthetic_h5,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry import (
    build_cell_table,
    cell_list_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.rollout import scan
from molecular_dynamics_neural_operator_tpu_torch.serving import (
    RolloutServer,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    curriculum,
    loop,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 1e-5
WAIT = 120  # seconds a served request may take before the test fails


def _cloud(n, seed, shift=-5.0):
    """Clustered points around the origin, so that cells hold several
    atoms and coordinates and cell indices are negative too."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)) * (n ** (1 / 3)) * 2.0
            + shift).astype(np.float32)


def _chain(n, t, seed, step=2.5, drift=0.02):
    """A loose random chain of n atoms (about 16 neighbours an atom at
    8 A) and t frames that drift by ``drift`` A a frame."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(n, 3)).astype(np.float32) * step,
                     axis=0)
    return np.stack([base + drift * i for i in range(t)]).astype(np.float32)


def _assert_same(got, want):
    np.testing.assert_array_equal(got.edges.numpy(), np.asarray(want.edges))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert bool(got.cell_overflow) == bool(want.cell_overflow)
    assert bool(got.degree_overflow) == bool(want.degree_overflow)


# (n, seed, options, (cell_overflow, degree_overflow))
CASES = {
    "n50": (50, 0, dict(max_degree=64, cell_capacity=32), (False, False)),
    "n300": (300, 1, dict(max_degree=64, cell_capacity=32, num_cells=512),
             (False, False)),
    "n1200": (1200, 2, dict(max_degree=48, cell_capacity=32,
                            num_cells=1024), (False, False)),
    "cell_overflow": (300, 3, dict(max_degree=64, cell_capacity=4,
                                   num_cells=512), (True, False)),
    "degree_overflow": (300, 4, dict(max_degree=8, cell_capacity=32,
                                     num_cells=512), (False, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cell_list_edges_match_jax_exactly(case):
    n, seed, opts, flags = CASES[case]
    pos = _cloud(n, seed)
    want = jcells.cell_list_edges(jnp.asarray(pos), 8.0, **opts)
    got = cell_list_edges(torch.as_tensor(pos), 8.0, **opts)
    _assert_same(got, want)
    assert (bool(got.cell_overflow), bool(got.degree_overflow)) == flags
    assert got.edges.dtype == torch.int32 and got.mask.dtype == torch.float32


def test_build_cell_table_matches_jax():
    pos = _cloud(300, 5)
    jcid, jtable, jover = jcells.build_cell_table(jnp.asarray(pos), 8.0, 8,
                                                  256)
    cid, table, over = build_cell_table(torch.as_tensor(pos), 8.0, 8, 256)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(jcid))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    assert bool(over) == bool(jover)
    with pytest.raises(ValueError, match="power of 2"):
        build_cell_table(torch.as_tensor(pos), 8.0, 8, 100)


@pytest.mark.parametrize("lo,n_local", [(0, 16), (16, 16), (32, 16), (8, 24)])
def test_atom_slice_matches_jax(lo, n_local):
    pos = _cloud(48, 7, shift=0.0)
    want = jcells.cell_list_edges(jnp.asarray(pos), 8.0, 16, 16,
                                  atom_slice=(lo, n_local))
    got = cell_list_edges(torch.as_tensor(pos), 8.0, 16, 16,
                          atom_slice=(lo, n_local))
    _assert_same(got, want)
    full = cell_list_edges(torch.as_tensor(pos), 8.0, 16, 16)
    sl = slice(lo * 16, (lo + n_local) * 16)
    assert torch.equal(got.edges, full.edges[:, sl])
    # the degree flag covers the slice's atoms only
    far = np.zeros((20, 3), np.float32)
    far[10:] += 100.0
    for atoms, flag in (((0, 10), True), ((10, 10), True)):
        out = cell_list_edges(torch.as_tensor(far), 8.0, 4, 32,
                              atom_slice=atoms)
        assert bool(out.degree_overflow) == flag == bool(
            jcells.cell_list_edges(jnp.asarray(far), 8.0, 4, 32,
                                   atom_slice=atoms).degree_overflow)


def test_batched_equals_per_example():
    """Leading axes (2, 3): one sort over every example's keys gives each
    example the edges and flags of its own rebuild, overflow included."""
    frames = np.stack([_cloud(200, s) for s in range(6)])
    frames[4] = 0.0  # every atom in one cell: its capacity overflows
    # 60 atoms within 8 A of each other in few cells, the rest apart:
    # more neighbours than max_degree, no full cell
    frames[5, :60] = np.random.default_rng(0).uniform(4.5, 11.5, (60, 3))
    frames[5, 60:] = 1000.0 + 20.0 * np.arange(140)[:, None]
    opts = dict(max_degree=32, cell_capacity=16, num_cells=256)
    got = cell_list_edges(torch.as_tensor(frames.reshape(2, 3, 200, 3)),
                          8.0, **opts)
    assert got.edges.shape == (2, 3, 2, 200 * 32)
    assert got.cell_overflow.shape == (2, 3)
    flat = [cell_list_edges(torch.as_tensor(f), 8.0, **opts) for f in frames]
    for i, one in enumerate(flat):
        b, s = divmod(i, 3)
        assert torch.equal(got.edges[b, s], one.edges)
        assert torch.equal(got.mask[b, s], one.mask)
        assert bool(got.cell_overflow[b, s]) == bool(one.cell_overflow)
        assert bool(got.degree_overflow[b, s]) == bool(one.degree_overflow)
    assert got.cell_overflow.tolist() == [[False] * 3, [False, True, False]]
    assert got.degree_overflow.tolist() == [[False] * 3, [False, False, True]]


# ---- the rollout and the curriculum -----------------------------------------

def _cfgs(r, **kw):
    opts = dict(width=4, ker_width=8, depth=1, window_size=3,
                num_residues=r, graph_mode="sparse",
                compute_dtype="float32", predict_delta=True,
                neighbor_impl="cell_list", max_degree=48,
                max_edges=r * 48, cell_capacity=32, num_cells=1024)
    opts.update(kw)
    return JaxModelConfig(**opts), ModelConfig(**opts)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jgkn.gkn_init(jax.random.PRNGKey(seed), jcfg))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


@pytest.mark.parametrize("r,hint", [(40, "onehot"), (600, "blocked")])
def test_rollout_scan_with_the_cell_list_matches_jax(r, hint):
    jcfg, cfg = _cfgs(r)
    assert scan.rebuilt_scatter_hint(cfg, r) == hint
    jparams = _params(jcfg)
    window = _chain(r, 3, seed=r)
    aa = np.random.default_rng(1).integers(0, 20, r).astype(np.int32)
    want, jfinal, jdiag = jscan.rollout_scan(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(window), 3)
    got, final, diag = scan.rollout_scan(
        params_from_jax(jparams, "cpu"), cfg, torch.as_tensor(aa),
        torch.as_tensor(window), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), RTOL, ATOL)
    assert bool(diag["edge_overflow"]) == bool(jdiag["edge_overflow"])
    assert not bool(diag["edge_overflow"])
    # a degree capacity too small for the chain is flagged in both
    small_j, small = _cfgs(r, max_degree=4, max_edges=r * 4)
    _, _, jd = jscan.rollout_scan(jparams, small_j, jnp.asarray(aa),
                                  jnp.asarray(window), 1)
    _, _, d = scan.rollout_scan(params_from_jax(jparams, "cpu"), small,
                                torch.as_tensor(aa), torch.as_tensor(window),
                                1)
    assert bool(d["edge_overflow"]) == bool(jd["edge_overflow"]) is True


def test_a_cell_list_curriculum_step_matches_jax():
    """K = 2 at R = 600, B = 2: the first step on a graph rebuilt from
    each window's last frame, the free step on the model's own
    prediction, both in the block layout ("blocked" past 512 nodes);
    loss, MSE, overflow and every gradient."""
    r, b, k = 600, 2, 2
    jcfg, cfg = _cfgs(r, max_degree=64, max_edges=r * 64)
    jparams = _params(jcfg, 3)
    traj = np.stack([_chain(r, 3 + k, seed=10 + i) for i in range(b)])
    window, y_seq = traj[:, :3], traj[:, 3:]
    aa = np.random.default_rng(2).integers(0, 20, r).astype(np.int32)
    hint = scan.rebuilt_scatter_hint(cfg, r)
    assert hint == "blocked"
    opts = dict(return_overflow=True, coord_clip=1000.0)

    def jloss(p):
        w = jnp.asarray(window)
        graph, ov0 = jax.vmap(
            lambda f: jscan._build_graph(jcfg, f, 8.0))(w[:, -1])
        gb = jgkn.GKNBatch(aa=jnp.asarray(aa), window=w, graph=graph,
                           y=jnp.asarray(y_seq[:, 0]))
        loss, (m, ov) = jcurriculum.curriculum_loss_batched(
            p, jcfg, gb, jnp.asarray(y_seq), teacher_scatter_hint=hint,
            **opts)
        return loss, (m, ov | jnp.any(ov0))

    (jl, (jm, jov)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jparams)

    def ploss(p):
        w = torch.as_tensor(window)
        graph, ov0 = scan._build_graph(cfg, w[:, -1], 8.0)
        gb = gkn.GKNBatch(aa=torch.as_tensor(aa), window=w, graph=graph,
                          y=torch.as_tensor(y_seq[:, 0]))
        loss, (m, ov) = curriculum.curriculum_loss_batched(
            p, cfg, gb, torch.as_tensor(y_seq), teacher_scatter_hint=hint,
            **opts)
        return loss, (m, ov | ov0.any())

    (loss, (m, ov)), grads = loop.value_and_grad(
        ploss, params_from_jax(jparams, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(m), float(jm), rtol=RTOL)
    assert bool(ov) == bool(jov) is False
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(g.numpy(), want[name], RTOL, ATOL * scale,
                                   err_msg=name)


# ---- the CLI and the server -------------------------------------------------

def test_cli_rollout_with_the_cell_list_matches_jax(tmp_path):
    """``cli.rollout --neighbor_impl cell_list`` of the bench checkpoint
    (f32, 12 steps, the one-hot hint at 28 residues) against the JAX
    CLI: the same files, coordinates and per-step MSE."""
    h5 = tmp_path / "traj.h5"
    write_synthetic_h5(h5, num_frames=40, num_residues=28, seed=13)
    argv = ["--data_path", str(h5), "--checkpoint",
            str(ROOT / "tools" / "bench_ckpt.npz"), "--graph_mode",
            "sparse", "--neighbor_impl", "cell_list", "--max_degree", "32",
            "--cell_capacity", "32", "--num_cells", "1024",
            "--predict_delta", "--compute_dtype", "float32", "--num_steps",
            "12"]
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        js = jrollout.main(argv + ["--out_path", str(jdir)])
        ps = prollout.main(argv + ["--out_path", str(pdir), "--device",
                                   "cpu"])
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    np.testing.assert_allclose(np.load(pdir / "forecast_coords.npy"),
                               np.load(jdir / "forecast_coords.npy"),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.load(pdir / "per_step_mse.npy"),
                               np.load(jdir / "per_step_mse.npy"), RTOL,
                               ATOL)
    assert ps["finite"] and js["finite"]


def test_a_cell_list_server_request_matches_a_dedicated_rollout():
    """``RolloutServer(impl="scan")`` on a cell-list configuration: two
    requests served in one batch, each against its own rollout."""
    r = 40
    jcfg, cfg = _cfgs(r, window_size=4)
    params = params_from_jax(_params(jcfg), "cpu")
    aa = np.random.default_rng(4).integers(0, 20, r).astype(np.int32)
    windows = [_chain(r, 4, seed=s) for s in (20, 21)]
    srv = RolloutServer(params, cfg, device="cpu", impl="scan",
                        segment_steps=4)
    try:
        futs = [srv.submit(aa, w, 6) for w in windows]
        results = [f.result(timeout=WAIT) for f in futs]
    finally:
        srv.close(timeout=WAIT)
    for res, w in zip(results, windows):
        want, _, diag = scan.rollout_scan(
            params, cfg, torch.as_tensor(aa), torch.as_tensor(w), 6)
        assert not bool(diag["edge_overflow"])
        assert not res.edge_overflow
        np.testing.assert_allclose(res.coords, want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    assert dataclasses.asdict(cfg)["neighbor_impl"] == "cell_list"
