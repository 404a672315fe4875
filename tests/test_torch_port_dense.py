"""The port's dense contact graph (``graph_mode="dense"``) against the JAX
package on the CPU in f32: the contact helpers (exact), ``edge_conv_dense``,
the dense forward with its gradients (tied, untied, ``electrostatics=
"dh"``), the dense batch, the dense rollout, a K = 2 curriculum step, a
served request and both CLIs with their default graph flags.

Tolerances: f32, rtol 2e-4 and atol 1e-5 (scaled by a gradient leaf's
largest element above 1, as in tests/test_torch_port_curriculum.py): the
dense sums run over every source and channel, in another order in torch
than in XLA."""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.cli import rollout as jrollout
from molecular_dynamics_neural_operator_tpu.cli import train as jtrain
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.ops import edge_conv as jconv
from molecular_dynamics_neural_operator_tpu.rollout import scan as jscan
from molecular_dynamics_neural_operator_tpu.train import (
    curriculum as jcurriculum,
)
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu_torch import geometry as geo
from molecular_dynamics_neural_operator_tpu_torch.cli import rollout as prollout
from molecular_dynamics_neural_operator_tpu_torch.cli import train as ptrain
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
    write_synthetic_h5,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.ops import edge_conv
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

RTOL, ATOL = 2e-4, 1e-5
BASE = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
            max_edges=160, graph_mode="dense", compute_dtype="float32",
            predict_delta=True)
BATCH = 5
WAIT = 120  # seconds a served request may take before the test fails


def _cfgs(**kw):
    opts = {**BASE, **kw}
    return JaxModelConfig(**opts), ModelConfig(**opts)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jgkn.gkn_init(jax.random.PRNGKey(seed), jcfg))


def _positions(seed, shape):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=shape[-2:]).astype(np.float32) * 5
    return (base + 0.3 * rng.normal(size=shape)).astype(np.float32)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _assert_grads_close(grads, jgrads):
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(g.numpy(), want[name], RTOL, ATOL * scale,
                                   err_msg=name)


# ---- contact helpers, exact -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_dense_contact_helpers_match_jax_exactly(seed):
    pos = _positions(seed, (3, 12, 3))
    tp, jp = torch.as_tensor(pos), jnp.asarray(pos)
    np.testing.assert_array_equal(geo.pairwise_sq_distances(tp).numpy(),
                                  np.asarray(jgeo.pairwise_sq_distances(jp)))
    # the same squares; torch's sqrt is correctly rounded, XLA's CPU sqrt
    # may be one unit in the last place off
    np.testing.assert_allclose(geo.pairwise_distances(tp).numpy(),
                               np.asarray(jgeo.pairwise_distances(jp)),
                               rtol=2.0 ** -23, atol=0)
    np.testing.assert_array_equal(geo.dense_edge_features(tp).numpy(),
                                  np.asarray(jgeo.dense_edge_features(jp)))
    adj = np.array(jgeo.contact_map(jp, 8.0))
    adj[:, 0, 1] = 1.0  # one asymmetric pair: the source axis is -2
    np.testing.assert_array_equal(
        geo.degree_from_adjacency(torch.as_tensor(adj)).numpy(),
        np.asarray(jgeo.degree_from_adjacency(jnp.asarray(adj))))
    isolated = np.zeros((12, 12), np.float32)
    assert geo.degree_from_adjacency(
        torch.as_tensor(isolated)).min().item() == 1.0
    for a in adj:
        edges, mask = geo.dense_to_padded_edges(a, 160)
        jedges, jmask = jgeo.dense_to_padded_edges(a, 160)
        np.testing.assert_array_equal(edges, jedges)
        np.testing.assert_array_equal(mask, jmask)
    with pytest.raises(ValueError, match="exceeds max_edges"):
        geo.dense_to_padded_edges(adj[0], 4)


def test_contact_map_from_edges_matches_jax_exactly():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 9, size=(4, 2, 30)).astype(np.int32)
    edges[:, :, 5] = edges[:, :, 4]  # a repeated edge still reads 1
    mask = (rng.random((4, 30)) < 0.7).astype(np.float32)
    want = jax.vmap(lambda e, m: jgeo.contact_map_from_edges(e, m, 9))(
        jnp.asarray(edges), jnp.asarray(mask))
    got = geo.contact_map_from_edges(torch.as_tensor(edges),
                                     torch.as_tensor(mask), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        geo.contact_map_from_edges(torch.as_tensor(edges[0]),
                                   torch.as_tensor(mask[0]), 9).numpy(),
        np.asarray(want[0]))


# ---- edge_conv_dense --------------------------------------------------------

def _dense_conv_inputs(seed, r=10, w=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(r, w)).astype(np.float32)
    k = rng.normal(size=(r, r, w, w)).astype(np.float32) * 0.3
    adj = (rng.random((r, r)) < 0.4).astype(np.float32)
    conv = {"root": rng.normal(size=(w, w)).astype(np.float32) * 0.3,
            "bias": rng.normal(size=(w,)).astype(np.float32)}
    return x, k, adj, conv


def test_edge_conv_dense_and_its_gradient_match_jax():
    x, k, adj, conv = _dense_conv_inputs(0)

    def jfn(x, k, root):
        masked = k * jnp.asarray(adj)[..., None, None]
        inv = 1.0 / jgeo.degree_from_adjacency(jnp.asarray(adj))
        out = jconv.edge_conv_dense({"root": root, "bias": conv["bias"]},
                                    x, masked, inv)
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(conv["root"]))
    tx, tk, troot = (torch.tensor(a, requires_grad=True)
                     for a in (x, k, conv["root"]))
    tadj = torch.as_tensor(adj)
    inv = 1.0 / geo.degree_from_adjacency(tadj)
    # the model's layout ([j, w, i, v] in memory) and a plain [j, i, w, v]
    # tensor give the same result
    masked = edge_conv.masked_dense_kernels(tk, tadj)
    assert masked.transpose(-3, -2).is_contiguous()
    params = {"root": troot, "bias": torch.as_tensor(conv["bias"])}
    out = edge_conv.edge_conv_dense(params, tx, masked, inv)
    plain = edge_conv.edge_conv_dense(
        params, tx, (tk * tadj[..., None, None]).contiguous(), inv)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               RTOL, ATOL)
    np.testing.assert_allclose(plain.detach().numpy(),
                               out.detach().numpy(), 1e-6, 1e-6)
    torch.sum(out * torch.cos(out)).backward()
    for t, g in zip((tx, tk, troot), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), RTOL,
                                   ATOL)


def test_edge_conv_dense_rounds_at_the_jax_cast_points_in_bf16():
    """bf16 operands, f32 accumulation: the JAX einsum with
    preferred_element_type f32."""
    x, k, adj, conv = _dense_conv_inputs(1)
    masked = k * adj[..., None, None]
    inv = 1.0 / adj.sum(0).clip(1.0)
    want = jconv.edge_conv_dense(
        jax.tree.map(jnp.asarray, conv), jnp.asarray(x),
        jnp.asarray(masked).astype(jnp.bfloat16), jnp.asarray(inv),
        jnp.bfloat16)
    got = edge_conv.edge_conv_dense(
        {n: torch.as_tensor(v) for n, v in conv.items()}, torch.as_tensor(x),
        torch.as_tensor(masked).to(torch.bfloat16), torch.as_tensor(inv),
        torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


# ---- the dense forward and its gradients ------------------------------------

def _dense_batch(jcfg, seed=0, stored=True):
    traj = jax_synthetic_trajectory(num_frames=24, num_residues=12,
                                    seed=seed)
    ds = JaxWindowDataset(traj, window_size=jcfg.window_size,
                          graph_mode="dense", use_native=False,
                          use_stored_contact_maps=stored)
    return ds.get_batch(np.arange(BATCH), rollout_horizon=2)


def _featurized(jcfg, cfg, batch, graph_frame="first"):
    jb = jloop.featurize_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, graph_frame)
    tb = loop.featurize_batch(
        cfg, {k: torch.as_tensor(v) for k, v in batch.items()}, graph_frame)
    return jb, tb


@pytest.mark.parametrize("graph_frame", ["first", "last"])
def test_dense_featurize_batch_matches_jax(graph_frame):
    jcfg, cfg = _cfgs()
    jb, tb = _featurized(jcfg, cfg, _dense_batch(jcfg), graph_frame)
    assert isinstance(tb.graph, gkn.DenseGraph)
    assert isinstance(jb.graph, jgkn.DenseGraph)
    for got, want in zip(tb.graph, jb.graph):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DENSE_OPTS = {
    "tied": dict(),
    "untied": dict(tie_edge_kernel=False),
    "dh": dict(electrostatics="dh"),
    "extrapolate": dict(predict_prior="extrapolate", head_scale=0.3),
}


@pytest.mark.parametrize("opts", list(DENSE_OPTS.values()),
                         ids=list(DENSE_OPTS))
def test_dense_gkn_apply_and_gradients_match_jax(opts):
    jcfg, cfg = _cfgs(**opts)
    jparams = _params(jcfg, 3)
    jb, tb = _featurized(jcfg, cfg, _dense_batch(jcfg, 1))
    want, want_latent = jgkn.gkn_apply(jparams, jcfg, jb, return_latent=True)
    params = params_from_jax(jparams, "cpu")
    with torch.no_grad():
        got, latent = gkn.gkn_apply(params, cfg, tb, return_latent=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent),
                               RTOL, ATOL)
    # one example through gkn_apply_single, as the JAX package's vmap does
    single = gkn.gkn_apply_single(params, cfg, tb.aa, tb.window[2],
                                  gkn.DenseGraph(*(t[2] for t in tb.graph)))
    np.testing.assert_allclose(single.detach().numpy(), np.asarray(want[2]),
                               RTOL, ATOL)
    (want_l2, _), jgrads = jax.value_and_grad(jloop._loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    (l2, _), grads = loop.loss_and_grads(params, cfg, tb)
    np.testing.assert_allclose(float(l2), float(want_l2), rtol=RTOL)
    _assert_grads_close(grads, jgrads)


def test_dense_batches_never_take_the_training_kernel(monkeypatch):
    """The JAX rule: a dense batch takes the per-layer path under
    train_conv_impl="pallas" too, and gives what "xla" gives."""
    _, cfg = _cfgs(train_conv_impl="pallas")
    jcfg, xcfg = _cfgs()
    calls = []
    monkeypatch.setattr(gkn, "train_conv",
                        lambda *a, **k: calls.append(1))
    jparams = _params(jcfg)
    _, tb = _featurized(jcfg, cfg, _dense_batch(jcfg))
    params = params_from_jax(jparams, "cpu")
    assert not gkn.takes_train_kernel(cfg, tb)
    with torch.no_grad():
        a = gkn.gkn_apply(params, cfg, tb)
        b = gkn.gkn_apply(params, xcfg, tb)
    assert not calls and torch.equal(a, b)


def test_dense_and_sparse_graphs_of_one_adjacency_agree():
    """The dense conv over all pairs and the sparse conv over the edge
    list of the same adjacency are the same sums."""
    jcfg, cfg = _cfgs()
    scfg = dataclasses.replace(cfg, graph_mode="sparse")
    params = params_from_jax(_params(jcfg, 5), "cpu")
    batch = {k: torch.as_tensor(v) for k, v in _dense_batch(jcfg).items()}
    edges, mask = zip(*(geo.dense_to_padded_edges(a, 160)
                        for a in batch["adj"].numpy()))
    sparse = dict(batch, edges=torch.as_tensor(np.stack(edges)),
                  mask=torch.as_tensor(np.stack(mask)))
    del sparse["adj"]
    with torch.no_grad():
        d = gkn.gkn_apply(params, cfg, loop.featurize_batch(cfg, batch))
        s = gkn.gkn_apply(params, scfg, loop.featurize_batch(scfg, sparse))
    np.testing.assert_allclose(d.numpy(), s.numpy(), RTOL, ATOL)


# ---- rollout, curriculum, server --------------------------------------------

@pytest.mark.parametrize("collect", ["coords", "both"])
def test_dense_rollout_scan_matches_jax(collect):
    jcfg, cfg = _cfgs()
    jparams = _params(jcfg, 2)
    traj = synthetic_trajectory(num_frames=16, num_residues=12, seed=7)
    window0 = traj.positions[:4]
    aa = traj.aminoacids
    want, wfinal, wdiag = jscan.rollout_scan(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(window0), 6,
        collect=collect, clip=100.0)
    with torch.no_grad():
        got, final, diag = scan.rollout_scan(
            params_from_jax(jparams, "cpu"), cfg, torch.as_tensor(aa),
            torch.as_tensor(window0), 6, collect=collect, clip=100.0)
    if collect == "both":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(wfinal), RTOL, ATOL)
    assert not bool(diag["edge_overflow"]) and not bool(
        wdiag["edge_overflow"])
    assert scan.rebuilt_scatter_hint(cfg, 12) is None


def test_dense_curriculum_step_at_k2_matches_jax():
    jcfg, cfg = _cfgs()
    jparams = _params(jcfg, 4)
    batch = _dense_batch(jcfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opts = dict(return_overflow=True, loss_space="delta", coord_clip=1000.0)
    (jl, (jm, jov)), jgrads = jax.value_and_grad(
        lambda p: jcurriculum.curriculum_loss_batched(
            p, jcfg, jloop.featurize_batch(jcfg, jb), jb["y_seq"], **opts),
        has_aux=True)(jparams)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, (m, ov)), grads = loop.value_and_grad(
        lambda p: curriculum.curriculum_loss_batched(
            p, cfg, loop.featurize_batch(cfg, tb), tb["y_seq"], **opts),
        params_from_jax(jparams, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(m), float(jm), rtol=RTOL)
    assert not bool(ov) and not bool(jov)
    _assert_grads_close(grads, jgrads)


def test_dense_rebuild_train_step_matches_jax():
    """``make_curriculum_train_step(graph_frame="rebuild")``: the teacher
    graph, too, is the dense map of the window's last frame."""
    from molecular_dynamics_neural_operator_tpu.train import (
        create_train_state as jax_create_train_state,
    )
    from molecular_dynamics_neural_operator_tpu.configs import (
        TrainConfig as JaxTrainConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        TrainConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
    )

    jcfg, cfg = _cfgs()
    tcfg = dict(lr=1e-3, seed=0)
    jstate, jtx, _ = jax_create_train_state(
        jax.random.PRNGKey(0), jcfg, JaxTrainConfig(**tcfg))
    state, tx, _ = create_train_state(
        0, cfg, TrainConfig(**tcfg), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               "cpu"))
    batch = _dense_batch(jcfg, 3)
    jstep = jcurriculum.make_curriculum_train_step(
        jcfg, jtx, rollout_steps=2, graph_frame="rebuild")
    step = curriculum.make_curriculum_train_step(
        cfg, tx, rollout_steps=2, graph_frame="rebuild")
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["rel_l2"]), float(jm["rel_l2"]),
                               rtol=RTOL)
    want = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
    for name, p in _flat(state.params):
        np.testing.assert_allclose(p.numpy(), want[name], RTOL, ATOL,
                                   err_msg=name)


def test_a_dense_served_request_matches_a_dedicated_rollout_and_jax():
    jcfg, cfg = _cfgs(width=8, ker_width=16, depth=1)
    jparams = _params(jcfg, 6)
    params = params_from_jax(jparams, "cpu")
    traj = synthetic_trajectory(num_frames=40, num_residues=12, seed=9)
    aa, w0 = traj.aminoacids, traj.positions[5:9]
    srv = RolloutServer(params, cfg, segment_steps=4, max_streams=2,
                        device="cpu")
    ok = False
    try:
        res = srv.rollout(aa, w0, 6, timeout=WAIT)
        ok = True
    finally:
        srv.close(drain=ok, timeout=WAIT)
    with torch.no_grad():
        direct, _, _ = scan.rollout_scan(params, cfg, torch.as_tensor(aa),
                                         torch.as_tensor(w0), 6)
    want, _, _ = jscan.rollout_scan(jparams, jcfg, jnp.asarray(aa),
                                    jnp.asarray(w0), 6)
    assert res.coords.shape == (6, 12, 3) and not res.edge_overflow
    np.testing.assert_allclose(res.coords, direct.numpy(), 1e-4, 1e-5)
    np.testing.assert_allclose(res.coords, np.asarray(want), RTOL, ATOL)


# ---- both CLIs with their default graph flags -------------------------------

CLI_ARGS = ["--epochs", "1", "--batch_size", "16", "--lr", "1e-3",
            "--window_size", "4", "--num_residues", "28",
            "--compute_dtype", "float32", "--width", "8",
            "--kernel_width", "16", "--depth", "1", "--predict_delta",
            "--latent_frames", "16", "--num_movie_frames", "3"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both packages' train CLI, then rollout CLI, with the default
    ``--graph_mode`` (dense): {"train": (jax dir, port dir), "rollout":
    (jax dir, port dir)}. The port starts from the JAX run's initial
    weights through ``--resume``."""
    from molecular_dynamics_neural_operator_tpu.train import (
        create_train_state as jax_create_train_state,
    )
    from molecular_dynamics_neural_operator_tpu.utils import (
        checkpoint as jcheckpoint,
    )

    base = tmp_path_factory.mktemp("dense_cli")
    h5 = base / "traj.h5"
    write_synthetic_h5(h5, num_frames=120, num_residues=28, seed=13)
    argv = ["--data_path", str(h5)] + CLI_ARGS
    model, _, train = jtrain.build_configs(jtrain.parse_args(
        argv + ["--run_path", str(base / "x")]))
    assert model.graph_mode == "dense"
    state, _, _ = jax_create_train_state(jax.random.PRNGKey(0), model, train)
    init = base / "init.npz"
    jcheckpoint.save_checkpoint(init, state, {"epoch": -1})
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        jdir, pdir = base / "train_jax", base / "train_port"
        jtrain.main(argv + ["--run_path", str(jdir), "--resume", str(init)])
        ptrain.main(argv + ["--run_path", str(pdir), "--resume", str(init),
                            "--device", "cpu"])
        runs["train"] = (jdir, pdir)
        roll = ["--data_path", str(h5), "--num_steps", "5", "--width", "8",
                "--kernel_width", "16", "--depth", "1", "--window_size",
                "4", "--predict_delta", "--compute_dtype", "float32"]
        jout, pout = base / "roll_jax", base / "roll_port"
        jrollout.main(roll + ["--checkpoint", str(jdir / "best.npz"),
                              "--out_path", str(jout)])
        prollout.main(roll + ["--checkpoint", str(jdir / "best.npz"),
                              "--out_path", str(pout), "--device", "cpu"])
        runs["rollout"] = (jout, pout)
    return runs


def test_the_train_cli_trains_the_dense_default_as_jax_does(cli_runs):
    jdir, pdir = cli_runs["train"]
    want = json.loads((jdir / "metrics.jsonl").read_text().splitlines()[-1])
    got = json.loads((pdir / "metrics.jsonl").read_text().splitlines()[-1])
    for key in ("avg_train_loss", "avg_valid_loss", "avg_train_mse",
                "avg_valid_mse"):
        np.testing.assert_allclose(got[key], want[key], RTOL, err_msg=key)
    cfg = json.loads((pdir / "config.json").read_text())["model"]
    assert cfg["graph_mode"] == "dense" and cfg["train_conv_impl"] == "xla"
    with np.load(jdir / "best.npz") as j, np.load(pdir / "best.npz") as p:
        for key in j.files:
            if key.startswith(".params/"):
                np.testing.assert_allclose(p[key], j[key], RTOL, ATOL,
                                           err_msg=key)


def test_the_rollout_cli_rolls_the_dense_default_out_as_jax_does(cli_runs):
    jout, pout = cli_runs["rollout"]
    np.testing.assert_allclose(np.load(pout / "forecast_coords.npy"),
                               np.load(jout / "forecast_coords.npy"),
                               RTOL, ATOL)
    np.testing.assert_allclose(np.load(pout / "per_step_mse.npy"),
                               np.load(jout / "per_step_mse.npy"), RTOL)


def test_window_dataset_dense_batches_match_jax():
    traj = synthetic_trajectory(num_frames=30, num_residues=12, seed=8)
    jtraj = jax_synthetic_trajectory(num_frames=30, num_residues=12, seed=8)
    idx = np.array([0, 3, 7, 11])
    for stored in (True, False):
        got = WindowDataset(traj, window_size=4, graph_mode="dense",
                            use_stored_contact_maps=stored).get_batch(idx)
        want = JaxWindowDataset(jtraj, window_size=4, graph_mode="dense",
                                use_native=False,
                                use_stored_contact_maps=stored
                                ).get_batch(idx)
        assert set(got) == set(want) == {"aa", "window", "y", "adj"}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
