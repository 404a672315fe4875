"""The port's parallel modules (``parallel/*``, the mesh server, the CLIs'
data-parallel entry points) against the JAX package's on its CPU mesh.

The port runs on 4 gloo CPU ranks (``test_torch_port_parallel_ranks``,
spawned three times: training, rollout and serving, the train CLI), the
JAX package on 4 of the 8 virtual CPU devices (``tests/conftest.py``),
from the same seeded numpy inputs and the same weights. Each case also
holds the port's sharded result against the port's own single-process
result on the whole batch. Tolerances: f32, rtol 2e-4 and atol 1e-5
(the port's tests' standard) unless a case says otherwise.

Random input noise is drawn by another generator in each package
(``train/noise.py``), so the noised cases are held against the port's
single-process step alone, there to the bit for the noised window and
within the f32 tolerance for what follows.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from molecular_dynamics_neural_operator_tpu import configs as jconfigs
from molecular_dynamics_neural_operator_tpu.cli import train as jtrain
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset,
    synthetic_trajectory,
    write_synthetic_h5,
)
from molecular_dynamics_neural_operator_tpu.geometry import (
    contact_map,
    dense_to_padded_edges,
    edge_features_from_edges,
)
from molecular_dynamics_neural_operator_tpu.models import (
    GKNBatch,
    SparseGraph,
    gkn_apply,
    gkn_init,
)
from molecular_dynamics_neural_operator_tpu.models import fno as jfno
from molecular_dynamics_neural_operator_tpu.parallel import (
    make_edge_sharded_rollout_fn,
    make_mesh,
    make_sharded_curriculum_train_step,
    make_sharded_rollout_fn,
    make_sharded_train_step,
)
from molecular_dynamics_neural_operator_tpu.parallel.edge_sharded import (
    make_edge_sharded_forward,
    make_edge_sharded_train_step,
)
from molecular_dynamics_neural_operator_tpu.rollout import rollout_scan
from molecular_dynamics_neural_operator_tpu.train import create_train_state
from molecular_dynamics_neural_operator_tpu.train import optim as joptim
from molecular_dynamics_neural_operator_tpu.train.curriculum import (
    curriculum_loss_batched,
)
from molecular_dynamics_neural_operator_tpu.train.loop import (
    _loss_fn,
    featurize_batch,
)
from molecular_dynamics_neural_operator_tpu.train.state import (
    TrainState as JaxTrainState,
)
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jcheckpoint,
)

import test_torch_port_parallel_ranks as ranks
from test_torch_port_parallel_ranks import (
    CELLS,
    CURRICULUM_CASES,
    EDGE_FORWARD_CASES,
    SERVE,
    SPARSE,
    TEACHER_CASES,
    TRAIN,
    WORLD,
)

RTOL, ATOL = 2e-4, 1e-5
# seconds a spawn of ranks may take before every rank is ended
TRAIN_TIMEOUT = ROLL_TIMEOUT = CLI_TIMEOUT = 120


def _jmesh(data, model):
    return make_mesh(jconfigs.MeshConfig(data=data, model=model),
                     devices=jax.devices()[:data * model])


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _save_params(path, params):
    np.savez(path, **_flat(params))


def _close(got: dict, want: dict, what: str, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol, atol,
                                   err_msg=f"{what} {k}")


def _close_grads(got: dict, want: dict, what: str):
    """Gradient leaves: rtol 2e-4 and atol 1e-5 of the leaf's largest
    magnitude where that exceeds 1. An f32 gradient element is a sum of
    terms of about the leaf's scale, so its rounding error is relative to
    that scale and not to the element; the delta loss's floored
    denominators make leaves of several hundred."""
    assert set(got) == set(want), what
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], RTOL, ATOL * scale,
                                   err_msg=f"{what} {k}")


def _part(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def _sparse_batch(cfg, b=8, seed=1):
    rng = np.random.default_rng(seed)
    r, t = cfg.num_residues, cfg.window_size
    pos = (rng.normal(size=(b, t, r, 3)) * 4).astype(np.float32)
    adj = np.asarray(contact_map(jnp.asarray(pos[:, 0]), 8.0))
    edges = np.zeros((b, 2, cfg.max_edges), np.int32)
    mask = np.zeros((b, cfg.max_edges), np.float32)
    for i in range(b):
        e, m = dense_to_padded_edges(adj[i], cfg.max_edges)
        edges[i], mask[i] = np.asarray(e), np.asarray(m)
    ef = np.asarray(jax.vmap(edge_features_from_edges)(
        jnp.asarray(pos[:, 0]), jnp.asarray(edges)))
    return {"aa": (np.arange(r) % 20).astype(np.int32), "window": pos,
            "y": rng.normal(size=(b, r, 3)).astype(np.float32),
            "edges": edges, "mask": mask, "edge_feats": ef}


def _jcfg(**kw):
    return jconfigs.ModelConfig(**kw)


# ---- training, rollout and serving ranks -----------------------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Every case's inputs and weights, written once for the ranks."""
    d = tmp_path_factory.mktemp("ranks")
    cfg = _jcfg(**SPARSE)
    _save_params(d / "sparse.params.npz", gkn_init(jax.random.PRNGKey(0),
                                                   cfg))
    batch = _sparse_batch(cfg)
    np.savez(d / "teacher.in.npz",
             **{k: v for k, v in batch.items() if k != "edge_feats"})
    np.savez(d / "edge.in.npz", **batch)
    for name, opts in EDGE_FORWARD_CASES.items():
        _save_params(d / f"edge_{name}.params.npz", gkn_init(
            jax.random.PRNGKey(2), _jcfg(**{**SPARSE, **opts})))
    traj = synthetic_trajectory(num_frames=32, num_residues=12, seed=7)
    for name, mopts, _, _, k, _ in CURRICULUM_CASES:
        mode = mopts.get("graph_mode", "sparse")
        ds = WindowDataset(traj, window_size=4, graph_mode=mode,
                           max_edges=cfg.max_edges)
        batch = ds.get_batch(np.arange(8), rollout_horizon=k)
        if name == "delta_floor":
            # the first rank's two examples move 1e-3 as far
            last = batch["window"][:2, -1:]
            batch["y_seq"][:2] = last + 1e-3 * (batch["y_seq"][:2] - last)
        np.savez(d / f"curriculum_{name}.in.npz", **batch)

    rng = np.random.default_rng(3)
    pd = _jcfg(**SPARSE, predict_delta=True)
    _save_params(d / "rollout.params.npz", gkn_init(jax.random.PRNGKey(0), pd))
    np.savez(d / "rollout.in.npz", aa=batch["aa"], window0=(
        rng.normal(size=(8, 4, 12, 3)) * 4).astype(np.float32))
    for name, opts, key in (("ranked", {**SPARSE, "predict_delta": True}, 0),
                            ("cells", CELLS, 1),
                            ("cells_replicated",
                             {**CELLS, "num_residues": 18,
                              "max_edges": 18 * 16}, 1)):
        c = _jcfg(**opts)
        _save_params(d / f"edge_roll_{name}.params.npz",
                     gkn_init(jax.random.PRNGKey(key), c))
        n = c.num_residues
        np.savez(d / f"edge_roll_{name}.in.npz",
                 aa=(np.arange(n) % 20).astype(np.int32),
                 window0=(rng.normal(size=(c.window_size, n, 3))
                          * 4).astype(np.float32))

    scfg = _jcfg(**SERVE)
    _save_params(d / "serve.params.npz", gkn_init(jax.random.PRNGKey(0),
                                                  scfg))
    straj = synthetic_trajectory(num_frames=64, num_residues=10, seed=5)
    srng = np.random.default_rng(7)
    np.savez(d / "server.in.npz",
             aa=srng.integers(0, 20, size=(6, 10)).astype(np.int32),
             window=np.stack([straj.positions[i:i + 4] for i in range(6)]
                             ).astype(np.float32),
             steps=np.asarray([3 + 2 * i for i in range(6)]))
    return d


@pytest.fixture(scope="module")
def train_ranks(workdir):
    ranks.run_ranks(workdir, ["mesh", "teacher", "curriculum",
                              "edge_sharded"], timeout=TRAIN_TIMEOUT)
    return workdir


@pytest.fixture(scope="module")
def roll_ranks(workdir):
    ranks.run_ranks(workdir, ["rollout_sharded", "rollout_edge_sharded",
                              "server", "serve_cli"], timeout=ROLL_TIMEOUT)
    return workdir


def _load(workdir, name):
    with np.load(workdir / f"{name}.in.npz") as f:
        return {k: f[k] for k in f.files}


def _jparams(workdir, name):
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    return jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                        load_params_npz(workdir / f"{name}.params.npz",
                                        "cpu"))


# ---- the mesh ---------------------------------------------------------------

def test_make_mesh_autofill_and_refusal_match_jax(train_ranks):
    out = ranks.outputs(train_ranks, "mesh")
    devices = jax.devices()[:WORLD]
    for name, mcfg in (("default", jconfigs.MeshConfig()),
                       ("model2", jconfigs.MeshConfig(data=2, model=2)),
                       ("model2_autofill", jconfigs.MeshConfig(data=1,
                                                               model=2)),
                       ("model4", jconfigs.MeshConfig(data=1, model=4))):
        jm = make_mesh(mcfg, devices=devices)
        assert tuple(out[name]) == (jm.shape["data"], jm.shape["model"])
        assert tuple(out[f"{name}_coord"]) == (0, 0)  # rank 0's
    with pytest.raises(ValueError, match="model axis") as jerr:
        make_mesh(jconfigs.MeshConfig(data=2, model=3), devices=devices)
    assert str(out["error"]) == str(jerr.value)


# ---- data-parallel teacher step --------------------------------------------

def _jax_teacher(jcfg, params, batch):
    """(grads, metrics, params after one Adam step): the gradient of the
    global batch on one device, the step on the 4-device mesh."""
    gb = featurize_batch(jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    (l2, (m, _)), grads = jax.jit(jax.value_and_grad(
        lambda p: _loss_fn(p, jcfg, gb), has_aux=True))(params)
    state, tx, _ = create_train_state(jax.random.PRNGKey(0), jcfg,
                                      jconfigs.TrainConfig(**TRAIN))
    state = state._replace(params=params)
    step, put = make_sharded_train_step(jcfg, tx, _jmesh(WORLD, 1))
    new, metrics = step(state, put(batch))
    assert float(metrics["rel_l2"]) == pytest.approx(float(l2), rel=1e-5)
    return _flat(grads), {"rel_l2": l2, "mse": m}, _flat(new.params)


@pytest.mark.parametrize("case", [c[0] for c in TEACHER_CASES])
def test_data_parallel_teacher_step(case, train_ranks):
    """Loss, every gradient leaf and the parameters after one Adam step:
    the sharded step against the port's single-process step on the whole
    batch and, without noise, against the JAX package's. The gradient is
    that of the GLOBAL batch, not 1/world of it."""
    out = ranks.outputs(train_ranks, "teacher")
    sh, single = _part(out, f"{case}/sharded/"), _part(out, f"{case}/single/")
    _close_grads(_part(sh, "grad/"), _part(single, "grad/"), "grad")
    _close(_part(sh, "params/"), _part(single, "params/"), "params")
    _close(_part(sh, "metric/"), _part(single, "metric/"), "metric")
    grads = _part(sh, "grad/")
    # not the mean over ranks: the sharded gradient is the single one
    g, g1 = grads["fc2/w"], _part(single, "grad/")["fc2/w"]
    assert np.linalg.norm(g - g1) < 1e-3 * np.linalg.norm(g1)
    if "noise" in case:
        return
    mopts = {c[0]: c[1] for c in TEACHER_CASES}[case]
    jcfg = _jcfg(**{**SPARSE, **mopts})
    batch = {k: v for k, v in _load(train_ranks, "teacher").items()}
    jgrads, jmetrics, jnew = _jax_teacher(
        jcfg, _jparams(train_ranks, "sparse"), batch)
    _close_grads(grads, jgrads, "grad vs jax")
    _close(_part(sh, "params/"), jnew, "params vs jax")
    _close(_part(sh, "metric/"), {k: np.asarray(v)
                                  for k, v in jmetrics.items()}, "metric")


# ---- data-parallel curriculum ----------------------------------------------

@pytest.mark.parametrize("case", [c[0] for c in CURRICULUM_CASES])
def test_data_parallel_curriculum_step(case, train_ranks):
    """The K-step curriculum sharded over 4 ranks: absolute and delta
    losses, ``grad_steps``, both conv paths, against the single-process
    step and the JAX package's (the delta floor pools over the global
    batch)."""
    name, mopts, topts, sopts, k, noise = {c[0]: c for c in
                                           CURRICULUM_CASES}[case]
    out = ranks.outputs(train_ranks, "curriculum")
    sh, single = _part(out, f"{case}/sharded/"), _part(out, f"{case}/single/")
    _close_grads(_part(sh, "grad/"), _part(single, "grad/"), "grad")
    _close(_part(sh, "params/"), _part(single, "params/"), "params")
    for key in ("rel_l2", "mse", "edge_overflow"):
        np.testing.assert_allclose(sh[f"metric/{key}"],
                                   single[f"metric/{key}"], RTOL, ATOL)
    if noise:
        return
    jcfg = _jcfg(**{**SPARSE, **mopts})
    batch = _load(train_ranks, f"curriculum_{name}")
    params = _jparams(train_ranks, "sparse")
    gb = featurize_batch(jcfg, {kk: jnp.asarray(v) for kk, v in batch.items()})
    (l2, m), grads = jax.jit(jax.value_and_grad(
        lambda p: curriculum_loss_batched(
            p, jcfg, gb, jnp.asarray(batch["y_seq"]), 8.0, None,
            sopts.get("coord_clip"), loss_space=sopts.get("loss_space",
                                                          "absolute"),
            grad_steps=sopts.get("grad_steps")), has_aux=True))(params)
    _close_grads(_part(sh, "grad/"), _flat(grads), "grad vs jax")
    np.testing.assert_allclose(sh["metric/rel_l2"], float(l2), RTOL, ATOL)
    np.testing.assert_allclose(sh["metric/mse"], float(m), RTOL, ATOL)
    if case != "pallas_delta":
        # one compile of the JAX sharded step is enough: the JAX package
        # holds that step to its single-device step in each of these
        # cases (tests/test_parallel.py), and the port's Adam step to the
        # same gradients is held above against the port's single process
        return
    state, tx, _ = create_train_state(
        jax.random.PRNGKey(0), jcfg,
        jconfigs.TrainConfig(**TRAIN, **topts, rollout_steps=k))
    step, put = make_sharded_curriculum_train_step(
        jcfg, tx, _jmesh(WORLD, 1), rollout_steps=k, **sopts)
    new, _ = step(state._replace(params=params), put(batch))
    _close(_part(sh, "params/"), _flat(new.params), "params vs jax")


# ---- edge-sharded forward and train step -----------------------------------

@pytest.mark.parametrize("case", sorted(EDGE_FORWARD_CASES))
def test_edge_sharded_forward(case, train_ranks):
    """2 x 2 mesh: the batch over "data", the edges over "model". The
    port's forward equals its ``gkn_apply`` and the JAX ``gkn_apply``
    (and, where the JAX package applies it, its edge-sharded forward:
    ``head_scale`` is the one option JAX's shard forward leaves out)."""
    out = ranks.outputs(train_ranks, "edge_sharded")
    got = out[f"forward/{case}"]
    np.testing.assert_allclose(got, out[f"single/{case}"], RTOL, ATOL)
    jcfg = _jcfg(**{**SPARSE, **EDGE_FORWARD_CASES[case]})
    b = {k: jnp.asarray(v) for k, v in _load(train_ranks, "edge").items()}
    params = _jparams(train_ranks, f"edge_{case}")
    ref = gkn_apply(params, jcfg, GKNBatch(
        b["aa"], b["window"], SparseGraph(b["edges"], b["mask"],
                                          b["edge_feats"]), b["y"]))
    np.testing.assert_allclose(got, np.asarray(ref), RTOL, ATOL)
    jout = jax.jit(make_edge_sharded_forward(jcfg, _jmesh(2, 2)))(
        params, b["aa"], b["window"], b["edges"], b["mask"], b["edge_feats"])
    if case == "head_scale":
        assert not np.allclose(np.asarray(jout), got, RTOL, ATOL)
    else:
        np.testing.assert_allclose(got, np.asarray(jout), RTOL, ATOL)


def test_edge_sharded_train_step(train_ranks):
    """Gradients through the conjugate collectives equal the
    single-process gradient (not 'model'-size times it), the loss and the
    parameters after one Adam step equal the JAX package's edge-sharded
    step's."""
    out = ranks.outputs(train_ranks, "edge_sharded")
    grads, single = _part(out, "train/grad/"), _part(out, "single_grad/")
    _close_grads(grads, single, "grad vs single process")
    ratio = np.linalg.norm(grads["edge_kernel/layer_0/w"]) / np.linalg.norm(
        single["edge_kernel/layer_0/w"])
    assert abs(ratio - 1) < 1e-4
    jcfg = _jcfg(**SPARSE, predict_delta=True)
    b = {k: jnp.asarray(v) for k, v in _load(train_ranks, "edge").items()}
    params = _jparams(train_ranks, "edge_predict_delta")
    state, tx, _ = create_train_state(jax.random.PRNGKey(0), jcfg,
                                      jconfigs.TrainConfig(**TRAIN))
    step = make_edge_sharded_train_step(jcfg, tx, _jmesh(2, 2))
    new, m = step(state._replace(params=params), b["aa"], b["window"],
                  b["edges"], b["mask"], b["edge_feats"], b["y"])
    np.testing.assert_allclose(out["train/metric/rel_l2"],
                               float(m["rel_l2"]), RTOL, ATOL)
    np.testing.assert_allclose(out["train/metric/mse"], float(m["mse"]),
                               RTOL, ATOL)
    _close(_part(out, "train/params/"), _flat(new.params), "params vs jax")


# ---- rollouts ---------------------------------------------------------------

def test_sharded_rollout(roll_ranks):
    """Streams over "data" (4 x 1, then 2 x 2 with ``stream_chunk=1``)
    against the JAX sharded rollout and the port's batched rollout; each
    rank holds its share of the streams."""
    out = ranks.outputs(roll_ranks, "rollout_sharded")
    inp = _load(roll_ranks, "rollout")
    jcfg = _jcfg(**SPARSE, predict_delta=True)
    params = _jparams(roll_ranks, "rollout")
    for name, (data, model), steps, chunk in (("data4", (4, 1), 6, None),
                                              ("chunked", (2, 2), 5, 1)):
        assert int(out[f"{name}/local_streams"]) == 8 // data
        roll = make_sharded_rollout_fn(jcfg, _jmesh(data, model), steps,
                                       stream_chunk=chunk)
        c, f, d = roll(params, jnp.asarray(inp["aa"]),
                       jnp.asarray(inp["window0"]))
        for what, want in (("coords", c), ("final", f)):
            np.testing.assert_allclose(out[f"{name}/{what}"],
                                       np.asarray(want), RTOL, ATOL)
        np.testing.assert_allclose(out[f"{name}/coords"],
                                   out[f"{name}/single_coords"], RTOL, ATOL)
        assert bool(out[f"{name}/overflow"]) == bool(d["edge_overflow"])
    assert "not divisible by the 'data' axis size 4" in str(
        out["error_streams"])
    assert "not divisible by stream_chunk 3" in str(out["error_chunk"])


def test_edge_sharded_rollout(roll_ranks):
    """One stream with its edges over 4 "model" ranks: the ranked
    rebuild sliced, the cell list rebuilt by atom slice (16 atoms) and
    rebuilt whole where the atoms do not divide (18), against the JAX
    edge-sharded rollout and the port's own rollout; then the three
    refusals."""
    out = ranks.outputs(roll_ranks, "rollout_edge_sharded")
    mesh = _jmesh(1, WORLD)
    for name, opts, steps in (
            ("ranked", {**SPARSE, "predict_delta": True}, 5),
            ("cells", CELLS, 4),
            ("cells_replicated", {**CELLS, "num_residues": 18,
                                  "max_edges": 18 * 16}, 4)):
        inp = _load(roll_ranks, f"edge_roll_{name}")
        params = _jparams(roll_ranks, f"edge_roll_{name}")
        c, f, d = make_edge_sharded_rollout_fn(_jcfg(**opts), mesh, steps)(
            params, jnp.asarray(inp["aa"]), jnp.asarray(inp["window0"]))
        np.testing.assert_allclose(out[f"{name}/coords"], np.asarray(c),
                                   RTOL, ATOL, err_msg=name)
        np.testing.assert_allclose(out[f"{name}/final"], np.asarray(f),
                                   RTOL, ATOL, err_msg=name)
        np.testing.assert_allclose(out[f"{name}/coords"],
                                   out[f"{name}/single_coords"], RTOL, ATOL,
                                   err_msg=name)
        assert bool(out[f"{name}/overflow"]) == bool(d["edge_overflow"])
    assert "requires graph_mode='sparse'" in str(out["error_dense"])
    assert "max_edges 130 must divide by the 'model' axis size 4" in str(
        out["error_divide"])
    assert "max_edges == num_atoms * max_degree" in str(out["error_cells"])


# ---- serving ----------------------------------------------------------------

def _direct(workdir, i, n=None):
    inp = _load(workdir, "server")
    params = _jparams(workdir, "serve")
    coords, _, _ = rollout_scan(params, _jcfg(**SERVE),
                                jnp.asarray(inp["aa"][i]),
                                jnp.asarray(inp["window"][i]),
                                int(inp["steps"][i]) if n is None else n)
    return np.asarray(coords)


def test_mesh_server_matches_dedicated_rollouts(roll_ranks):
    """Six requests (own sequences, mixed lengths) through a server whose
    streams spread over 4 ranks, each against a JAX dedicated rollout;
    padded counts are multiples of the mesh, as in JAX."""
    out = ranks.outputs(roll_ranks, "server")
    for i in range(6):
        np.testing.assert_allclose(out[f"coords{i}"], _direct(roll_ranks, i),
                                   1e-4, 1e-5)  # the JAX server's tolerance
        assert not bool(out[f"overflow{i}"])
    assert int(out["stats/requests_completed"]) == 6
    assert int(out["stats/steps_computed"]) % WORLD == 0


def test_mesh_server_refusals(roll_ranks):
    out = ranks.outputs(roll_ranks, "server")
    assert "max_streams 6 must be divisible by the 'data' axis size 4" in \
        str(out["error_divisible"])
    assert "mesh sharding applies to impl='scan'" in str(out["error_impl"])


def test_serve_cli_data_mesh_serves_over_its_socket(roll_ranks):
    out = ranks.outputs(roll_ranks, "serve_cli")
    for i in range(3):
        np.testing.assert_allclose(out[f"coords{i}"], _direct(roll_ranks, i),
                                   1e-4, 1e-5)
    assert int(out["segments_run"]) > 0


# ---- cli.train --data_parallel ----------------------------------------------

CLI_ARGS = ["--epochs", "1", "--batch_size", "16", "--lr", "1e-3",
            "--window_size", "4", "--num_residues", "28", "--latent_frames",
            "16", "--num_movie_frames", "3"]
GKN_ARGS = ["--compute_dtype", "float32", "--width", "8", "--kernel_width",
            "16", "--depth", "1", "--graph_mode", "sparse", "--max_edges",
            "224", "--predict_delta"]
FNO_ARGS = ["--operator", "fno", "--fno_width", "8", "--fno_modes", "6",
            "--fno_depth", "2", "--fno_predict_delta", "--head_scale", "0.1"]
CLI_CASES = {"teacher": GKN_ARGS,
             "curriculum": GKN_ARGS + ["--rollout_steps", "2",
                                       "--loss_space", "delta"],
             "fno": FNO_ARGS}


def _cli_init(argv, path, fno: bool):
    """A JAX TrainState for the chain ``argv`` builds, saved as epoch -1."""
    args = jtrain.parse_args(argv)
    if fno:
        _, _, tcfg = jtrain.build_configs(args)
        jcfg = jconfigs.FNOConfig(width=8, modes1=6, modes2=6, depth=2,
                                  in_channels=4, num_residues=28,
                                  predict_delta=True, head_scale=0.1)
        tx, _ = joptim.make_optimizer(
            tcfg.lr, grad_clip_norm=tcfg.grad_clip_norm,
            skip_nonfinite_updates=tcfg.skip_nonfinite_updates)
        params = jfno.fno_init(jax.random.PRNGKey(5), jcfg)
        state = JaxTrainState(params, tx.init(params),
                              jnp.zeros((), jnp.int32), jax.random.PRNGKey(0))
    else:
        model, _, tcfg = jtrain.build_configs(args)
        state, _, _ = create_train_state(jax.random.PRNGKey(tcfg.seed), model,
                                         tcfg)
    jcheckpoint.save_checkpoint(path, state, {"epoch": -1})


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """{case: (jax run dir, port run dir)}: the JAX CLI with
    ``--data_parallel`` on 8 CPU devices, the port's on 4 gloo ranks, from
    the same JAX TrainState (``--resume``)."""
    base = tmp_path_factory.mktemp("cli")
    h5 = base / "traj.h5"
    write_synthetic_h5(h5, num_frames=120, num_residues=28, seed=13)
    spec, runs = {}, {}
    for case, extra in CLI_CASES.items():
        argv = ["--data_path", str(h5)] + CLI_ARGS + extra
        init = base / f"{case}_init.npz"
        _cli_init(argv + ["--run_path", str(base / "x")], init,
                  case == "fno")
        argv += ["--resume", str(init)]
        jdir, pdir = base / f"{case}_jax", base / f"{case}_port"
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "matplotlib", None)
            jtrain.main(argv + ["--run_path", str(jdir), "--data_parallel"])
        spec[case] = argv + ["--run_path", str(pdir)]
        runs[case] = (jdir, pdir)
    (base / "train_cli.json").write_text(json.dumps(spec))
    ranks.run_ranks(base, ["train_cli"], timeout=CLI_TIMEOUT)
    ranks.outputs(base, "train_cli")
    return runs


def _metrics(run):
    return [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_train_cli_data_parallel_matches_jax(case, cli_runs):
    """The epoch's losses, the run directory's files (written once, by
    rank 0) and ``last.npz`` against the JAX CLI's data-parallel run."""
    jdir, pdir = cli_runs[case]
    want, got = _metrics(jdir), _metrics(pdir)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [0]
    for k in ("avg_train_loss", "avg_valid_loss"):
        np.testing.assert_allclose(got[0][k], want[0][k], RTOL, ATOL,
                                   err_msg=k)
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    with np.load(jdir / "last.npz") as j, np.load(pdir / "last.npz") as p:
        assert set(p.files) == set(j.files)
        for k in j.files:
            if k == ".rng":
                continue
            if j[k].dtype == np.float32:
                np.testing.assert_allclose(p[k], j[k], RTOL, ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
