"""The port's data and checkpoint surface against the JAX package on the
CPU: HDF5 ingestion (every drift case of ``test_h5_robustness.py``
through both packages' ``load_trajectory`` on the same file), the HDF5
writers, the configurations and their JSON, the presets, TrainState
checkpoints under each optimizer chain in both directions, and
``BestCheckpointer``."""

import dataclasses
import json
import warnings

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import configs as jconfigs
from molecular_dynamics_neural_operator_tpu import data as jdata
from molecular_dynamics_neural_operator_tpu import presets as jpresets
from molecular_dynamics_neural_operator_tpu.train import (
    create_train_state as jax_create_train_state,
)
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jcheckpoint,
)
from molecular_dynamics_neural_operator_tpu_torch import configs, presets
from molecular_dynamics_neural_operator_tpu_torch import data as pdata
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import checkpoint
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

RTOL, ATOL = 2e-4, 1e-5


# ---- HDF5: the robustness battery through both loaders --------------------

def _write(path, num_frames=24, num_residues=10, seed=3, **mutate):
    """A reference-schema file from the port's writer, then selected
    datasets overwritten (None deletes one)."""
    traj = pdata.write_synthetic_h5(path, num_frames=num_frames,
                                    num_residues=num_residues, seed=seed)
    with h5py.File(path, "a") as f:
        for name, value in mutate.items():
            if name in f:
                del f[name]
            if value is None:
                continue
            if name == "contact_map":
                cm = f.create_dataset(name, (len(value),),
                                      dtype=h5py.vlen_dtype(np.int32))
                cm[:] = value
            else:
                f.create_dataset(name, data=value)
    return traj


def _rows(traj):
    return [e.reshape(-1) for e in traj.edge_indices]


def _case_nr3(tmp):
    p = tmp / "t.h5"
    traj = _write(p)
    with h5py.File(p, "a") as f:
        pc = np.transpose(np.asarray(f["point_cloud"]), (0, 2, 1))
        del f["point_cloud"]
        f.create_dataset("point_cloud", data=pc)
    return p


def _case_labels(labels):
    def case(tmp):
        _write(tmp / "t.h5", amino_acids=labels)
        return tmp / "t.h5"
    return case


def _onehot():
    labels = np.array([0, 5, 19, 3, 3, 7, 1, 2, 4, 6])
    out = np.zeros((10, 20), np.float64)
    out[np.arange(10), labels] = 1.0
    return out


def _case_missing_rmsd(tmp):
    _write(tmp / "t.h5", rmsd=None)
    return tmp / "t.h5"


def _case_float64(tmp):
    p = tmp / "t.h5"
    _write(p)
    with h5py.File(p, "a") as f:
        for name in ("point_cloud", "rmsd"):
            v = np.asarray(f[name]).astype(np.float64)
            del f[name]
            f.create_dataset(name, data=v)
    return p


def _case_odd_row(tmp):
    p = tmp / "t.h5"
    rows = _rows(_write(p))
    rows[7] = rows[7][:-1]
    _write(p, contact_map=rows)
    return p


def _case_bad_edge(tmp):
    p = tmp / "t.h5"
    rows = _rows(_write(p))
    rows[3] = rows[3].copy()
    rows[3][0] = 99
    _write(p, contact_map=rows)
    return p


def _case_dir_mismatch(tmp):
    pdata.write_synthetic_h5(tmp / "a.h5", num_frames=8, num_residues=10,
                             seed=1)
    pdata.write_synthetic_h5(tmp / "b.h5", num_frames=8, num_residues=12,
                             seed=2)
    return tmp


def _case_dir_frames(tmp):
    pdata.write_synthetic_h5(tmp / "a.h5", num_frames=16, num_residues=10,
                             seed=1)
    pdata.write_synthetic_h5(tmp / "b.h5", num_frames=5, num_residues=10,
                             seed=2)
    return tmp


def _case_no_self_loops(tmp):
    p = tmp / "t.h5"
    traj = _write(p)
    _write(p, contact_map=[e[:, e[0] != e[1]].reshape(-1)
                           for e in traj.edge_indices])
    return p


def _case_drifted(tmp):
    clean = tmp / "clean.h5"
    traj = pdata.write_synthetic_h5(clean, num_frames=24, num_residues=10,
                                    seed=3)
    with h5py.File(clean) as f:
        pc = np.asarray(f["point_cloud"])
    aa1b = (traj.aminoacids % 20).astype(np.int64) + 1
    aa1b[0] = 20
    _write(tmp / "drift.h5", amino_acids=aa1b, rmsd=None,
           point_cloud=np.transpose(pc, (0, 2, 1)).astype(np.float64))
    return tmp / "drift.h5"


# one file (or directory) per case of tests/test_h5_robustness.py that
# reads a file; the cases on the schema functions alone are below
FILE_CASES = {
    "nr3_layout": _case_nr3,
    "one_based_labels": _case_labels(np.arange(10, dtype=np.int64) * 2 + 2),
    "zero_based_labels": _case_labels(np.arange(10, dtype=np.int64)),
    "onehot_labels": _case_labels(_onehot()),
    "float_labels": _case_labels(np.arange(10, dtype=np.float64)),
    "missing_rmsd": _case_missing_rmsd,
    "float64_point_cloud": _case_float64,
    "odd_length_row": _case_odd_row,
    "out_of_range_edge": _case_bad_edge,
    "directory_residue_mismatch": _case_dir_mismatch,
    "directory_frame_counts": _case_dir_frames,
    "no_self_loops": _case_no_self_loops,
    "drifted_file": _case_drifted,
}


def _outcome(fn, *args, **kwargs):
    """("ok", value, warnings) or ("error", type name, message)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value = fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001: compared below
            return ("error", type(e).__name__, str(e))
    return ("ok", value, [(w.category.__name__, str(w.message))
                          for w in caught])


def _same_trajectory(got, want):
    np.testing.assert_array_equal(got.positions, want.positions)
    assert got.positions.dtype == want.positions.dtype == np.float32
    np.testing.assert_array_equal(got.edges_flat, want.edges_flat)
    np.testing.assert_array_equal(got.edge_offsets, want.edge_offsets)
    np.testing.assert_array_equal(got.aminoacids, want.aminoacids)
    assert got.aminoacids.dtype == want.aminoacids.dtype
    if want.rmsd is None:
        assert got.rmsd is None
    else:
        np.testing.assert_array_equal(got.rmsd, want.rmsd)
        assert got.rmsd.dtype == want.rmsd.dtype


@pytest.mark.parametrize("case", sorted(FILE_CASES))
def test_load_trajectory_matches_jax_on_each_drift_case(case, tmp_path):
    path = FILE_CASES[case](tmp_path)
    got = _outcome(pdata.load_trajectory, path)
    want = _outcome(jdata.load_trajectory, path)
    assert got[0] == want[0], (got, want)
    if want[0] == "error":
        assert got[1:] == want[1:]
        return
    assert got[2] == want[2]  # the same warnings, in order
    _same_trajectory(got[1], want[1])
    assert (pdata.contact_maps_have_self_loops(got[1])
            == jdata.contact_maps_have_self_loops(want[1]))
    for i in (0, got[1].num_frames - 1):
        np.testing.assert_array_equal(got[1].edge_index(i),
                                      want[1].edge_index(i))
    if case == "drifted_file":
        ds = pdata.WindowDataset(got[1], window_size=4, graph_mode="sparse",
                                 max_edges=128)
        jds = jdata.WindowDataset(want[1], window_size=4,
                                  graph_mode="sparse", max_edges=128)
        a, b = ds.get_batch([5, 9]), jds.get_batch([5, 9])
        for k in ("window", "y", "edges", "mask"):
            np.testing.assert_array_equal(a[k], b[k])


SCHEMA_CALLS = [
    ("detect", ((5, 3, 28),), {}), ("detect", ((5, 28, 3),), {}),
    ("detect", ((5, 3, 3),), {}),
    ("detect", ((5, 28, 7),), {"num_residues_hint": 28}),
    ("detect", ((5, 7, 28),), {"num_residues_hint": 28}),
    ("detect", ((5, 28, 7),), {}), ("detect", ((5, 28),), {}),
    ("labels", (np.array([0.5, 1.0]),), {}),
    ("labels", (np.array([0, 25]),), {}),
    ("labels", (np.array([-1, 5]),), {}),
    ("labels", (np.array([1, 5, 19]),), {}),
    ("labels", (np.array([[1.0, 0.0], [0.0, 1.0]]),), {}),
]


@pytest.mark.parametrize("call", range(len(SCHEMA_CALLS)))
def test_schema_functions_match_jax(call):
    name, args, kwargs = SCHEMA_CALLS[call]
    fns = {"detect": (pdata.detect_pointcloud_layout,
                      jdata.detect_pointcloud_layout),
           "labels": (pdata.normalize_amino_labels,
                      jdata.normalize_amino_labels)}[name]
    got, want = (_outcome(f, *args, **kwargs) for f in fns)
    if isinstance(want[1], np.ndarray):
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype
        assert got[::2] == want[::2]
    else:
        assert got == want


def test_node_features_match_jax():
    labels = np.array([1, 20, 7, 3])
    np.testing.assert_array_equal(pdata.aminoacid_int_to_onehot(labels),
                                  jdata.aminoacid_int_to_onehot(labels))
    from molecular_dynamics_neural_operator_tpu.data import h5 as jh5

    for mode in ("constant", "identity", "amino_acid_onehot"):
        np.testing.assert_array_equal(
            pdata.compute_node_features(labels, mode, num_nodes=4),
            jh5.compute_node_features(labels, mode, num_nodes=4))
    with pytest.raises(ValueError, match="not supported"):
        pdata.compute_node_features(labels, "other")


def test_chunked_edge_reads_match_one_read(tmp_path, monkeypatch):
    from molecular_dynamics_neural_operator_tpu_torch.data import h5

    path = tmp_path / "t.h5"
    pdata.write_synthetic_h5(path, num_frames=30, num_residues=10, seed=2)
    whole = pdata.load_trajectory(path)
    monkeypatch.setattr(h5, "_EDGE_CHUNK", 7)
    monkeypatch.setattr(h5, "_POS_CHUNK", 4)
    _same_trajectory(pdata.load_trajectory(path), whole)
    _same_trajectory(pdata.load_trajectory(path, max_frames=11),
                     jdata.load_trajectory(path, max_frames=11))


# ---- the HDF5 writers ------------------------------------------------------

def _datasets(path):
    with h5py.File(path) as f:
        return {k: (list(map(np.asarray, f[k][:])) if k == "contact_map"
                    else np.asarray(f[k])) for k in f}


WRITERS = {
    "synthetic": lambda mod, p: mod.write_synthetic_h5(
        p, num_frames=40, num_residues=12, seed=5, dt=0.05),
    "langevin": lambda mod, p: mod.write_langevin_h5(
        p, num_frames=30, num_residues=10, seed=2, burn_in=20),
    "streamed": lambda mod, p: mod.write_synthetic_h5_streamed(
        p, num_frames=50, num_residues=12, seed=5, chunk_frames=16),
    "trajectory": lambda mod, p: mod.synthetic.write_trajectory_h5(
        p, mod.synthetic_trajectory(num_frames=20, num_residues=9, seed=1)),
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
def test_the_writers_match_jax_and_read_equal_in_both(writer, tmp_path):
    port_file, jax_file = tmp_path / "port.h5", tmp_path / "jax.h5"
    out = WRITERS[writer](pdata, port_file)
    jout = WRITERS[writer](jdata, jax_file)
    if isinstance(out, dict):
        assert {k: v for k, v in out.items() if k != "path"} == \
            {k: v for k, v in jout.items() if k != "path"}
    got, want = _datasets(port_file), _datasets(jax_file)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "contact_map":
            assert len(got[k]) == len(want[k])
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _same_trajectory(pdata.load_trajectory(port_file),
                         jdata.load_trajectory(port_file))


def test_dense_adj_matches_jax():
    traj = pdata.synthetic_trajectory(num_frames=20, num_residues=10, seed=6)
    jtraj = jdata.synthetic_trajectory(num_frames=20, num_residues=10, seed=6)
    for stored in (True, False):
        ds = pdata.WindowDataset(traj, window_size=4, graph_mode="sparse",
                                 max_edges=128,
                                 use_stored_contact_maps=stored)
        jds = jdata.WindowDataset(jtraj, window_size=4, graph_mode="sparse",
                                  max_edges=128,
                                  use_stored_contact_maps=stored,
                                  use_native=False)
        for i in (0, 7, 15):
            np.testing.assert_array_equal(ds.dense_adj(i), jds.dense_adj(i))


# ---- configurations --------------------------------------------------------

def _experiments(mod):
    return [
        mod.ExperimentConfig(),
        mod.ExperimentConfig(
            model=mod.ModelConfig(width=16, graph_mode="sparse",
                                  predict_delta=True, electrostatics="dh"),
            fno=mod.FNOConfig(modes1=4, predict_delta=True),
            data=mod.DataConfig(data_path="x.h5", node_features_path="n.h5",
                                split_method="random"),
            train=mod.TrainConfig(rollout_steps=4, loss_space="delta",
                                  grad_clip_norm=1.0, run_path="runs/x"),
            rollout=mod.RolloutConfig(num_steps=7, collect="both"),
            mesh=mod.MeshConfig(data=4, axis_names=("d", "m"))),
    ]


@pytest.mark.parametrize("which", [0, 1])
def test_config_json_is_the_same_text_and_reads_into_both(which):
    cfg, jcfg = _experiments(configs)[which], _experiments(jconfigs)[which]
    text = configs.to_json(cfg)
    assert text == jconfigs.to_json(jcfg)
    assert configs.experiment_from_json(text) == cfg
    assert dataclasses.asdict(configs.experiment_from_json(
        jconfigs.to_json(jcfg))) == dataclasses.asdict(jcfg)
    assert jconfigs.experiment_from_json(text) == jcfg


def test_every_config_has_the_jax_fields_and_defaults():
    for name in ("ModelConfig", "FNOConfig", "DataConfig", "TrainConfig",
                 "RolloutConfig", "MeshConfig", "ExperimentConfig"):
        assert (dataclasses.asdict(getattr(configs, name)())
                == dataclasses.asdict(getattr(jconfigs, name)())), name


def test_presets_match_jax():
    assert set(presets.PRESETS) == set(jpresets.PRESETS)
    for name, cfg in presets.PRESETS.items():
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(jpresets.PRESETS[name]), name


def test_the_solvated_preset_still_refuses_to_build():
    """Past the one-hot scatter's 512 nodes, as the 10k preset, the
    forward aggregates with the segment scatter (it gives the forced
    one-hot's sums), and the cell list the preset's rollouts take is
    accepted: its rebuild, reduced by the "blocked" hint, gives the same
    forward as the segment scatter on the same graph."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry import (
        contact_map,
        edge_features_from_edges,
        padded_edges_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
        SparseGraph,
        check_supported,
        gkn_apply_single,
    )

    cfg = dataclasses.replace(presets.SOLVATED_10K, width=4, ker_width=4,
                              depth=1, compute_dtype="float32")
    params = __import__(
        "molecular_dynamics_neural_operator_tpu_torch.models",
        fromlist=["gkn_init"]).gkn_init(cfg, device="cpu")
    r = 600  # past the one-hot scatter's 512 nodes, as the 10k preset
    rng = np.random.default_rng(0)
    window = torch.as_tensor(rng.uniform(0, 55, size=(cfg.window_size, r, 3)),
                             dtype=torch.float32)
    edges, mask = padded_edges_device(contact_map(window[-1]), 12 * r)
    graph = SparseGraph(edges, mask, edge_features_from_edges(window[-1],
                                                              edges))
    aa = torch.as_tensor(rng.integers(0, 20, r))
    with torch.no_grad():
        auto = gkn_apply_single(params, cfg, aa, window, graph)
        onehot = gkn_apply_single(params, cfg, aa, window, graph,
                                  scatter_hint="onehot")
    assert auto.shape == (r, 3) and torch.isfinite(auto).all()
    np.testing.assert_allclose(auto.numpy(), onehot.numpy(), 1e-5, 1e-5)
    cells = dataclasses.replace(cfg, neighbor_impl="cell_list",
                                max_degree=48, cell_capacity=32,
                                num_cells=1024)
    check_supported(cells)
    from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
        _build_graph,
        rebuilt_scatter_hint,
    )

    graph, overflow = _build_graph(cells, window[-1], 8.0)
    assert not bool(overflow)
    assert rebuilt_scatter_hint(cells, r) == "blocked"
    with torch.no_grad():
        blocked = gkn_apply_single(params, cells, aa, window, graph,
                                   scatter_hint="blocked")
        segment = gkn_apply_single(params, cells, aa, window, graph,
                                   scatter_hint="segment")
    np.testing.assert_allclose(blocked.numpy(), segment.numpy(), 1e-5, 1e-5)


# ---- TrainState checkpoints across packages --------------------------------

MODEL = dict(width=8, ker_width=16, depth=1, window_size=4, num_residues=10,
             max_edges=128, graph_mode="sparse", compute_dtype="float32",
             predict_delta=True)
CHAINS = {
    "plain": {},
    "clip": {"grad_clip_norm": 1.0},
    "skip_nonfinite": {"skip_nonfinite_updates": True},
    "accum": {"grad_accum": 2},
    "all_three": {"grad_clip_norm": 1.0, "skip_nonfinite_updates": True,
                  "grad_accum": 2},
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


@pytest.fixture(scope="module")
def ckpt_data():
    traj = pdata.synthetic_trajectory(num_frames=40, num_residues=10, seed=4)
    ds = pdata.WindowDataset(traj, window_size=4, graph_mode="sparse",
                             max_edges=128)
    batches = [ds.get_batch(np.arange(4) + 4 * i) for i in range(4)]
    # a non-finite gradient for the guard: one NaN coordinate
    bad = {k: v.copy() for k, v in batches[1].items()}
    bad["window"][0, 0, 0, 0] = np.nan
    return batches, bad


def _states(chain):
    tcfg = dict(lr=1e-3, batch_size=4, **CHAINS[chain])
    jcfg = jconfigs.ModelConfig(**MODEL)
    cfg = configs.ModelConfig(**MODEL)
    jstate, jtx, _ = jax_create_train_state(
        jax.random.PRNGKey(0), jcfg, jconfigs.TrainConfig(**tcfg))
    state, tx, _ = create_train_state(
        5, cfg, configs.TrainConfig(**tcfg), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               "cpu"))
    return jcfg, cfg, jstate, jtx, state, tx


def _pre_batches(chain, batches, bad):
    """Two steps, three with an accumulator (so that its window holds a
    gradient when saved); the guard's chains see a NaN batch second."""
    pre = [batches[0], bad if "skip" in chain or chain == "all_three"
           else batches[1]]
    if CHAINS[chain].get("grad_accum", 1) > 1:
        pre.append(batches[2])
    return pre


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _assert_state_matches(state, jstate):
    flat = jcheckpoint._flatten_with_paths(jstate)
    port = checkpoint._train_state_flat(state)
    assert set(port) == set(flat)
    for key, want in flat.items():
        if key == ".rng":
            continue
        got = port[key]
        assert got.dtype == want.dtype, key
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, RTOL, ATOL, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_a_jax_checkpoint_resumes_in_the_port(chain, ckpt_data, tmp_path):
    batches, bad = ckpt_data
    jcfg, cfg, jstate, jtx, template, tx = _states(chain)
    jstep = jloop.make_train_step(jcfg, jtx, donate=False)
    for b in _pre_batches(chain, batches, bad):
        jstate, _ = jstep(jstate, _jbatch(b))
    jcheckpoint.save_checkpoint(tmp_path / "jax.npz", jstate, {"epoch": 3})
    state, meta = checkpoint.restore_checkpoint(tmp_path / "jax.npz",
                                                template)
    assert meta == {"epoch": 3}
    key = np.asarray(jstate.rng, np.uint64)
    assert state.rng == int(key[0]) << 32 | int(key[1])
    _assert_state_matches(state, jstate)
    # one more step in each package
    jstate, jm = jstep(jstate, _jbatch(batches[3]))
    state, m = make_train_step(cfg, tx)(state,
                                        to_device(batches[3], "cpu"))
    np.testing.assert_allclose(float(m["rel_l2"]), float(jm["rel_l2"]),
                               rtol=RTOL)
    _assert_state_matches(state, jstate)
    if "skip" in chain or chain == "all_three":
        assert state.opt_state.total_notfinite == 1
        assert state.opt_state.last_finite


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_a_port_checkpoint_restores_in_the_jax_package(chain, ckpt_data,
                                                       tmp_path):
    batches, bad = ckpt_data
    jcfg, cfg, jtemplate, _, state, tx = _states(chain)
    step = make_train_step(cfg, tx)
    for b in _pre_batches(chain, batches, bad):
        state, _ = step(state, to_device(b, "cpu"))
    checkpoint.save_checkpoint(tmp_path / "port.npz", state, {"epoch": 1})
    jstate, meta = jcheckpoint.restore_checkpoint(tmp_path / "port.npz",
                                                  jtemplate)
    assert meta == {"epoch": 1}
    flat = jcheckpoint._flatten_with_paths(jstate)
    port = checkpoint._train_state_flat(state)
    assert set(flat) == set(port)
    for key, want in port.items():
        np.testing.assert_array_equal(flat[key], want, err_msg=key)
    np.testing.assert_array_equal(np.asarray(jstate.rng),
                                  np.array([0, 5], np.uint32))
    assert jax.random.key_data(jax.random.PRNGKey(5)).tolist() == [0, 5]
    # and back into the port, unchanged
    again, _ = checkpoint.restore_checkpoint(tmp_path / "port.npz",
                                             _states(chain)[4])
    assert again.step == state.step and again.rng == state.rng
    assert again.opt_state._replace(mu=None, nu=None, acc=None) == \
        state.opt_state._replace(mu=None, nu=None, acc=None)
    for (n, a), (_, b) in zip(_flat(again.params), _flat(state.params)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("saved,template", [("plain", "clip"),
                                            ("clip", "plain"),
                                            ("skip_nonfinite", "plain"),
                                            ("plain", "accum")])
def test_a_chain_mismatch_raises_key_error_naming_the_key(saved, template,
                                                          tmp_path):
    jstate = _states(saved)[2]
    jcheckpoint.save_checkpoint(tmp_path / "c.npz", jstate)
    with pytest.raises(KeyError, match=r"\.opt_state/"):
        checkpoint.restore_checkpoint(tmp_path / "c.npz",
                                      _states(template)[4])


def test_a_missing_leaf_and_a_wrong_shape_are_named(tmp_path):
    state = _states("plain")[4]
    checkpoint.save_checkpoint(tmp_path / "c.npz", state)
    with np.load(tmp_path / "c.npz") as d:
        kept = {k: d[k] for k in d.files if k != ".step"}
    np.savez(tmp_path / "c.npz", **kept)
    with pytest.raises(KeyError, match=r"\.step"):
        checkpoint.restore_checkpoint(tmp_path / "c.npz", state)
    wide = create_train_state(0, configs.ModelConfig(**{**MODEL, "width": 16}),
                              configs.TrainConfig(), device="cpu")[0]
    checkpoint.save_checkpoint(tmp_path / "w.npz", wide)
    with pytest.raises(ValueError, match=r"\.params/.* has shape"):
        checkpoint.restore_checkpoint(tmp_path / "w.npz", state)


# ---- BestCheckpointer -------------------------------------------------------

BEST_CASES = {
    "improving": [(0, 3.0), (1, 2.0), (2, 1.0)],
    "worse_then_better": [(0, 1.0), (1, 2.0), (2, 0.5), (3, 0.5)],
    "nan_first": [(0, float("nan")), (1, 4.0)],
}


@pytest.mark.parametrize("case", sorted(BEST_CASES))
@pytest.mark.parametrize("every", [1, 2])
def test_best_checkpointer_matches_jax(case, every, tmp_path):
    jstate = _states("plain")[2]
    state = _states("plain")[4]
    runs = {}
    for name, cls, st in (("port", checkpoint.BestCheckpointer, state),
                          ("jax", jcheckpoint.BestCheckpointer, jstate)):
        ck = cls(tmp_path / name, save_last_every=every)
        returns = [ck.update(e, loss, st) for e, loss in BEST_CASES[case]]
        side = {f: json.loads((tmp_path / name / f"{f}.npz.json")
                              .read_text())["metadata"]
                for f in ("best", "last")
                if (tmp_path / name / f"{f}.npz.json").exists()}
        resumed = cls(tmp_path / name, resume=True).best_loss
        fresh = cls(tmp_path / name).best_loss
        runs[name] = (returns, ck.best_loss, side, resumed, fresh,
                      sorted(p.name for p in (tmp_path / name).iterdir()))
    got, want = runs["port"], runs["jax"]
    assert json.dumps(got) == json.dumps(want)
