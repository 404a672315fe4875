"""The port's training and rollout CLIs against the JAX package's on the
CPU, on one HDF5 file the test writes.

Training: both CLIs start from the same weights, a JAX TrainState
checkpoint saved with ``{"epoch": -1}`` for the optimizer chain the run
builds, through ``--resume``, and train two epochs each: teacher-forced,
the K = 2 curriculum with the delta loss, and a resume from the port's
own ``last.npz`` (both packages reading it). matplotlib is hidden during
the runs, so both write the movie's maps as ``.npz``. Rollout: the
committed ``tools/bench_ckpt.npz`` through ``--impl scan``, ``--impl
persistent`` (the kernels' plain versions here) and four streams, and a
rollout of each package's trained ``best.npz``. Then the refusals, the
device rule and the no-op flags.
"""

import dataclasses
import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import configs as jconfigs
from molecular_dynamics_neural_operator_tpu.cli import rollout as jrollout
from molecular_dynamics_neural_operator_tpu.cli import train as jtrain
from molecular_dynamics_neural_operator_tpu.train import (
    create_train_state as jax_create_train_state,
)
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jcheckpoint,
)
from molecular_dynamics_neural_operator_tpu_torch import configs
from molecular_dynamics_neural_operator_tpu_torch.cli import rollout as prollout
from molecular_dynamics_neural_operator_tpu_torch.cli import train as ptrain
from molecular_dynamics_neural_operator_tpu_torch.data import (
    write_synthetic_h5,
)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 1e-5
COORD_ATOL = 1e-5  # Angstrom

TRAIN_ARGS = ["--epochs", "2", "--batch_size", "16", "--lr", "1e-3",
              "--window_size", "4", "--num_residues", "28",
              "--compute_dtype", "float32", "--width", "8",
              "--kernel_width", "16", "--depth", "1", "--graph_mode",
              "sparse", "--max_edges", "224", "--predict_delta",
              "--latent_frames", "16", "--num_movie_frames", "3"]
TRAIN_CASES = {
    "teacher": [],
    "curriculum": ["--rollout_steps", "2", "--loss_space", "delta"],
}
ROLL_ARGS = ["--checkpoint", str(ROOT / "tools" / "bench_ckpt.npz"),
             "--graph_mode", "sparse", "--max_edges", "224",
             "--predict_delta", "--compute_dtype", "float32",
             "--num_steps", "16"]
ROLL_CASES = {
    "scan": ["--impl", "scan"],
    "persistent": ["--impl", "persistent"],
    "streams": ["--streams", "4", "--stream_stride", "3"],
}


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "traj.h5"
    write_synthetic_h5(path, num_frames=200, num_residues=28, seed=13)
    return path


def _init_checkpoint(argv, path):
    """A JAX TrainState for the chain ``argv`` builds, saved as epoch -1."""
    args = jtrain.parse_args(argv)
    model, _, train = jtrain.build_configs(args)
    state, _, _ = jax_create_train_state(
        jax.random.PRNGKey(train.seed), model, train)
    jcheckpoint.save_checkpoint(path, state, {"epoch": -1})
    return path


def _both(jmain, pmain, argv, jdir, pdir, out_flag):
    """Run the JAX CLI into ``jdir`` and the port's into ``pdir`` with
    matplotlib hidden (the maps and embeddings go to .npy/.npz)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        jout = jmain(argv + [out_flag, str(jdir)])
        pout = pmain(argv + [out_flag, str(pdir), "--device", "cpu"])
    return jout, pout


@pytest.fixture(scope="module")
def train_runs(h5, tmp_path_factory):
    """{case: (jax run dir, port run dir)}, both CLIs per case."""
    base = tmp_path_factory.mktemp("train")
    runs = {}
    for case, extra in TRAIN_CASES.items():
        argv = ["--data_path", str(h5)] + TRAIN_ARGS + extra
        init = _init_checkpoint(argv + ["--run_path", str(base / "x")],
                                base / f"{case}_init.npz")
        jdir, pdir = base / f"{case}_jax", base / f"{case}_port"
        _both(jtrain.main, ptrain.main, argv + ["--resume", str(init)],
              jdir, pdir, "--run_path")
        runs[case] = (jdir, pdir)
    # both packages resume from the port's own last.npz, each in a copy
    # of the port's run directory, for epochs 2 and 3
    jdir, pdir = base / "resume_jax", base / "resume_port"
    for d in (jdir, pdir):
        shutil.copytree(runs["teacher"][1], d)
    argv = ["--data_path", str(h5)] + TRAIN_ARGS
    argv[argv.index("--epochs") + 1] = "4"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        jtrain.main(argv + ["--run_path", str(jdir), "--resume",
                            str(jdir / "last.npz")])
        ptrain.main(argv + ["--run_path", str(pdir), "--resume",
                            str(pdir / "last.npz"), "--device", "cpu"])
    runs["resume"] = (jdir, pdir)
    return runs


def _metrics(run):
    return [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]


CASES = ["teacher", "curriculum", "resume"]


@pytest.mark.parametrize("case", CASES)
def test_train_cli_epoch_losses_match_jax(case, train_runs):
    jdir, pdir = train_runs[case]
    want, got = _metrics(jdir), _metrics(pdir)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want]
    assert [r["epoch"] for r in got][-2:] == (
        [2, 3] if case == "resume" else [0, 1])
    for g, w in zip(got, want):
        for k in ("avg_train_loss", "avg_valid_loss", "avg_train_mse",
                  "avg_valid_mse"):
            np.testing.assert_allclose(g[k], w[k], RTOL, ATOL,
                                       err_msg=f"{k} epoch {g['epoch']}")
        assert set(g) == set(w)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", ["best.npz", "last.npz"])
def test_train_cli_checkpoints_match_jax(case, name, train_runs):
    jdir, pdir = train_runs[case]
    with np.load(jdir / name) as j, np.load(pdir / name) as p:
        assert set(p.files) == set(j.files)
        for k in j.files:
            if k == ".rng":
                continue
            assert p[k].dtype == j[k].dtype, k
            if j[k].dtype == np.float32:
                np.testing.assert_allclose(p[k], j[k], RTOL, ATOL,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    meta = [json.loads((d / f"{name}.json").read_text())["metadata"]
            for d in (jdir, pdir)]
    assert meta[0]["epoch"] == meta[1]["epoch"]
    np.testing.assert_allclose(meta[1]["valid_loss"], meta[0]["valid_loss"],
                               RTOL, ATOL)


@pytest.mark.parametrize("case", CASES)
def test_train_cli_config_json_matches_jax(case, train_runs):
    jdir, pdir = train_runs[case]
    jtext = (jdir / "config.json").read_text()
    ptext = (pdir / "config.json").read_text()
    want, got = json.loads(jtext), json.loads(ptext)
    assert got["train"].pop("run_path") == str(pdir)
    assert want["train"].pop("run_path") == str(jdir)
    assert got == want
    # each package reads the other's
    assert dataclasses.asdict(configs.experiment_from_json(jtext)) == \
        dataclasses.asdict(jconfigs.experiment_from_json(jtext))
    assert jconfigs.experiment_from_json(ptext) == dataclasses.replace(
        jconfigs.experiment_from_json(jtext),
        train=dataclasses.replace(
            jconfigs.experiment_from_json(jtext).train, run_path=str(pdir)))


@pytest.mark.parametrize("case", CASES)
def test_train_cli_movie_maps_and_latents_match_jax(case, train_runs):
    jdir, pdir = train_runs[case]
    epochs = [r["epoch"] for r in _metrics(jdir)]
    for e in epochs[-2:]:
        with np.load(jdir / f"epoch{e}_maps.npz") as j, \
                np.load(pdir / f"epoch{e}_maps.npz") as p:
            for k in ("forecast", "real"):
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        np.testing.assert_allclose(
            np.load(pdir / f"latent_space_epoch{e}.npy"),
            np.load(jdir / f"latent_space_epoch{e}.npy"), RTOL, ATOL)


@pytest.mark.parametrize("case", CASES)
def test_train_cli_writes_the_same_files(case, train_runs):
    jdir, pdir = train_runs[case]
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    with open(pdir / "latent_color_dict.pkl", "rb") as f, \
            open(jdir / "latent_color_dict.pkl", "rb") as g:
        import pickle

        np.testing.assert_array_equal(pickle.load(f)["RMSD"],
                                      pickle.load(g)["RMSD"])


# ---- rollout ---------------------------------------------------------------

@pytest.fixture(scope="module")
def roll_runs(h5, train_runs, tmp_path_factory):
    """{case: (jax out dir, port out dir, jax summary, port summary)}."""
    base = tmp_path_factory.mktemp("roll")
    runs = {}
    for case, extra in ROLL_CASES.items():
        argv = ["--data_path", str(h5)] + ROLL_ARGS + extra
        jdir, pdir = base / f"{case}_jax", base / f"{case}_port"
        runs[case] = (jdir, pdir) + _both(jrollout.main, prollout.main, argv,
                                          jdir, pdir, "--out_path")
    # each package rolls out its own trained best.npz, with the movie and
    # the backbone frames
    jrun, prun = train_runs["teacher"]
    small = ["--data_path", str(h5), "--num_steps", "6", "--window_size",
             "4", "--width", "8", "--kernel_width", "16", "--depth", "1",
             "--graph_mode", "sparse", "--max_edges", "224",
             "--predict_delta", "--compute_dtype", "float32", "--movie",
             "--backbone"]
    jdir, pdir = base / "trained_jax", base / "trained_port"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "matplotlib", None)
        js = jrollout.main(small + ["--checkpoint", str(jrun / "best.npz"),
                                    "--out_path", str(jdir)])
        ps = prollout.main(small + ["--checkpoint", str(prun / "best.npz"),
                                    "--out_path", str(pdir), "--device",
                                    "cpu"])
    runs["trained"] = (jdir, pdir, js, ps)
    return runs


TIMES = ("seconds", "steps_per_s", "agg_steps_per_s")


@pytest.mark.parametrize("case", sorted(ROLL_CASES) + ["trained"])
def test_rollout_cli_matches_jax(case, roll_runs):
    jdir, pdir, js, ps = roll_runs[case]
    assert sorted(p.name for p in pdir.iterdir()) == \
        sorted(p.name for p in jdir.iterdir())
    want = np.load(jdir / "forecast_coords.npy")
    got = np.load(pdir / "forecast_coords.npy")
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=COORD_ATOL)
    if (jdir / "per_step_mse.npy").exists():
        np.testing.assert_allclose(np.load(pdir / "per_step_mse.npy"),
                                   np.load(jdir / "per_step_mse.npy"),
                                   RTOL, ATOL)
    summary = json.loads((pdir / "rollout_summary.json").read_text())
    assert summary == ps
    assert set(ps) == set(js)
    for k in js:
        if k in TIMES:
            continue
        if isinstance(js[k], float):
            np.testing.assert_allclose(ps[k], js[k], RTOL, ATOL, err_msg=k)
        else:
            assert ps[k] == js[k], k
    if case == "trained":
        with np.load(jdir / "epoch0_maps.npz") as j, \
                np.load(pdir / "epoch0_maps.npz") as p:
            for k in ("forecast", "real"):
                np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        for i in range(1, 7):
            np.testing.assert_allclose(
                np.load(pdir / f"backbone_frame{i}.npy"),
                np.load(jdir / f"backbone_frame{i}.npy"), 0, COORD_ATOL)


# ---- refusals, device and no-op flags ---------------------------------------

# (cli, flags, the queue A item that refuses them, or None where the flag
# is ported now and the CLI goes on to read the data)
REFUSALS = [
    ("train", ["--graph_mode", "sparse", "--operator", "fno"], None),
    ("train", ["--graph_mode", "sparse", "--data_parallel"], None),
    ("train", [], None),  # the JAX default --graph_mode dense
    ("train", ["--graph_mode", "sparse", "--edge_layout", "blocked"], None),
    ("train", ["--graph_mode", "sparse", "--window_diff"], None),
    ("rollout", [], None),
    ("rollout", ["--graph_mode", "sparse", "--window_diff"], None),
    ("rollout", ["--graph_mode", "sparse", "--kernel_quant", "int8"], None),
    ("rollout", ["--graph_mode", "sparse", "--neighbor_impl", "cell_list"],
     None),
]


@pytest.mark.parametrize("cli,flags,item", REFUSALS,
                         ids=[f"{c}{''.join(f)}" for c, f, _ in REFUSALS])
def test_unported_flags_are_refused_before_any_data_is_read(cli, flags, item,
                                                            tmp_path):
    """A flag whose module is not ported exits naming its queue item
    before the data is read; a ported one (item None) is accepted, and
    the CLI fails only at the missing data file."""
    missing = tmp_path / "missing.h5"  # never opened
    if cli == "train":
        argv = ["--data_path", str(missing), "--run_path",
                str(tmp_path / "run")] + flags
        main = ptrain.main
    else:
        argv = ["--data_path", str(missing), "--out_path",
                str(tmp_path / "out")] + flags
        main = prollout.main
    if item is None:
        with pytest.raises((FileNotFoundError, OSError, ValueError),
                           match="missing.h5|data_path does not exist"):
            main(argv + ["--device", "cpu"])
    else:
        with pytest.raises(SystemExit, match=f"queue A item {item}"):
            main(argv + ["--device", "cpu"])
    assert not (tmp_path / "run").exists() and not (tmp_path / "out").exists()


def test_int8_rollouts_need_the_sparse_graph_as_in_jax(tmp_path):
    argv = ["--data_path", str(tmp_path / "missing.h5"), "--out_path",
            str(tmp_path / "out"), "--kernel_quant", "int8"]
    with pytest.raises(SystemExit, match="requires --graph_mode sparse"):
        prollout.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="requires --graph_mode sparse"):
        jrollout.main(argv)


def test_the_clis_need_the_card_unless_asked_for_the_cpu(h5, tmp_path,
                                                         monkeypatch):
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        synthetic_trajectory,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    targs = ["--data_path", str(h5), "--run_path", str(tmp_path / "r"),
             "--graph_mode", "sparse"]
    rargs = ["--data_path", str(h5), "--out_path", str(tmp_path / "o"),
             "--graph_mode", "sparse"]
    traj = synthetic_trajectory(num_frames=30, num_residues=10, seed=1)
    for make in (lambda: ptrain.main(targs),
                 lambda: prollout.main(rargs),
                 lambda: ptrain.train_from_trajectory(
                     ptrain.parse_args(targs), traj),
                 lambda: prollout.rollout_from_trajectory(
                     prollout.parse_args(rargs), traj)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not (tmp_path / "r").exists() and not (tmp_path / "o").exists()
    # --train_conv_impl auto: the kernels on the card, per-layer otherwise
    assert ptrain.build_configs(ptrain.parse_args(targs))[0] \
        .train_conv_impl == "pallas"
    assert ptrain.build_configs(ptrain.parse_args(
        targs + ["--device", "cpu"]))[0].train_conv_impl == "xla"


def test_loss_space_guard_compilation_cache_and_profile(h5, tmp_path,
                                                        capsys):
    argv = ["--data_path", str(h5), "--epochs", "1", "--batch_size", "32",
            "--window_size", "4", "--compute_dtype", "float32", "--width",
            "8", "--kernel_width", "16", "--depth", "1", "--graph_mode",
            "sparse", "--max_edges", "224", "--generate_movie", "False",
            "--plot_latent", "False", "--device", "cpu", "--max_frames",
            "60"]
    with pytest.raises(SystemExit, match="loss_space"):
        ptrain.main(argv + ["--run_path", str(tmp_path / "bad"),
                            "--loss_space", "delta"])
    run = tmp_path / "run"
    ptrain.main(argv + ["--run_path", str(run), "--profile",
                        "--compilation_cache", str(tmp_path / "cc")])
    assert "no counterpart" in capsys.readouterr().out
    assert not (tmp_path / "cc").exists()
    trace = json.loads((run / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    rows = _metrics(run)
    assert [r["epoch"] for r in rows] == [0]
    assert np.isfinite(rows[0]["avg_train_loss"])
