"""The port's electrostatics preprocessing (``preprocess/grid.py``,
``preprocess/electrostatics.py``, ``cli/preprocess.py``) against the JAX
package's on the CPU.

Tolerances: the grid points are JAX's bit for bit on the deck's grid
(the f32 ``linspace`` as XLA compiles it on the CPU; 1 ulp on a 4-point
axis, where XLA fuses the other product); the potentials are f32 sums
of exp(-kappa d)/d in another order, held within rtol 1e-5 / atol 1e-6 of JAX's and rtol 1e-4 /
atol 1e-5 of a float64 numpy oracle (``tests/test_preprocess.py``'s); the
trilinear samples within 1e-6 of the grid's scale. The renderer, the
``.dx`` parser and the frame reader are the same text and numbers. The
pipeline runs with stub programs, as ``tests/test_preprocess.py`` does.
"""

import stat
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.cli import (
    preprocess as jax_cli,
)
from molecular_dynamics_neural_operator_tpu.preprocess import (
    electrostatics as jax_es,
)
from molecular_dynamics_neural_operator_tpu.preprocess import (
    grid_jax as jax_grid,
)
from molecular_dynamics_neural_operator_tpu_torch.cli import preprocess as cli
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
    write_synthetic_h5,
)
from molecular_dynamics_neural_operator_tpu_torch.preprocess import (
    AMINO_ACID_CHARGES,
    batched_debye_huckel_grids,
    debye_huckel_grid,
    make_grid,
    parallel_trajectory_to_electrostatic_grid,
    parse_dx_grid,
    render_apbs_input,
    sample_grid_trilinear,
    trajectory_to_electrostatic_grid,
)
from molecular_dynamics_neural_operator_tpu_torch.preprocess import (
    electrostatics as es,
)
from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
    _BJERRUM_A_K,
    debye_kappa,
)

RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("center,lengths,dime,ulps", [
    # the deck's fine grid around two centres: bit for bit
    (np.array([1.7, -3.2, 12.9]), [52.958, 44.009, 38.33], (97, 65, 65), 0),
    (np.zeros(3), [52.958, 44.009, 38.33], (97, 65, 65), 0),
    (np.array([0.3, 0.1, -0.7], np.float32), [7.0, 9.5, 3.0], (2, 1, 11), 0),
    # XLA fuses the other product on a 4-point axis: 1 ulp at most
    ([0.0, 0.0, 0.0], [20.0, 20.0, 20.0], (5, 4, 3), 1),
])
def test_make_grid_against_jax(center, lengths, dime, ulps):
    got = make_grid(center, lengths, dime).numpy()
    want = np.asarray(jax_grid.make_grid(center, lengths, dime))
    assert got.dtype == np.float32 and got.shape == want.shape
    if ulps == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=ulps)


def _oracle(grid, pos, q):
    kappa = debye_kappa()
    lb = _BJERRUM_A_K / (78.0 * 310.0)
    g, p = np.asarray(grid, np.float64), np.asarray(pos, np.float64)
    d = np.sqrt(np.maximum(((g[:, None, :] - p[None]) ** 2).sum(-1), 1.0))
    return lb * (np.exp(-kappa * d) / d) @ np.asarray(q, np.float64)


@pytest.mark.parametrize("block", [16, 4096])
def test_debye_huckel_grid_against_jax_and_numpy(block):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(17, 3)).astype(np.float32) * 5
    q = rng.normal(size=(17,)).astype(np.float32)
    grid = make_grid([0, 0, 0], [20, 20, 20], (5, 4, 3))
    got = debye_huckel_grid(torch.as_tensor(pos), torch.as_tensor(q), grid,
                            block=block).numpy()
    want = np.asarray(jax_grid.debye_huckel_grid(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(grid.numpy()),
        block=16))
    assert got.shape == (60,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, _oracle(grid, pos, q), rtol=1e-4,
                               atol=1e-5)


def test_batched_grids_against_jax():
    traj = synthetic_trajectory(num_frames=7, num_residues=28, seed=3)
    q = AMINO_ACID_CHARGES[traj.aminoacids % 20]
    grid = make_grid(traj.positions.mean(axis=(0, 1)), [30.0, 25.0, 20.0],
                     (9, 7, 5))
    pos = torch.as_tensor(traj.positions)
    # a small element budget splits the frames into several groups
    got = batched_debye_huckel_grids(pos, torch.as_tensor(q), grid, block=64,
                                     max_elements=64 * 28 * 3).numpy()
    want = np.asarray(jax_grid.batched_debye_huckel_grids(
        jnp.asarray(traj.positions), jnp.asarray(q),
        jnp.asarray(grid.numpy()), block=64))
    assert got.shape == (7, 315)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    whole = batched_debye_huckel_grids(pos, torch.as_tensor(q), grid).numpy()
    np.testing.assert_allclose(whole, got, rtol=RTOL, atol=ATOL)
    # per-frame charges (one row a frame) as well
    q_frames = torch.as_tensor(np.tile(q, (7, 1)))
    np.testing.assert_allclose(
        debye_huckel_grid(pos, q_frames, grid).numpy(), got, rtol=RTOL,
        atol=ATOL)


def test_sample_grid_trilinear_against_jax():
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(6, 5, 4)).astype(np.float32)
    origin = np.array([-2.0, 1.0, 0.5], np.float32)
    spacing = np.array([0.75, 1.25, 2.0], np.float32)
    # inside, on the faces and outside the box (clamped)
    pos = (origin + rng.uniform(-2.0, 1.2, size=(40, 3)).astype(np.float32)
           * spacing * np.array(grid.shape, np.float32))
    got = sample_grid_trilinear(torch.as_tensor(grid), origin, spacing,
                                torch.as_tensor(pos)).numpy()
    want = np.asarray(jax_grid.sample_grid_trilinear(
        jnp.asarray(grid), jnp.asarray(origin), jnp.asarray(spacing),
        jnp.asarray(pos)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # at a grid node the sample is the node's value
    node = torch.as_tensor(origin + spacing * np.array([2, 3, 1]))[None]
    assert abs(float(sample_grid_trilinear(torch.as_tensor(grid), origin,
                                           spacing, node)[0])
               - grid[2, 3, 1]) < 1e-6


def test_renderer_and_parser_equal_jax(tmp_path):
    assert render_apbs_input("/x/frame.pqr", "/x/frame.dx") == \
        jax_es.render_apbs_input("/x/frame.pqr", "/x/frame.dx")
    text = render_apbs_input("/x/frame.pqr", "/x/frame.dx")
    assert "write pot dx /x/frame\n" in text and "{{" not in text
    assert es._TEMPLATE_PATH.read_text() == jax_es._TEMPLATE_PATH.read_text()
    arr = np.random.default_rng(2).normal(size=(3, 4, 5))
    _write_dx(tmp_path / "g.dx", arr)
    got, want = parse_dx_grid(tmp_path / "g.dx"), jax_es.parse_dx_grid(
        tmp_path / "g.dx")
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, arr, rtol=1e-6)
    (tmp_path / "bad.dx").write_text("object 3 class array\n1 2\n")
    with pytest.raises(ValueError, match="no grid counts"):
        parse_dx_grid(tmp_path / "bad.dx")


def test_frame_reader_equals_jax(tmp_path):
    pdb = tmp_path / "traj.pdb"
    _fake_pdb(pdb, frames=3)
    texts = []
    for reader in (es._iter_frames_pdb, jax_es._iter_frames_pdb):
        out = []
        for i, write in enumerate(reader(pdb, pdb)):
            write(tmp_path / f"f{i}.pdb")
            out.append((tmp_path / f"f{i}.pdb").read_text())
        texts.append(out)
    assert texts[0] == texts[1] and len(texts[0]) == 3


def _write_dx(path, arr):
    nx, ny, nz = arr.shape
    lines = [
        "# test grid",
        f"object 1 class gridpositions counts {nx} {ny} {nz}",
        "origin 0.0 0.0 0.0",
        "delta 1.0 0.0 0.0",
        "delta 0.0 1.0 0.0",
        "delta 0.0 0.0 1.0",
        f"object 2 class gridconnections counts {nx} {ny} {nz}",
        f"object 3 class array type double rank 0 items {arr.size} data "
        "follows",
    ]
    flat = arr.ravel()
    for i in range(0, flat.size, 3):
        lines.append(" ".join(f"{v:.9e}" for v in flat[i:i + 3]))
    lines.append('attribute "dep" string "positions"')
    Path(path).write_text("\n".join(lines) + "\n")


def _fake_pdb(path, frames=3):
    models = []
    for m in range(frames):
        models.append(f"MODEL     {m + 1}")
        models.append(f"ATOM      1  CA  ALA A   1      {m:8.3f}   0.000   "
                      "0.000  1.00  0.00")
        models.append("ENDMDL")
    Path(path).write_text("\n".join(models) + "\nEND\n")


@pytest.fixture
def stub_programs(tmp_path):
    """Stand-ins for pdb2pqr30 and apbs that write plausible outputs."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    pdb2pqr = bin_dir / "stub_pdb2pqr"
    pdb2pqr.write_text("#!/bin/bash\ncp \"$1\" \"$2\"\n")
    apbs = bin_dir / "stub_apbs"
    apbs.write_text(
        "#!/usr/bin/env python3\n"
        "import sys\n"
        "deck = open(sys.argv[1]).read()\n"
        "stem = [l.split()[-1] for l in deck.splitlines()"
        " if l.strip().startswith('write pot dx')][0]\n"
        "lines = ['object 1 class gridpositions counts 2 2 2',\n"
        "         'object 3 class array type double rank 0 items 8 data "
        "follows', '1 2 3', '4 5 6', '7 8']\n"
        "open(stem + '.dx', 'w').write('\\n'.join(lines) + '\\n')\n")
    for f in (pdb2pqr, apbs):
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    return str(pdb2pqr), str(apbs)


def test_pipeline_with_stub_programs(tmp_path, stub_programs):
    pdb2pqr, apbs = stub_programs
    pdb = tmp_path / "traj.pdb"
    _fake_pdb(pdb, frames=3)
    outs = []
    for tag, fn in (("port", trajectory_to_electrostatic_grid),
                    ("jax", jax_es.trajectory_to_electrostatic_grid)):
        written = fn(pdb, pdb, tmp_path / f"s_{tag}", tmp_path / f"r_{tag}",
                     save_interval=2, pdb2pqr_exe=pdb2pqr, apbs_exe=apbs)
        outs.append([(p.name, np.load(p)) for p in written])
        assert list((tmp_path / f"s_{tag}").glob("*")) == []
    assert [n for n, _ in outs[0]] == [n for n, _ in outs[1]]
    for (_, a), (_, b) in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert sum(a.shape[0] for _, a in outs[0]) == 3
    with pytest.raises(ValueError, match="pdb2pqr failed"):
        trajectory_to_electrostatic_grid(pdb, pdb, tmp_path / "s",
                                         tmp_path / "r", pdb2pqr_exe="false",
                                         apbs_exe="false")
    with pytest.raises(ValueError, match="apbs failed"):
        trajectory_to_electrostatic_grid(pdb, pdb, tmp_path / "s2",
                                         tmp_path / "r2",
                                         pdb2pqr_exe=pdb2pqr,
                                         apbs_exe="false")


def test_parallel_pipeline_and_cli_apbs_mode(tmp_path, stub_programs):
    pdb2pqr, apbs = stub_programs
    pdbs = []
    for i in range(2):
        p = tmp_path / f"t{i}.pdb"
        _fake_pdb(p, frames=2)
        pdbs.append(p)
    written = parallel_trajectory_to_electrostatic_grid(
        pdbs, pdbs, tmp_path / "s", tmp_path / "r", num_workers=2,
        pdb2pqr_exe=pdb2pqr, apbs_exe=apbs)
    # frame 0 flushes at once (i % interval == 0), then the remainder
    assert len(written) == 4
    assert sum(np.load(p).shape[0] for p in written) == 4
    via_cli = cli.main(["--pdb_files", *map(str, pdbs), "--traj_files",
                        *map(str, pdbs), "--scratch_dir", str(tmp_path / "s"),
                        "--results_dir", str(tmp_path / "c"),
                        "--num_workers", "2", "--pdb2pqr_exe", pdb2pqr,
                        "--apbs_exe", apbs])
    assert sorted(p.name for p in via_cli) == sorted(p.name for p in written)


def test_cli_dh_mode_equals_the_jax_cli(tmp_path):
    h5 = tmp_path / "traj.h5"
    write_synthetic_h5(h5, num_frames=5, num_residues=12, seed=2)
    np.save(tmp_path / "traj.charges.npy",
            np.linspace(-1, 1, 12).astype(np.float32))
    flags = ["--mode", "dh", "--pdb_files", "x.pdb", "--traj_files", str(h5),
             "--scratch_dir", str(tmp_path / "s"), "--grid_lengths", "30",
             "25", "20", "--grid_dime", "9", "7", "5"]
    (got_path,) = cli.main(flags + ["--results_dir", str(tmp_path / "p"),
                                    "--device", "cpu"])
    (want_path,) = jax_cli.main(flags + ["--results_dir",
                                         str(tmp_path / "j")])
    got, want = np.load(got_path), np.load(want_path)
    assert got.shape == want.shape == (5, 9, 7, 5)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the same flags as the JAX CLI, plus --device
    ours = vars(cli.parse_args(flags + ["--results_dir", "r"]))
    assert ours.pop("device") is None
    assert ours == vars(jax_cli.parse_args(flags + ["--results_dir", "r"]))
