"""Electrostatics preprocessing: MD trajectory -> potential grids
(``molecular_dynamics_neural_operator_tpu/preprocess/electrostatics.py``).

The reference pipeline (its ``preprocess.py:18-131``): per
trajectory frame, write a temporary PDB, run ``pdb2pqr30``, render an APBS
input from the template (the port's own copy,
``templates/electrostatics.in.tmpl``: the same physical parameters), run
``apbs``, parse the ``.dx`` potential grid, and write chunked ``.npy``
files every ``save_interval`` frames; trajectories run in a process pool.

- The template renders with jinja2 when it is installed, else by plain
  substitution; both are imported only when used.
- Frames come from MDAnalysis when it is installed, else from a minimal
  multi-MODEL PDB reader, so the orchestration runs without the MD stack.
- The executables are arguments (``pdb2pqr_exe``, ``apbs_exe``), so stub
  programs stand in for them in tests; a non-zero exit raises with its
  code, as in the reference (``preprocess.py:67-68,74-76``).

No tensor is involved: this is host orchestration of external programs.
Grids without those programs are ``preprocess/grid.py``'s screened-Coulomb
grids, computed on the device.
"""

from __future__ import annotations

import subprocess
import uuid
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

PathLike = Union[str, Path]

_TEMPLATE_PATH = Path(__file__).parent / "templates" / "electrostatics.in.tmpl"


def render_apbs_input(pqr_file: PathLike, dx_file: PathLike,
                      template_path: Optional[PathLike] = None) -> str:
    """Render the APBS input deck. ``dx_file`` is written without suffix,
    as APBS appends ``.dx`` itself (preprocess.py:34)."""
    tpl = Path(template_path or _TEMPLATE_PATH).read_text()
    dx_stem = str(Path(dx_file).with_suffix(""))
    try:
        import jinja2

        return jinja2.Template(tpl).render(pqr_file=str(pqr_file),
                                           dx_file=dx_stem)
    except Exception:
        return (
            tpl.replace("{{ pqr_file }}", str(pqr_file))
            .replace("{{ dx_file }}", dx_stem)
        )


def run_subprocess(executable: str, stdout, cwd: Path) -> int:
    """Run a shell command line in ``cwd``; its output and errors go to
    ``stdout``. Returns the exit code."""
    proc = subprocess.run(
        executable, shell=True, stdout=stdout, stderr=subprocess.STDOUT,
        cwd=cwd, encoding="utf-8",
    )
    return proc.returncode


def parse_dx_grid(path: PathLike) -> np.ndarray:
    """Minimal OpenDX scalar-grid parser (in place of gridData).

    Reads ``object 1 class gridpositions counts nx ny nz`` and the data
    section into an (nx, ny, nz) float array.
    """
    counts = None
    values: List[float] = []
    in_data = False
    with open(path) as f:
        for line in f:
            ls = line.strip()
            if ls.startswith("#"):
                continue
            if ls.startswith("object 1 class gridpositions counts"):
                counts = [int(x) for x in ls.split()[-3:]]
                continue
            if ls.startswith("object 3 class array"):
                in_data = True
                continue
            if ls.startswith(("attribute", "component", "object")):
                in_data = False
                continue
            if in_data and ls:
                values.extend(float(v) for v in ls.split())
    if counts is None:
        raise ValueError(f"no grid counts found in {path}")
    arr = np.asarray(values, np.float64)
    if arr.size != counts[0] * counts[1] * counts[2]:
        raise ValueError(
            f"dx data size {arr.size} != counts {counts} in {path}"
        )
    return arr.reshape(counts)


def _iter_frames_pdb(pdb_file: PathLike, traj_file: PathLike):
    """Frame iterator: MDAnalysis if present, else a minimal multi-MODEL
    PDB reader (traj_file may equal pdb_file for single-file trajectories)."""
    try:
        import MDAnalysis as mda

        u = mda.Universe(str(pdb_file), str(traj_file))
        atoms = u.select_atoms("all")

        def write_frame(_ts, out_path):
            atoms.write(str(out_path))

        for ts in u.trajectory:
            yield lambda out_path, ts=ts: write_frame(ts, out_path)
        return
    except ImportError:
        pass

    text = Path(traj_file).read_text()
    if "MODEL" in text:
        frames = []
        current: List[str] = []
        for line in text.splitlines():
            if line.startswith("MODEL"):
                current = []
            elif line.startswith("ENDMDL"):
                frames.append("\n".join(current) + "\nEND\n")
            elif line.startswith(("ATOM", "HETATM", "TER")):
                current.append(line)
        if not frames:
            frames = [text]
    else:
        frames = [text]
    for frame_text in frames:
        yield lambda out_path, t=frame_text: Path(out_path).write_text(t)


def trajectory_to_electrostatic_grid(
    pdb_file: PathLike,
    traj_file: PathLike,
    scratch_dir: PathLike,
    results_dir: PathLike,
    verbose: bool = False,
    save_interval: int = 1000,
    pdb2pqr_exe: str = "pdb2pqr30",
    apbs_exe: str = "apbs",
    template_path: Optional[PathLike] = None,
) -> List[Path]:
    """Convert one trajectory to electrostatic grids; returns written .npy
    paths. Mirrors preprocess.py:39-100 (chunked flushes, temp-file
    lifecycle, fail-fast on nonzero exit codes)."""
    scratch_dir = Path(scratch_dir)
    results_dir = Path(results_dir)
    scratch_dir.mkdir(parents=True, exist_ok=True)
    results_dir.mkdir(parents=True, exist_ok=True)

    tmp_prefix = scratch_dir / str(uuid.uuid4())
    tmp_pdb = tmp_prefix.with_suffix(".pdb")
    tmp_pqr = tmp_prefix.with_suffix(".pqr")
    tmp_log = tmp_prefix.with_suffix(".log")
    tmp_in = tmp_prefix.with_suffix(".in")
    tmp_dx = tmp_prefix.with_suffix(".dx")

    grids: List[np.ndarray] = []
    written: List[Path] = []
    i = -1
    for i, write_frame in enumerate(_iter_frames_pdb(pdb_file, traj_file)):
        write_frame(tmp_pdb)
        with open(tmp_log, "w") as stdout:
            ret = run_subprocess(
                f"{pdb2pqr_exe} {tmp_pdb} {tmp_pqr}", stdout, scratch_dir
            )
            if ret != 0:
                raise ValueError(
                    f"pdb2pqr failed with return code: {ret}"
                )
        tmp_in.write_text(
            render_apbs_input(tmp_pqr, tmp_dx, template_path)
        )
        with open(tmp_log, "w") as stdout:
            ret = run_subprocess(f"{apbs_exe} {tmp_in}", stdout, scratch_dir)
            if ret != 0:
                raise ValueError(f"apbs failed with return code: {ret}")
        grids.append(parse_dx_grid(tmp_dx))

        if i % save_interval == 0 and grids:
            npy = results_dir / (
                Path(traj_file).with_suffix("").name + f"_{i}.npy"
            )
            np.save(npy, np.asarray(grids))
            written.append(npy)
            grids = []

    if grids:
        npy = results_dir / (
            Path(traj_file).with_suffix("").name + f"_{i}.npy"
        )
        np.save(npy, np.asarray(grids))
        written.append(npy)

    for tmp in (tmp_pdb, tmp_pqr, tmp_log, tmp_in, tmp_dx):
        tmp.unlink(missing_ok=True)
    return written


def _worker(kwargs) -> List[Path]:
    return trajectory_to_electrostatic_grid(**kwargs)


def parallel_trajectory_to_electrostatic_grid(
    pdb_files: List[PathLike],
    traj_files: List[PathLike],
    scratch_dir: PathLike,
    results_dir: PathLike,
    num_workers: int = 10,
    save_interval: int = 1000,
    **kwargs,
) -> List[Path]:
    """Process-pool fan-out over trajectories (preprocess.py:108-131)."""
    jobs = [
        {
            "pdb_file": pdb,
            "traj_file": traj,
            "scratch_dir": scratch_dir,
            "results_dir": results_dir,
            "save_interval": save_interval,
            "verbose": bool(i % num_workers == 0),
            **kwargs,
        }
        for i, (pdb, traj) in enumerate(zip(pdb_files, traj_files))
    ]
    out: List[Path] = []
    with ProcessPoolExecutor(max_workers=num_workers) as pool:
        for paths in pool.map(_worker, jobs):
            out.extend(paths)
    return out
