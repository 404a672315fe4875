"""A copy of the benchmark at a size the CPU runs in seconds: the whole
``portbench`` folder and ``BENCHMARK.json`` copied, tiny configurations
and mixes ADDED beside the real ones (no copied file is edited), and the
copied ``BENCHMARK.json`` pointed at them. ``execute`` runs a cell of
the copy in a fresh process on the CPU, with the program's plain path;
``patch`` is Python run in that process before the cell, which is how a
test breaks the timed path underneath. With ``widths`` the copy keeps the
configurations' published widths and cuts only the atoms and steps.

The copy also carries ``ONE_RANK``, a cell the benchmark does not have:
the training mix on one process (``train_steps`` without ``ranks``, over
``train/loop.py::make_train_step``), so that this path of the entry
stays tested for the cell that would add it by data alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL = {"width": 8, "ker_width": 64, "depth": 2}
TRAFFIC = {"rollout_1000": {"steps_per_call": 24},
           "rollout_8_fresh": {"pool": 3},
           "serve_open": {"rate_per_s": 20.0, "length_max": 96},
           "train_dp4": {"batch_size": 8,
                         "start": {"source": "chain", "num_frames": 120,
                                   "chain_seed": 13}}}
ONE_RANK = "bba.train.one"


def make(tmp: Path, widths: bool = False) -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  ".trials", "out"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        src = REPO / c["file"]
        cfg = json.loads(src.read_text())
        if not widths:
            cfg["model"].update(SMALL)
        if cfg["model"]["num_residues"] > 512:
            cfg["model"].update(num_residues=600,
                                max_edges=600 * cfg["model"]["max_degree"])
        c["file"] = c["file"].replace(".json", "_tiny.json")
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        mix = json.loads((root / "portbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        mix.update(TRAFFIC.get(w["traffic"], {}))
        w["traffic"] = w["traffic"] + "_tiny"
        (root / "portbench" / "traffic"
         / f"{w['traffic']}.json").write_text(json.dumps(mix))
    _add_one_rank(root, bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _add_one_rank(root: Path, bench: dict) -> None:
    """The four-rank training cell's mix and metrics on one process."""
    four = next(w for w in bench["workloads"] if w["chips"] == 4
                and w["traffic"].startswith("train_"))
    mix = json.loads((root / "portbench" / "traffic"
                      / f"{four['traffic']}.json").read_text())
    del mix["ranks"]
    (root / "portbench" / "traffic" / "train_one_tiny.json").write_text(
        json.dumps(mix))
    bench["workloads"].append(dict(four, name=ONE_RANK, chips=1,
                                   traffic="train_one_tiny"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if (four["name"] in m.get("workloads", [])
                and not m["name"].startswith("allreduce")):
            m["workloads"].append(ONE_RANK)


def execute(root: Path, cell: str, seed: int = 3_000_000_007,
            seconds: float = 1.0, trace: int = 0, patch: str = "") -> dict:
    """The result line of one run; ``patch`` runs first in this process
    and in every rank it spawns (as their ``sitecustomize``)."""
    site = root / "_patch"
    site.mkdir(exist_ok=True)
    (site / "sitecustomize.py").write_text(patch)
    code = (
        "import json, sys\n"
        "from portbench import run\n"
        f"args = run.parse(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'])\n"
        "print(json.dumps(run.execute(args, require_cuda=False, "
        "device='cpu')))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(site), str(root), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])
