"""The control of a curriculum cell on the sparse graph (``entries/
train_curriculum_sparse.py``): the plain reference put in the program's
place, computed one precision below the configuration's (fp8, e4m3 with
a scale a tensor, for bf16), and judged as a run judges the program. A
sound limit passes every run of the program and fails this.

    python3 -m portbench.control_curriculum_sparse --workload <cell> \
        --seeds 1,2,3 [--rounding fp8]

For each seed it makes the run's inputs and weights, trains the first
``check.steps`` steps with the reference in ``--rounding`` and prints
``loss_gap``, ``grad_gap`` and ``move_gap`` against the reference in the
configuration's precision, with the cell's limits.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import run as harness
from portbench.entries import _rollout
from portbench.entries import train_curriculum
from portbench.entries import train_curriculum_sparse as entry
from portbench.reference import train as ref_train


def readings(cell: str, seed: int, rounding: str, device="cuda",
             root=harness.ROOT) -> dict:
    bench = harness.load_json(root / "BENCHMARK.json")
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    r = harness.Run(bench, spec, seed, 10.0, False, torch.device(device),
                    root)
    _rollout.inputs(r)
    low = entry.reference(r, rounding)
    p0 = dict(ref_train.leaves(r.params))
    wd = r.mix["weight_decay"]
    got = {"losses": low["losses"],
           "mu1": {k: (1 - ref_train.B1) * (g + wd * p0[k])
                   for k, g in low["grad1"].items()},
           "params": low["params"]}
    out = train_curriculum.readings(r, got, entry.reference(r))
    return dict(out, cell=cell, seed=seed, rounding=rounding,
                limits=r.config["limits"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rounding", default="fp8")
    a = p.parse_args(argv)
    for seed in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(seed), a.rounding)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
