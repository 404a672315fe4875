"""The control of an FNO-3d cell (``entries/train_fno3d.py``): the same
first ``check.steps`` steps in the precision just below the
configuration's f32, judged as a run judges the program. A sound limit
passes every run of the program and fails this.

    python3 -m portbench.control_fno3d --workload <cell> --seeds 1,2,3 \
        [--control tf32|program|tf32-operands]

The three controls are ``control_fno.py``'s, with FNO-3d's entry: the
program with TF32 on (``tf32``, the default), the program as a run takes
it (``program``), and the reference with every product's operands
rounded to TF32's mantissa in the program's place (``tf32-operands``,
the CPU's control). Each seed prints ``loss_gap``, ``grad_gap`` and
``move_gap`` against the reference in f32, with the cell's limits.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import run as harness
from portbench.control_fno import tf32
from portbench.entries import train_curriculum
from portbench.entries import train_fno3d as entry
from portbench.reference import train as ref_train


def readings(cell: str, seed: int, control: str = "tf32", device="cuda",
             root=harness.ROOT) -> dict:
    bench = harness.load_json(root / "BENCHMARK.json")
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    r = harness.Run(bench, spec, seed, 10.0, False, torch.device(device),
                    root)
    if control == "tf32-operands":
        entry.inputs(r)
        low = entry.reference(r, "tf32")
        p0 = dict(ref_train.leaves(r.params))
        wd = r.mix["weight_decay"]
        got = {"losses": low["losses"],
               "mu1": {k: (1 - ref_train.B1) * (g + wd * p0[k])
                       for k, g in low["grad1"].items()},
               "params": low["params"]}
    else:
        tf32(control == "tf32")
        try:
            entry.setup(r)
        finally:
            tf32(False)
        entry.release(r)
        gc.collect()
        if r.device.type == "cuda":
            torch.cuda.empty_cache()
        got = r.recorded
    out = train_curriculum.readings(r, got, entry.reference(r))
    return dict(out, cell=cell, seed=seed, control=control,
                limits=r.config["limits"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default="tf32",
                   choices=("tf32", "program", "tf32-operands"))
    a = p.parse_args(argv)
    for seed in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(seed), a.control)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
