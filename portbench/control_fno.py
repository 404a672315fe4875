"""The control of an FNO curriculum cell (``entries/
train_fno_curriculum.py``): the same first ``check.steps`` steps in the
precision just below the configuration's f32, judged as a run judges the
program. A sound limit passes every run of the program and fails this.

    python3 -m portbench.control_fno --workload <cell> --seeds 1,2,3 \
        [--control tf32|program|tf32-operands]

For each seed it makes the run's inputs and weights and prints
``loss_gap``, ``grad_gap`` and ``move_gap`` against the reference in f32,
with the cell's limits, of:

- ``tf32`` (the default): the program itself, its steps taken with
  ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` on, so that the card may run its
  f32 products on TF32 tensor cores;
- ``program``: the program as a run takes it (TF32 off), the readings a
  run's judgement gives, without the window;
- ``tf32-operands``: the reference with every product's operands
  rounded to TF32's mantissa, in the program's place (the CPU's
  control, where the flags move no product).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import run as harness
from portbench.entries import train_curriculum
from portbench.entries import train_fno_curriculum as entry
from portbench.reference import train as ref_train


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


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
