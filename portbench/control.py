"""The control of a rollout or serving cell: the plain reference put in
the program's place, computed one precision below the configuration's
(fp8, e4m3 with a scale a tensor, for bf16), and judged as a run judges
the program. A sound limit passes every run of the program and fails
this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 \
        [--calls 2] [--rounding fp8] [--fault half|altered]

For each seed it makes the run's inputs and weights. A rollout or
serving cell's control rolls from the first ``--calls`` start windows (a
calls mix: ``steps_per_call`` steps; an open loop: the first requests'
lengths) and prints the largest ``frame_gap`` and ``frame_rms_gap``
(``reference.gkn.judge_call``) with the cell's limits. A training cell's
control trains the first steps and prints ``loss_gap``, ``grad_gap`` and
``move_gap``; with ``--rounding bfloat16 --fault ...`` it reads one of
the training faults instead.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import run as harness
from portbench import weights
from portbench.reference import gkn as ref
from portbench.traffic import generate


def readings(cell: str, seed: int, calls: int, rounding: str,
             device="cuda", root=harness.ROOT, fault: str = "") -> dict:
    bench = harness.load_json(root / "BENCHMARK.json")
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    r = harness.Run(bench, spec, seed, 10.0, False, torch.device(device),
                    root)
    inputs = generate.make(r.mix, r.model, seed, r.seconds)
    params = weights.make(r.model, r.config["weights"],
                          generate.seeds(seed)[0], r.device)
    aa = torch.as_tensor(inputs["aa"], device=r.device)
    if r.mix["kind"] == "epochs":
        r.inputs, r.params, r.aa = inputs, params, aa
        return dict(train_control(r, rounding, fault), cell=cell,
                    seed=seed, rounding=rounding, fault=fault,
                    limits=r.config["limits"])
    clip = r.mix.get("clip")
    gap = rms = 0.0
    with torch.no_grad():
        for c in range(calls):
            if r.mix["kind"] == "calls":
                w0 = torch.as_tensor(inputs["windows"][c], device=r.device)
                n = inputs["steps_per_call"]
            else:
                w0 = torch.as_tensor(inputs["windows"][c][None],
                                     device=r.device)
                n = int(inputs["lengths"][c])
            frames, _ = ref.free_rollout(params, r.model, aa, w0, n, clip,
                                         rounding)
            for s in range(w0.shape[0]):
                got = ref.judge_call(params, r.model, aa, w0[s], frames[s],
                                     clip)
                gap = max(gap, got["gap"])
                rms = max(rms, got["rms_gap"])
    return {"cell": cell, "seed": seed, "rounding": rounding,
            "frame_gap": gap, "frame_rms_gap": rms,
            "limits": r.config["limits"]}


def train_control(r, rounding: str, fault: str = "") -> dict:
    """A training cell's numbers with the reference in ``rounding`` in the
    program's place: its losses, its first moment after step 1 and its
    weights after the steps. ``fault`` plants one of the training faults
    in it: "half" leaves half of each batch out and takes the rest twice
    (the mean over the rest, in the sum's scale); "altered" alters the
    answer where it is made: the first conv's root moves double;
    "exchange" leaves the exchange between ranks out: rank 0 of
    ``ranks`` steps on its own rows' loss and gradients alone."""
    from portbench.entries import train_steps
    from portbench.reference import train as ref

    mix = r.mix
    batches = train_steps.batches(r)
    if fault == "half":
        batches = [{k: torch.cat([v[:len(v) // 2]] * 2) for k, v in b.items()}
                   for b in batches]
    if fault == "exchange":
        n = mix.get("ranks", 1)
        batches = [{k: v[:len(v) // n] for k, v in b.items()}
                   for b in batches]
    low = ref.train(r.params, r.model, r.aa, batches,
                    mix["lr"], mix["weight_decay"], rounding)
    p0 = dict(ref.leaves(r.params))
    if fault == "altered":
        k = "conv1/root"
        low["params"][k] = p0[k] + 2 * (low["params"][k] - p0[k])
    got = {"losses": low["losses"],
           "mu1": {k: (1 - ref.B1) * (g + mix["weight_decay"] * p0[k])
                   for k, g in low["grad1"].items()},
           "params": low["params"]}
    return train_steps.readings(r, got)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=2)
    p.add_argument("--rounding", default="fp8")
    p.add_argument("--fault", default="",
                   choices=("", "half", "altered", "exchange"),
                   help="a training cell's planted fault")
    a = p.parse_args(argv)
    for seed in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(seed), a.calls,
                                  a.rounding, fault=a.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
