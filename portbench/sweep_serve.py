"""Find the knee of a serving cell once, by a sweep on the card: the
highest offered rate at which the backlog (requests submitted and not
yet back) does not grow over the window.

    python3 -m portbench.sweep_serve --workload bba.serve.open \
        --rates 100,150,200,250 --seconds 10 --seed 1

One server, set up as a run sets it up, serves the cell's open loop at
each rate in turn. For each rate it prints the requests offered and
completed, the backlog at the middle and at the end of the arrivals, the
median and 95th percentile latency from when each was due, and the
served steps a second. The cell's mix then holds 0.8 of the knee as its
fixed ``rate_per_s``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from portbench import run as harness
from portbench.entries import serve_kernels
from portbench.traffic import generate


def sweep(cell: str, rates, seconds: float, seed: int) -> list:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    r = harness.Run(bench, spec, seed, seconds, False, torch.device("cuda"))
    serve_kernels.setup(r)
    srv, aa = r.state["server"], r.state["aa"]
    out = []
    try:
        for rate in rates:
            mix = dict(r.mix, rate_per_s=rate)
            traffic = generate.make(mix, r.model, seed, seconds)
            t0 = time.perf_counter()
            due = t0 + traffic["due"]
            done = np.full(len(due), np.nan)
            futs, backlog = [], {}
            before = srv.stats
            for i in range(len(due)):
                wait = due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                f = srv.submit(aa, traffic["windows"][i],
                               int(traffic["lengths"][i]))
                f.add_done_callback(
                    lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
                futs.append(f)
                if i == len(due) // 2:
                    backlog["middle"] = sum(not x.done() for x in futs)
            backlog["end"] = sum(not x.done() for x in futs)
            for f in futs:
                f.result(timeout=300)
            wall = time.perf_counter() - t0
            lat = (done - due) * 1e3
            after = srv.stats
            out.append({
                "rate_per_s": rate, "offered": len(due),
                "backlog_middle": backlog["middle"],
                "backlog_end": backlog["end"],
                "p50_ms": float(np.percentile(lat, 50)),
                "p95_ms": float(np.percentile(lat, 95)),
                "served_steps_per_s": (after["steps_served"]
                                       - before["steps_served"]) / wall,
                "occupancy": (after["steps_served"] - before["steps_served"])
                / max(1, after["steps_computed"] - before["steps_computed"]),
            })
            print(json.dumps(out[-1]), flush=True)
    finally:
        serve_kernels.release(r)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    sweep(a.workload, [float(x) for x in a.rates.split(",")], a.seconds,
          a.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
