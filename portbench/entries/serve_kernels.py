"""Requests served by ``serving/server.py::RolloutServer`` on the
hand-written kernels (``impl="persistent"``), in one process, under an
open loop: each request is submitted when it is due, whatever the server
is doing, and timed from when it was due until its result is on the
host (the future resolves in the server's reader thread)."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench.entries import _rollout
from portbench.reference import gkn as ref
from portbench.traffic import generate

DRAIN_S = 60.0   # how long past the last arrival a request may take


def setup(run) -> None:
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )

    _rollout.inputs(run)
    cfg = _rollout.model_config(run)
    mix = run.mix
    aa_np = np.asarray(run.inputs["aa"], np.int32)
    srv = RolloutServer(
        run.params, cfg, segment_steps=mix["segment_steps"],
        max_streams=mix["max_streams"], threshold=run.model["threshold"],
        clip=mix.get("clip"), impl="persistent", aa=aa_np,
        device=run.device)
    srv.warmup()
    # one pass of every stream count through the reader's copies
    warm = [(aa_np, run.inputs["windows"][i % len(run.inputs["windows"])],
             mix["segment_steps"] + 1) for i in range(mix["max_streams"])]
    for fut in srv.submit_many(warm):
        fut.result(timeout=300)
    run.state = {"server": srv, "aa": aa_np, "before": srv.stats}


def window(run, deadline: float) -> None:
    srv, aa = run.state["server"], run.state["aa"]
    t0 = deadline - run.seconds
    due = t0 + run.inputs["due"]
    n = len(due)
    done = np.full(n, np.nan)
    futures, late = [], 0.0

    def finished(i):
        def mark(_fut):
            done[i] = time.perf_counter()
        return mark

    for i in range(n):
        wait = due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.perf_counter() - due[i])
        fut = srv.submit(aa, run.inputs["windows"][i],
                         int(run.inputs["lengths"][i]))
        fut.add_done_callback(finished(i))
        futures.append(fut)
    results = []
    end = time.perf_counter() + DRAIN_S
    for fut in futures:
        try:
            left = max(0.0, end - time.perf_counter())
            results.append(fut.result(timeout=left))
        except Exception:  # noqa: BLE001: a request that never came back
            results.append(None)
    after = srv.stats
    before = run.state["before"]
    run.counters = {k: after[k] - before[k] for k in
                    ("segments_run", "steps_computed", "steps_served",
                     "requests_completed")}
    run.outputs = results
    run.latency_s = done - due
    run.generator_late_s = late
    run.attempted = n
    run.failed = sum(1 for r in results if r is None)


def release(run) -> None:
    run.state["server"].close()
    run.state = None


def end_to_end(run) -> dict:
    lat = run.latency_s
    lat = np.where(np.isnan(lat), np.inf, lat)      # a lost request misses
    return {"request_p95_ms": float(np.percentile(lat, 95)) * 1e3}


def judge(run) -> list:
    """Every request came back, finite, and flagged where the reference
    rebuild overflows its ``max_edges`` slots on the request's frames
    (the server's kernels keep one flag for all streams of a segment, so
    a request that shares a segment with an overflowing one is flagged
    too: a flag without a cause of its own is right). A sample drawn from
    the seed (``check.requests`` of the mix, the longest request always
    among them): every served frame against the reference's step from
    the window the request's own frames make, ``frame_gap`` and
    ``frame_rms_gap`` against the configuration's limits."""
    results, n = run.outputs, len(run.outputs)
    came = [i for i, r in enumerate(results) if r is not None]
    finite = all(np.isfinite(results[i].coords).all() for i in came)
    over, missed, _ = _rollout.capacity_flags(
        run, [(run.inputs["windows"][i][None], results[i].coords[None],
               results[i].edge_overflow) for i in came])
    print(f"requests over {run.model['max_edges']} edges (the reference "
          f"rebuild): {over}; flagged: "
          f"{sum(1 for i in came if results[i].edge_overflow)}",
          file=sys.stderr)
    rng = np.random.default_rng(generate.seeds(run.seed)[2])
    longest = max(came, key=lambda i: run.inputs["lengths"][i]) if came \
        else None
    k = min(len(came), run.mix["check"]["requests"])
    picked = set(rng.choice(came, size=k, replace=False).tolist()) \
        if k else set()
    if longest is not None:
        picked.add(longest)
    gap, rms = 0.0, 0.0
    with torch.no_grad():
        for i in sorted(picked):
            got = ref.judge_call(
                run.params, run.model, run.aa,
                torch.as_tensor(run.inputs["windows"][i], device=run.device),
                torch.as_tensor(results[i].coords, device=run.device),
                run.mix.get("clip"))
            gap = max(gap, got["gap"])
            rms = max(rms, got["rms_gap"])
            if results[i].coords.shape[0] != run.inputs["lengths"][i]:
                gap = float("inf")
    limits = run.config["limits"]
    lost = n - len(came)
    return [
        ("requests_lost", lost, 0, lost == 0),
        ("requests_finite", int(finite), 1, finite),
        ("overflow_flags_missed", missed, 0, missed == 0),
        ("frame_gap", gap, limits["frame_gap"], gap <= limits["frame_gap"]),
        ("frame_rms_gap", rms, limits["frame_rms_gap"],
         rms <= limits["frame_rms_gap"]),
    ]


def work(run) -> None:
    """Each served step's real edge count, from the window its graph was
    built on."""
    reals = np.concatenate([
        _rollout.step_counts(run, run.inputs["windows"][i], res.coords)
        for i, res in enumerate(run.outputs) if res is not None])
    run.work["real_edges"] = np.minimum(reals, run.model["max_edges"])
    run.work["steps"] = int(reals.shape[0])
