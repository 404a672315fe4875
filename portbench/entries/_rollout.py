"""What the two rollout entries share: inputs, weights, the timed loop
of back-to-back calls, the judgement of their frames and the count of
each step's real edges."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from portbench import weights
from portbench.reference import gkn as ref
from portbench.traffic import generate


def model_config(run):
    """The program's ``ModelConfig`` of the run's model block."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in run.model.items() if k in names})


def inputs(run) -> None:
    """The seed's traffic and weights, on the run's device."""
    run.inputs = generate.make(run.mix, run.model, run.seed, run.seconds)
    run.params = weights.make(run.model, run.config["weights"],
                              generate.seeds(run.seed)[0], run.device)
    run.aa = torch.as_tensor(run.inputs["aa"], device=run.device)


def calls(run, call, deadline: float) -> None:
    """Back-to-back calls until the deadline: ``call(window0)`` returns
    (frames on the host (S, n, R, 3), overflow flag); the last call
    starts before the deadline and is counted whole."""
    pool = run.inputs["windows"]
    i = 0
    while True:
        w0 = pool[i % len(pool)]
        frames, overflow = call(w0)
        run.outputs.append((i % len(pool), frames, overflow))
        run.attempted += 1
        i += 1
        if time.perf_counter() >= deadline:
            return


def frames_per_s(run) -> float:
    return sum(f.shape[0] * f.shape[1] for _, f, _ in run.outputs) \
        / run.window_s


def step_counts(run, w0: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """The reference's contact count of each step of one stream's call:
    step k rebuilds its graph on the last frame of its window, w0's last
    frame for the first step and the program's frame k - 1 after it."""
    lasts = np.concatenate([w0[-1:], frames[:-1]])
    out = []
    for lo in range(0, lasts.shape[0], 4096):
        pos = torch.as_tensor(lasts[lo:lo + 4096], device=run.device)
        out.append(ref.contact_counts(pos, run.model["threshold"]).cpu())
    return torch.cat(out).numpy()


def capacity_flags(run, pairs) -> tuple:
    """For the ranked rebuild of ``max_edges`` slots: how many of the
    (window0 (S, T, R, 3), frames (S, n, R, 3), flag) ``pairs`` the
    reference rebuild overflows, and how many the program's flag misses
    or raises without a cause (with ``exact``) or misses only."""
    over = missed = wrong = 0
    for w0, frames, flag in pairs:
        mine = any(step_counts(run, w0[s], frames[s]).max()
                   > run.model["max_edges"] for s in range(frames.shape[0]))
        over += mine
        missed += mine and not flag
        wrong += flag and not mine
    return over, missed, wrong


def judge(run) -> list:
    """Every call: finite frames and the program's overflow flag the
    reference rebuild's (under the ranked rebuild, a frame over its
    ``max_edges`` slots keeps its first ones in row-major order, which the
    reference does too; the cell list must not overflow at all). A sample
    of calls drawn from the seed (``check.calls`` of the mix, the last
    call always among them): every frame of every stream against the
    reference step from the program's own frames, ``frame_gap`` and
    ``frame_rms_gap`` of ``reference.gkn.judge_call`` against the
    configuration's limits."""
    model, clip = run.model, run.mix.get("clip")
    n = len(run.outputs)
    finite = all(np.isfinite(f).all() for _, f, _ in run.outputs)
    run.failed = sum(1 for _, f, _ in run.outputs if not np.isfinite(f).all())
    rng = np.random.default_rng(generate.seeds(run.seed)[2])
    k = min(n, run.mix["check"]["calls"])
    picked = sorted(set(rng.choice(n - 1, size=k - 1, replace=False)
                        .tolist() if k > 1 else []) | {n - 1})
    gap, rms, ref_over = 0.0, 0.0, False
    with torch.no_grad():
        for c in picked:
            p, frames, _ = run.outputs[c]
            for s in range(frames.shape[0]):
                w0 = torch.as_tensor(run.inputs["windows"][p][s],
                                     device=run.device)
                got = ref.judge_call(
                    run.params, model, run.aa, w0,
                    torch.as_tensor(frames[s], device=run.device), clip)
                gap = max(gap, got["gap"])
                rms = max(rms, got["rms_gap"])
                ref_over = ref_over or got["overflow"]
        if model.get("neighbor_impl") == "cell_list":
            flagged = sum(1 for _, _, o in run.outputs if o)
            flags = [("calls_overflowed", flagged, 0, flagged == 0),
                     ("reference_overflowed", int(ref_over), 0,
                      not ref_over)]
        else:
            over, missed, wrong = capacity_flags(
                run, [(run.inputs["windows"][p], f, o)
                      for p, f, o in run.outputs])
            print(f"calls over {model['max_edges']} edges (the reference "
                  f"rebuild): {over} of {n}", file=sys.stderr)
            flags = [("overflow_flags_wrong", missed + wrong, 0,
                      missed + wrong == 0)]
    limits = run.config["limits"]
    return [("calls_finite", int(finite), 1, finite)] + flags + [
        ("frame_gap", gap, limits["frame_gap"], gap <= limits["frame_gap"]),
        ("frame_rms_gap", rms, limits["frame_rms_gap"],
         rms <= limits["frame_rms_gap"]),
    ]


def real_edges(run) -> None:
    """Each timed step's real edge count, from the window its graph is
    built on (the reference's count of the contact pairs)."""
    reals = np.concatenate([
        step_counts(run, run.inputs["windows"][p][s], frames[s])
        for p, frames, _ in run.outputs for s in range(frames.shape[0])])
    if run.model.get("neighbor_impl") != "cell_list":
        reals = np.minimum(reals, run.model["max_edges"])
    run.work["real_edges"] = reals
    run.work["steps"] = int(reals.shape[0])
