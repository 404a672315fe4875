"""Arithmetic several readers share."""

from __future__ import annotations

from portbench.counts import gkn
from portbench.counts.peaks import FLOPS, bound_s


def device_idle(run):
    """Percent of the traced window in which no operation ran on the
    device: 100 * (1 - union of device intervals / window)."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def model_mfu(run):
    """The model's arithmetic in the window's steps (each step's real
    edges, as the reference counts them) over the traced window times
    the chips' published peak in the configuration's compute type."""
    if run.trace is None or "real_edges" not in run.work:
        return None
    flops = sum(gkn.step_flops(run.model, float(e))
                for e in run.work["real_edges"])
    peak = FLOPS[run.model["compute_dtype"]] * run.chips
    return 100.0 * flops / (run.trace.window_s * peak)


def kernel_roofline(run, kernel: str, pattern: str):
    """Percent of a kernel's traced time that its bound from bytes and
    operations would take, summed over the window's steps (one launch a
    step, one stream)."""
    if run.trace is None or "real_edges" not in run.work:
        return None
    spent = run.trace.kernel_s(pattern)
    if spent <= 0:
        return None
    return 100.0 * gkn.kernel_bound_s(kernel, run.model,
                                      run.work["real_edges"]) / spent


def train_mfu(run):
    """The train steps' arithmetic (forward and a backward of twice it,
    at each step's real edges) over the traced window times the chips'
    peak."""
    if run.trace is None or not run.work.get("train_steps"):
        return None
    steps, b = run.work["train_steps"], run.work["batch_size"]
    flops = steps * gkn.train_step_flops(
        run.model, run.work["train_real_edges"] / steps, b)
    peak = FLOPS[run.model["compute_dtype"]] * run.chips
    return 100.0 * flops / (run.trace.window_s * peak)


def train_kernel_roofline(run, kernel: str, pattern: str):
    """A training kernel's bound over its traced time, one launch a step
    at the steps' mean real edges (every batch is bound by its bytes, so
    the sum of bounds is the bound at the mean)."""
    if run.trace is None or not run.work.get("train_steps"):
        return None
    spent = run.trace.kernel_s(pattern)
    launches = run.trace.launches(pattern)
    if spent <= 0 or not launches:
        return None
    steps, b = run.work["train_steps"], run.work["batch_size"]
    fn = getattr(gkn, kernel)
    one = bound_s(*fn(run.model, run.work["train_real_edges"] / steps, b))
    return 100.0 * launches * one / spent
