"""The FNO curriculum's arithmetic in the window (``counts/fno.py`` at
the program's counters: ``fno_points`` grid points over
``curriculum_unrolled`` model steps, 3x the forward for each of the
``curriculum_supervised``) over the traced window times the chips'
published peak in the configuration's compute type (f32: 67 TFLOP/s)."""

from portbench.counts import fno
from portbench.counts.peaks import FLOPS


def read(run):
    counts = getattr(run, "counters", None) or {}
    unrolled = counts.get("curriculum_unrolled", 0)
    if run.trace is None or not unrolled or not counts.get("fno_points"):
        return None
    r = run.model["num_residues"]
    b = counts["fno_points"] / unrolled / r ** 2
    flops = fno.curriculum_flops(run.model, b, r, unrolled,
                                 counts.get("curriculum_supervised", 0))
    peak = FLOPS[run.model["compute_dtype"]] * run.chips
    return 100.0 * flops / (run.trace.window_s * peak)
