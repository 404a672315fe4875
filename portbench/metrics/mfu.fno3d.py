"""FNO-3d's arithmetic in the window (``counts/fno3d.py``'s train step at
the program's counters: ``fno3d_steps`` steps over ``fno3d_points`` grid
points, B * R^2 * (T + pad) a step) over the traced window times the
chips' published peak in the configuration's compute type (f32: 67
TFLOP/s)."""

from portbench.counts import fno3d
from portbench.counts.peaks import FLOPS


def read(run):
    counts = getattr(run, "counters", None) or {}
    steps, points = counts.get("fno3d_steps", 0), counts.get("fno3d_points")
    if run.trace is None or not steps or not points:
        return None
    r = run.model["num_residues"]
    b = points / steps / (r * r * fno3d.padded_time(run.model))
    flops = steps * fno3d.block_step_flops(run.model, b, r)
    peak = FLOPS[run.model["compute_dtype"]] * run.chips
    return 100.0 * flops / (run.trace.window_s * peak)
