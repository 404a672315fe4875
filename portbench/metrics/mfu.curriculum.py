"""The curriculum's arithmetic in the window (``counts/gkn_dense.py`` at
the program's counters: ``dense_pairs`` over ``curriculum_unrolled``
model steps, 3x the forward for each of the ``curriculum_supervised``)
over the traced window times the chips' published peak."""

from portbench.counts import gkn_dense
from portbench.counts.peaks import FLOPS


def read(run):
    counts = getattr(run, "counters", None) or {}
    unrolled = counts.get("curriculum_unrolled", 0)
    if run.trace is None or not unrolled or not counts.get("dense_pairs"):
        return None
    pairs = counts["dense_pairs"] / unrolled
    b = pairs / run.model["num_residues"] ** 2
    flops = gkn_dense.curriculum_flops(
        run.model, pairs, b, unrolled, counts.get("curriculum_supervised", 0))
    peak = FLOPS[run.model["compute_dtype"]] * run.chips
    return 100.0 * flops / (run.trace.window_s * peak)
