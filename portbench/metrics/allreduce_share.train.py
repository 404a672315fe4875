"""The collectives' share of the device's time in the traced window:
the NCCL kernels' time over the union of this rank's device intervals
(rank 0's trace)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    spent = run.trace.kernel_s("nccl")
    if spent <= 0:
        return None
    return 100.0 * spent / run.trace.busy_s
