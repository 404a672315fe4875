"""Percent of the device's busy time in the window spent in operations
that are not matrix products: the elementwise passes, copies, casts and
reductions, which on the dense graph are the passes over the
(B, R, R, width, width) kernel tensor (its mask and casts, the sums of
its gradient). The union of their intervals over the union of all."""

from portbench.trace import _union

# names of the card's matrix-product kernels (cuBLAS, cuBLASLt, CUTLASS)
PRODUCTS = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce",
            "dot_kernel")


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    other = _union((s, e) for s, e, n in run.trace.device
                   if not any(p in n.lower() for p in PRODUCTS))
    return 100.0 * sum(e - s for s, e in other) / 1e9 / run.trace.busy_s
