"""``edge_mlp``'s bound from bytes and operations over its traced time
(device operations named ``edge_mlp_*``)."""

from portbench.metrics._common import kernel_roofline


def read(run):
    return kernel_roofline(run, "edge_mlp", "edge_mlp_")
