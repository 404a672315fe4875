"""``graph_encode``'s bound from bytes and operations over its traced time
(device operations named ``graph_encode_kernel*``)."""

from portbench.metrics._common import kernel_roofline


def read(run):
    return kernel_roofline(run, "graph_encode", "graph_encode_kernel")
