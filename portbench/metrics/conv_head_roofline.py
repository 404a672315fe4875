"""``conv_head``'s bound from bytes and operations over its traced time
(device operations named ``conv_head_kernel*``)."""

from portbench.metrics._common import kernel_roofline


def read(run):
    return kernel_roofline(run, "conv_head", "conv_head_kernel")
