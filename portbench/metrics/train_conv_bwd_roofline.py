"""``train_conv_bwd``'s bound from bytes and operations over its traced time
(device operations named ``train_conv_bwd_kernel*``)."""

from portbench.metrics._common import train_kernel_roofline


def read(run):
    return train_kernel_roofline(run, "train_conv_bwd",
                                 "train_conv_bwd_kernel")
