"""``train_conv_fwd``'s bound from bytes and operations over its traced time
(device operations named ``train_conv_fwd_kernel*``)."""

from portbench.metrics._common import train_kernel_roofline


def read(run):
    return train_kernel_roofline(run, "train_conv_fwd",
                                 "train_conv_fwd_kernel")
