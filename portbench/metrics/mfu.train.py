"""The train steps' FLOPs (3x the forward's) over the window at peak."""

from portbench.metrics._common import train_mfu


def read(run):
    return train_mfu(run)
