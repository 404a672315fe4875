"""The model's FLOPs in the window's steps over the window at peak."""

from portbench.metrics._common import model_mfu


def read(run):
    return model_mfu(run)
