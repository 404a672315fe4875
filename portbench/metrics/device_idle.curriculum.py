"""Device idle share of the curriculum's traced window (union of device
intervals)."""

from portbench.metrics._common import device_idle


def read(run):
    return device_idle(run)
