"""The trace's arithmetic on a made-up timeline: the union of device
intervals (overlaps count once), clipping to the window, host
annotations mirrored on the device left out, idle gaps by host op."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.trace import WINDOW, Trace


def event(name, start, end, device):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU)


def fake(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_union_clip_and_annotations():
    t = Trace(fake([
        event(WINDOW, 100, 1100, False),
        event(WINDOW, 100, 1100, True),          # its mirror on the device
        event("kernel_a", 50, 300, True),        # clipped to 100..300
        event("kernel_b", 200, 400, True),       # overlaps a
        event("kernel_a", 600, 700, True),
        event("kernel_c", 1050, 1300, True),     # clipped to 1050..1100
        event("cudaGraphLaunch", 450, 550, False),
        event("cudaDeviceSynchronize", 700, 1050, False),
    ]))
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((300 + 100 + 50) * 1e-9)
    assert t.kernel_s("kernel_a") == pytest.approx(300e-9)
    assert t.launches("kernel_a") == 2
    assert WINDOW not in dict(t.device_ops())
    gaps = dict(t.idle_gaps())
    assert gaps["cudaGraphLaunch"] == pytest.approx(200e-9)
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(350e-9)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
