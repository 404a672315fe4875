"""The traced run's device timeline, from ``torch.profiler``.

``Trace`` reads the profiler's raw events once: the device's operations
(kernels, copies, sets) and the host's, and the window, which is the span
of the host event named ``WINDOW`` that the harness opens around the
timed work. Every device interval is clipped to the window. The device's
busy time is the length of the union of its intervals, so kernels that
overlap count once; idle is the rest of the window. A host annotation
(``record_function``, the window's own span among them) is mirrored on
the device's timeline; such events are no operation and are left out.
"""

from __future__ import annotations

import collections

WINDOW = "portbench.window"


def _union(intervals):
    """Merged, sorted (start, end) pairs of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, prof):
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        host, device, window = [], [], None
        for ev in events:
            start = ev.start_ns()
            end = start + ev.duration_ns()
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                device.append((start, end, name))
            else:
                if name == WINDOW:
                    window = (start, end)
                host.append((start, end, name))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        annotations = {n for _, _, n in host}
        device = [d for d in device if d[2] not in annotations]
        lo, hi = window
        self.window = window
        self.window_s = (hi - lo) / 1e9
        self.device = [(max(s, lo), min(e, hi), n) for s, e, n in device
                       if e > lo and s < hi]
        self.host = host
        self.busy = _union((s, e) for s, e, _ in self.device)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the device operations whose names hold ``pattern``."""
        return sum(e - s for s, e, n in self.device if pattern in n) / 1e9

    def launches(self, pattern: str) -> int:
        return sum(1 for _, _, n in self.device if pattern in n)

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for s, e, n in self.device:
            by[n[:120]] += (e - s) / 1e9
        return [[n, v] for n, v in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle time of the device in the window, by the innermost host
        event running at each gap's middle."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted((s, e, n) for s, e, n in self.host if n != WINDOW)
        by = collections.Counter()
        active, i = [], 0
        for s, e in gaps:             # gaps come in time order
            mid = (s + e) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            inner = max(active, default=None)      # the latest to start
            by[inner[2][:120] if inner else "host: outside any op"] += \
                (e - s) / 1e9
        return [[n, v] for n, v in by.most_common(top)]
