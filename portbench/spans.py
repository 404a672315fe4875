"""The program's spans on the device's timeline.

``utils/profiling.py::tracing()`` of the port records spans on every
thread with ``time.time_ns()``, the clock of ``torch.profiler``'s host
events, so the spans of a run and its traced window line up. This module
joins the two:

- ``idle_by_span``: each idle gap of the device in the window goes to the
  innermost span open, at the gap's middle, on the thread that launched
  the device operation that ends the gap. The launching thread is that of
  the operation's CUDA runtime event (the launch), which carries the
  operation's correlation id.
- ``device_by_span``: each device operation's time goes to the innermost
  span open on its launching thread when it was launched.

The profiler names a launching thread by its native id (the thread that
started the profiler) or by CUPTI's id, the low 32 bits of
``threading.get_ident()`` (any other thread), read as a signed or an
unsigned 32-bit number; ``Spans.threads`` holds both ids of each thread
that recorded a span. Where no span is open the
time goes to the thread itself ("outside any span (<thread>)"): on the
thread that runs the cell, that is the harness's code. Spans made by
``record()`` belong to no thread and take no part in either breakdown.

``readings`` computes four numbers of the port's layers from them.
``traced`` makes the harness's traced run of a cell (``portbench.run``
with ``--trace 1``, its code unchanged) with the program's spans recorded
while its profiler runs. As a module it prints the result line, the
readings and both breakdowns:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

With ``--cost`` it makes the untraced run (``--trace 0``, no profiler)
with the spans recorded from set-up to the end instead, and prints its
result line, whose end-to-end metrics are then those with ``tracing()``
on, and the count of each span.
"""

from __future__ import annotations

import collections
import json
import sys

import numpy as np

from portbench.trace import WINDOW, _union

AFTER_LAST = "(after the device's last operation)"
UNTRACED = "(launch not in the trace)"


class Timeline:
    """The window (lo, hi), the device's operations in it (start, end,
    correlation id, name) clipped to it, and each correlation id's launch
    (time, the profiler's thread id)."""

    def __init__(self, window, device, launches):
        self.window = window
        lo, hi = window
        self.window_s = (hi - lo) / 1e9
        self.device = sorted((max(s, lo), min(e, hi), c, n)
                             for s, e, c, n in device if e > lo and s < hi)
        self.launches = launches
        self.busy = _union((s, e) for s, e, _, _ in self.device)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9

    @classmethod
    def from_profile(cls, prof) -> "Timeline":
        """From a ``torch.profiler.profile`` after it stopped. Host
        annotations mirrored on the device are no operation (as in
        ``trace.Trace``); a launch is a host event named ``cu*`` with the
        correlation id of a device operation."""
        from torch.autograd import DeviceType

        host, device, window = [], [], None
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                device.append((start, end, ev.correlation_id(), ev.name()))
            else:
                if ev.name() == WINDOW:
                    window = (start, end)
                host.append(ev)
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        names = {ev.name() for ev in host}
        device = [d for d in device if d[3] not in names]
        ids = {c for _, _, c, _ in device}
        launches = {ev.correlation_id(): (ev.start_ns(),
                                          ev.device_resource_id())
                    for ev in host
                    if ev.name().startswith("cu")
                    and ev.correlation_id() in ids}
        return cls(window, device, launches)

    def gaps(self) -> list:
        """(start, end, correlation id of the operation that ends it, or
        None at the window's end) of each idle gap, in time order."""
        lo, hi = self.window
        starts = {}
        for s, _, c, _ in self.device:
            starts.setdefault(s, c)
        edges = [lo] + [x for iv in self.busy for x in iv] + [hi]
        return [(edges[i], edges[i + 1], starts.get(edges[i + 1]))
                for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def thread_names(spans) -> dict:
    """The profiler's id of each thread that recorded a span -> (native
    id, name)."""
    out = {}
    for tid, (name, ident) in getattr(spans, "threads", {}).items():
        low = ident & 0xFFFFFFFF
        for key in (tid, ident, low, low - (1 << 32)):   # signed or not
            out[key] = (tid, name)
    return out


def innermost(spans, queries) -> list:
    """For (time, native thread id) ``queries``, the name of the innermost
    span open then on that thread (the latest to start of those open), or
    None."""
    by_thread = collections.defaultdict(list)
    for s in spans:
        if s.thread is not None:
            by_thread[s.thread].append(s)
    out = [None] * len(queries)
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    asked = collections.defaultdict(list)
    for i in order:
        asked[queries[i][1]].append(i)
    for tid, idx in asked.items():
        # an enclosing span first where two start together
        mine = sorted(by_thread.get(tid, ()),
                      key=lambda s: (s.start_ns, -s.end_ns))
        stack, j = [], 0
        for i in idx:                      # in time order
            t = queries[i][0]
            while j < len(mine) and mine[j].start_ns <= t:
                stack.append(mine[j])
                j += 1
            while stack and stack[-1].end_ns < t:
                stack.pop()
            # a span under the top may have ended: it is popped when it
            # is the top, and the top is the latest to start of the open
            out[i] = stack[-1].name if stack else None
    return out


def _label(name, tid, names) -> str:
    if name is not None:
        return name
    return f"outside any span ({names.get(tid, (tid, str(tid)))[1]})"


def idle_by_span(timeline: Timeline, spans) -> dict:
    """Seconds of device idle in the window by span (``Counter``)."""
    names = thread_names(spans)
    gaps = timeline.gaps()
    queries, where = [], []
    by = collections.Counter()
    for s, e, corr in gaps:
        launch = timeline.launches.get(corr) if corr is not None else None
        if launch is None:
            by[AFTER_LAST if corr is None else UNTRACED] += (e - s) / 1e9
            continue
        tid = names.get(launch[1], (launch[1], None))[0]
        queries.append(((s + e) / 2, tid))
        where.append((s, e))
    for (s, e), (_, tid), name in zip(where, queries,
                                      innermost(spans, queries)):
        by[_label(name, tid, names)] += (e - s) / 1e9
    return by


def device_by_span(timeline: Timeline, spans) -> dict:
    """The device's operations in the window by the span that launched
    them: label -> [(start, end)]."""
    names = thread_names(spans)
    queries, ops = [], []
    out = collections.defaultdict(list)
    for s, e, corr, _ in timeline.device:
        launch = timeline.launches.get(corr)
        if launch is None:
            out[UNTRACED].append((s, e))
            continue
        tid = names.get(launch[1], (launch[1], None))[0]
        queries.append((launch[0], tid))
        ops.append((s, e))
    for op, (_, tid), name in zip(ops, queries, innermost(spans, queries)):
        out[_label(name, tid, names)].append(op)
    return dict(out)


def _in_window(spans, name, window):
    lo, hi = window
    return [s for s in spans if s.name == name and lo <= s.start_ns < hi]


def queue_wait_p95_ms(spans, window):
    """95th percentile, in ms, of ``serve.queued`` over the requests
    submitted in the window."""
    waits = [(s.end_ns - s.start_ns) / 1e6
             for s in _in_window(spans, "serve.queued", window)]
    return float(np.percentile(waits, 95)) if waits else None


def scheduler_busy(spans, window):
    """Percent of the window the server's scheduler spent in
    ``serve.segment``."""
    lo, hi = window
    segs = [s for s in spans if s.name == "serve.segment"]
    if not segs or hi <= lo:
        return None
    inside = sum(max(0, min(s.end_ns, hi) - max(s.start_ns, lo))
                 for s in segs)
    return 100.0 * inside / (hi - lo)


def input_stall(timeline: Timeline, spans):
    """Percent of the window the device sat idle on the trainer's input:
    idle under ``train.wait_batch`` or ``train.put``."""
    if not timeline.device or not any(s.name == "train.step" for s in spans):
        return None
    idle = idle_by_span(timeline, spans)
    return 100.0 * (idle["train.wait_batch"] + idle["train.put"]) \
        / timeline.window_s


def cell_list_share(timeline: Timeline, spans):
    """Percent of the device's busy time in operations launched inside
    ``geometry.cell_list`` (their union)."""
    ops = device_by_span(timeline, spans).get("geometry.cell_list")
    if not ops or timeline.busy_s <= 0:
        return None
    return 100.0 * sum(e - s for s, e in _union(ops)) / 1e9 \
        / timeline.busy_s


def readings(timeline, spans, window) -> dict:
    """The four numbers, where the run holds something to read (a
    timeline is None without a card)."""
    out = {"queue_wait_p95_ms.serve": queue_wait_p95_ms(spans, window),
           "scheduler_busy.serve": scheduler_busy(spans, window)}
    if timeline is not None:
        out["input_stall.train"] = input_stall(timeline, spans)
        out["cell_list_share.rollout"] = cell_list_share(timeline, spans)
    return {k: v for k, v in out.items() if v is not None}


def traced(args, **execute):
    """(result line, profiler, spans) of ``portbench.run.execute(args,
    **execute)`` with the program's ``tracing()`` on while the harness's
    profiler runs (from before the window to after it; nothing with
    ``--trace 0``, whose run starts no profiler)."""
    import torch.profiler

    from molecular_dynamics_neural_operator_tpu_torch.utils import profiling
    from portbench import run as harness

    kept = {}
    base = torch.profiler.profile

    class Profile(base):
        def __enter__(self):
            kept["on"] = profiling.tracing()
            kept["spans"] = kept["on"].__enter__()
            kept["prof"] = self
            return super().__enter__()

        def __exit__(self, *exc):
            try:
                return super().__exit__(*exc)
            finally:
                kept["on"].__exit__(None, None, None)

    torch.profiler.profile = Profile
    try:
        result = harness.execute(args, **execute)
    finally:
        torch.profiler.profile = base
    return result, kept.get("prof"), kept.get("spans")


def spans_on(args, **execute):
    """(result line, spans) of ``portbench.run.execute(args, **execute)``
    with the program's ``tracing()`` on for the whole run."""
    from molecular_dynamics_neural_operator_tpu_torch.utils import profiling
    from portbench import run as harness

    with profiling.tracing() as spans:
        result = harness.execute(args, **execute)
    return result, spans


def report(prof, spans, top: int = 12) -> dict:
    """The readings and both breakdowns of a traced run, in seconds."""
    from portbench.trace import Trace

    host = Trace(prof)                     # the window, on any machine
    timeline = Timeline.from_profile(prof) if _has_device(prof) else None
    out = {"window_s": host.window_s,
           "spans": dict(collections.Counter(s.name for s in spans)),
           "threads": {str(k): v[0] for k, v in spans.threads.items()},
           "readings": readings(timeline, spans, host.window)}
    if timeline is not None:
        idle = idle_by_span(timeline, spans)
        dev = device_by_span(timeline, spans)
        out["busy_s"] = timeline.busy_s
        out["idle_by_span"] = idle.most_common(top)
        out["device_by_span"] = sorted(
            ((k, sum(e - s for s, e in v) / 1e9) for k, v in dev.items()),
            key=lambda kv: -kv[1])[:top]
    return out


def _has_device(prof) -> bool:
    from torch.autograd import DeviceType

    return any(ev.device_type() == DeviceType.CUDA
               for ev in prof.profiler.kineto_results.events())


def main(argv=None) -> int:
    from portbench import run as harness

    argv = list(argv if argv is not None else sys.argv[1:])
    cost = "--cost" in argv
    if cost:
        argv.remove("--cost")
    args = harness.parse(argv + ["--trace", "0" if cost else "1"])
    try:
        if cost:
            result, spans = spans_on(args)
            out = dict(collections.Counter(s.name for s in spans))
        else:
            result, prof, spans = traced(args)
            out = report(prof, spans)
    except harness.Refused as err:
        print(f"portbench.spans: {err}", file=sys.stderr)
        return 2
    print(json.dumps({"result": result, "spans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
