"""Tracing of the port (``molecular_dynamics_neural_operator_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` capture of the block (host and,
  on the card, CUDA activity), written into ``logdir`` as a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``).
- ``span(name, request=None)``: a named interval of host time on the
  calling thread, at a layer boundary of the program. ``record(name,
  start_ns, end_ns, request=None)``: an interval measured by the caller
  that starts on one thread and ends on another.
- ``tracing()``: records the spans of every thread while its block runs
  and hands them back when it ends, as ``Span`` tuples, with the names
  and ids of the threads that recorded them.
- ``count(name, n)``: adds n to the program counter ``name``, a host
  integer that is always on and never reads the device; ``counters()``
  returns them all. A reader takes them before and after its block and
  subtracts. This is the program's one store of counts:
  ``curriculum_steps``, ``curriculum_unrolled``,
  ``curriculum_supervised`` and ``dense_pairs``
  (``train/curriculum.py``); ``plain_tc_linear`` (``ops/mlp.py``: a
  linear layer on tensor cores), ``blocked_bf16_aggregate``
  (``ops/edge_conv.py``: a blocked conv layer as one bf16 product),
  ``fused_edge_mlp`` (``ops/edge_conv.py``: a kernel tensor made by the
  hand-written edge-MLP kernels, whose launches ``edge_mlp`` counts) and
  ``dense_tied_stack`` (``ops/conv_stack.py``: a dense tied conv stack
  with one kernel-tensor gradient); ``fno_points``,
  ``fno_spectral_dft`` and ``fno_spectral_fft`` (``models/fno.py``:
  the FNO curriculum's grid points a model step, a spectral convolution
  by its form; that step counts the ``curriculum_*`` counters too);
  ``fno3d_steps``, ``fno3d_points``, ``fno3d_frames``,
  ``fno3d_spectral_dft`` and ``fno3d_spectral_fft`` (``models/fno3d.py``:
  FNO-3d's block steps, the padded grid points and the forecast frames
  they cover, a spectral convolution by its form); and
  the kernel launches, each under its kernel's name: ``graph_encode``,
  ``edge_mlp``, ``conv_head`` and ``conv_head_wide`` (those of
  ``conv_head`` on the wide plan; ``ops/cuda/persistent_rollout.py``),
  ``train_conv_fwd`` and ``train_conv_bwd`` (``ops/cuda/train_conv.py``)
  and ``fused_edge_conv_stack`` (``ops/cuda/fused_gkn.py``).
- ``held()``: the counts this thread makes in the block go into the dict
  it yields and not into the store. A counter counts what ran, eager or
  replayed: a CUDA graph's capture and its warm-up hold their counts
  (``ops/cuda/graphs.py``), and each replay adds what its capture held.

Spans are stamped with ``time.time_ns()``, the clock of the profiler's
host events, so they lie on one timeline with a ``torch.profiler`` trace
of the same block. The profiler itself records ``record_function``
regions only on the thread that started it; spans are recorded on every
thread, in memory, and nothing is written while the block runs. Outside
``tracing()`` a span costs one read of a module global and returns one
shared object that does nothing. Inside, each thread appends to a list of
its own, with no lock. A CUDA graph's capture records no span
(``paused``): what it captures runs at every replay, where the replay's
own span stands for it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int            # time.time_ns()
    end_ns: int
    thread: Optional[int]    # threading.get_native_id(); None: record()
    parent: Optional[str]    # the enclosing span on this thread
    request: object          # what the span serves: a request's id, a
    #                          graph's name; or None


class Spans(list):
    """The spans of a ``tracing()`` block, sorted by start, and
    ``threads``: native id -> (name, ``threading.get_ident()``) of each
    thread that recorded one."""

    threads: dict


class _Off:
    """What ``span`` returns while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def discard(self) -> None:
        pass


_OFF = _Off()
_session = None              # the tracing() block in progress, or None
_paused = threading.local()  # .on: this thread records nothing


class _Thread:
    """One thread's recorded spans, as plain tuples of ``Span``'s fields,
    and the names of its open ones."""

    __slots__ = ("tid", "ident", "name", "spans", "open")

    def __init__(self):
        self.tid = threading.get_native_id()
        self.ident = threading.get_ident()
        self.name = threading.current_thread().name
        self.spans: list = []
        self.open: list = []


class _Session:
    def __init__(self):
        self._local = threading.local()
        self._threads: list = []
        self._lock = threading.Lock()

    def thread(self) -> _Thread:
        try:
            return self._local.state
        except AttributeError:
            state = self._local.state = _Thread()
            with self._lock:     # once a thread, at its first span
                self._threads.append(state)
            return state

    def spans(self) -> Spans:
        with self._lock:
            threads = list(self._threads)
        out = Spans(sorted((Span._make(s) for t in threads
                            for s in list(t.spans)),
                           key=lambda s: s.start_ns))
        out.threads = {t.tid: (t.name, t.ident) for t in threads}
        return out


class _Open:
    __slots__ = ("_state", "_name", "_request", "_parent", "_start",
                 "_keep")

    def __init__(self, state: _Thread, name: str, request):
        self._state, self._name, self._request = state, name, request
        self._keep = True

    def __enter__(self):
        state = self._state
        self._parent = state.open[-1] if state.open else None
        state.open.append(self._name)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        state = self._state
        state.open.pop()
        if self._keep:
            state.spans.append((self._name, self._start, end, state.tid,
                                self._parent, self._request))
        return False

    def discard(self) -> None:
        """Leave this span out."""
        self._keep = False


def span(name: str, request=None):
    """A context manager timing its block as the span ``name`` while
    ``tracing()`` is on; ``request`` ties the spans of one request. What
    it yields has ``discard()``, which leaves the span out."""
    session = _session
    if session is None:
        return _OFF
    if getattr(_paused, "on", False):
        return _OFF
    return _Open(session.thread(), name, request)


def record(name: str, start_ns: int, end_ns: int, request=None) -> None:
    """Record a span measured by the caller (``time.time_ns()`` stamps)
    that belongs to no one thread: its ``thread`` and ``parent`` are
    None. It is kept with the calling thread's spans."""
    session = _session
    if session is None:
        return
    session.thread().spans.append((name, int(start_ns), int(end_ns), None,
                                   None, request))


@contextlib.contextmanager
def paused():
    """No span of this thread is recorded in the block."""
    before = getattr(_paused, "on", False)
    _paused.on = True
    try:
        yield
    finally:
        _paused.on = before


@contextlib.contextmanager
def tracing():
    """Record every thread's spans while the block runs. Yields a
    ``Spans`` that holds them once the block ends; a span still open then
    is left out. One block at a time."""
    global _session
    if _session is not None:
        raise RuntimeError("tracing() is already on")
    out = Spans()
    out.threads = {}
    session = _session = _Session()
    try:
        yield out
    finally:
        _session = None
        got = session.spans()
        out.extend(got)
        out.threads = got.threads


_counts: dict = {}
_held = threading.local()    # .counts: where this thread's counts go
_holding: list = []          # the dicts of every open held(), oldest first


def count(name: str, n: int = 1) -> None:
    """Add n to the program counter ``name`` (a host integer). Inside
    ``held()`` the count goes to its dict instead. So does a count made
    by a backward node on a thread that holds nothing while a ``held()``
    is open (the latest): the autograd engine runs a CUDA backward on a
    thread of its own while the thread that called it waits, as the
    warm-up and the capture of a graphed training step do."""
    into = getattr(_held, "counts", None)
    if (into is None and _holding
            and torch._C._current_autograd_node() is not None):
        into = _holding[-1]
    if into is None:
        into = _counts
    into[name] = into.get(name, 0) + int(n)


@contextlib.contextmanager
def held():
    """The counts this thread makes in the block, and its backward's on
    the autograd engine's threads, go into the dict it yields, not into
    the store."""
    before = getattr(_held, "counts", None)
    out = _held.counts = {}
    _holding.append(out)
    try:
        yield out
    finally:
        _holding.remove(out)
        _held.counts = before


def counters() -> dict:
    """Every program counter's value so far."""
    return dict(_counts)


_SPANS_PID = 0x5350     # the Chrome trace's process of the spans


def chrome_events(spans, base_ns: int = 0) -> list:
    """Chrome trace events of ``spans``: one process named "program
    spans", a thread a recording thread, in a trace whose ``ts`` is
    microseconds after ``base_ns`` (the profiler's
    ``baseTimeNanoseconds``)."""
    pid = _SPANS_PID
    out = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": "program spans"}}]
    for tid in sorted({s.thread for s in spans} - {None}):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": f"thread {tid}"}})
    for s in spans:
        ev = {"ph": "X", "cat": "span", "name": s.name, "pid": pid,
              "tid": 0 if s.thread is None else s.thread,
              "ts": (s.start_ns - base_ns) / 1e3,
              "dur": (s.end_ns - s.start_ns) / 1e3}
        if s.request is not None:
            ev["args"] = {"request": str(s.request)}
        out.append(ev)
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace.json``, with the
    program's spans of the block on threads of their own."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with tracing() as spans:
        with profile(activities=activities) as prof:
            yield prof
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    doc["traceEvents"].extend(
        chrome_events(spans, doc.get("baseTimeNanoseconds", 0)))
    path.write_text(json.dumps(doc))
