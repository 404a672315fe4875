"""Continuous-batching rollout server: many concurrent trajectories, one card
(``molecular_dynamics_neural_operator_tpu/serving/server.py``).

Requests arrive whenever they like and ask for whatever horizon they like;
the server packs everything in flight onto the stream axis of one segment
of ``segment_steps`` rollout steps, runs it, hands each request its part
and packs again:

- Requests join and leave at segment boundaries, so a 10,000-step request
  and a 100-step request share the card instead of queueing end to end.
- Stream counts are padded to powers of two up to ``max_streams`` (pad
  slots replay a live window and are discarded), so the set of buffer
  shapes is bounded by ``log2(max_streams) + 1`` whatever the traffic.
- A tail segment runs the full quantum; the request's carry is re-derived
  from ``[window ; chunk][-T:]`` and the overhang is dropped.

Segment chaining is exact: 64 steps and then 36 from the carried window
run the same operations as one 100-step rollout at the same stream count,
so the stitched trajectory equals it to the bit. Across stream counts
``impl="persistent"`` is bitwise too on the card (each stream has its own
thread-block cluster and its own rows of every product), while the plain
tensor products of ``impl="scan"`` may round a product over S*E rows
differently from one over E rows: hold that path to 1e-5 A with equal
edge lists.

``impl="scan"`` builds its segment from ``rollout_scan`` (one amino-acid
sequence per request, on the graph ``cfg.graph_mode`` names, dense or
sparse; with ``conv_impl="pallas"`` a sparse graph goes through the fused
kernel of ``ops/cuda/fused_gkn.py``). ``impl="persistent"`` builds it from
the rollout kernels (``ops/cuda/persistent_rollout.py``), which embed one
shared sequence and build their own sparse graph of ``cfg.max_edges``
slots whatever ``cfg.graph_mode`` says; its weights are cast once and its
step buffers are kept per padded stream count for the server's lifetime.

Threads and CUDA streams. The scheduler thread only enqueues work on a
stream of its own and never reads a device value. A reader thread turns
finished requests into host arrays: it waits on an event recorded after
the request's last segment, gathers the chunks and copies them into
pinned memory on a second stream, so transfers overlap the next segment.
A bounded queue between the two, with a marker event every eighth
segment, caps how far the scheduler runs ahead of the card. The kernels
are built and loaded in ``__init__``, before either thread starts, and a
build failure is raised to the caller. A failing scheduler fails every
waiting request, and later ``submit`` calls raise.

Several cards: with ``mesh`` (``parallel/mesh.py::make_mesh``) the
stream axis of every segment is spread over the mesh's "data" axis, one
process per rank. Global rank 0 runs the server: its queue, scheduler,
reader and this API. Each segment it broadcasts a header (the padded
stream count, or stop) and the windows and sequences of the batch; every
rank runs the segment on its own streams with no traffic between ranks,
and the coordinates, final windows and per-stream overflow flags are
gathered over "data". The other ranks run ``serve_follower`` until rank
0's ``close`` stops them. Padded stream counts are multiples of the data
axis size, and only ``impl="scan"`` takes a mesh.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    check_supported,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._build import (
    load_kernels,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.persistent_rollout import (  # noqa: E501
    make_persistent_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel import comm
from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    rollout_scan_chunked,
)

__all__ = ["RolloutResult", "RolloutServer", "serve_follower"]


@dataclasses.dataclass(frozen=True)
class RolloutResult:
    """What a completed request resolves to."""

    coords: np.ndarray  # (num_steps, R, 3) float32 predicted coordinates
    final_window: np.ndarray  # (T, R, 3): resubmit to continue the stream
    # A graph rebuild met the edge capacity on the way. Conservative on the
    # tail segment: it always runs the full quantum and the flag ORs over
    # all of it, so an overflow in the discarded overhang still flags the
    # request. False proves every served step was free of overflow. Under
    # impl="persistent" the kernels keep one flag for all streams of a
    # segment, so it is conservative across the batch too.
    edge_overflow: bool


@dataclasses.dataclass
class _Request:
    aa: np.ndarray  # (R,) int32
    window: object  # (T, R, 3) carry: host array at submit, tensor after
    remaining: int
    chunks: list  # device tensors (take_i, R, 3), gathered at completion
    overflow: object  # None, then a device bool scalar OR-ed per segment
    future: Future
    done: object = None  # CUDA event after the last segment (None on CPU)


@dataclasses.dataclass
class _SegmentMarker:
    """Pacing token: the reader waits for its event, which bounds how far
    the scheduler can enqueue ahead of the card (the read queue is
    bounded)."""

    event: object


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pad_size(n: int, max_streams: int, shards: int = 1) -> int:
    """Padded stream count for n requests: ``shards`` times a power of
    two (every rank gets as many streams), capped at max_streams."""
    return min(shards * _next_pow2(-(-n // shards)), max_streams)


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


def _scan_segment(params, cfg: ModelConfig, seg: int, threshold: float,
                  clip, stream_chunk):
    """The ``impl="scan"`` segment: run(aa_b (S, R), win_b (S, T, R, 3))
    -> (coords (S, seg, R, 3), final windows, overflow (S,))."""

    def run(aa_b, win_b):
        chunk = stream_chunk
        if chunk is not None and win_b.shape[0] % chunk:
            chunk = None  # padded counts are powers of two
        coords, final_w, diags = rollout_scan_chunked(
            params, cfg, aa_b, win_b, seg, chunk, threshold, "last",
            "coords", clip)
        return coords, final_w, diags["edge_overflow"]

    return run


class _MeshSegment:
    """A segment whose streams are spread over the mesh's data axis.
    Called on global rank 0 with the whole padded batch; ``follow`` is the
    other ranks' loop, ``stop`` ends it."""

    def __init__(self, run_local, mesh, data_axis: str, cfg: ModelConfig,
                 device):
        self._run_local = run_local
        self._n = axis_size(mesh, data_axis)
        self._index = axis_index(mesh, data_axis)
        self._group = mesh.get_group(data_axis)
        self._shape = (cfg.window_size, cfg.num_residues)
        self._device = device

    def _header(self, streams: int = 0, stop: bool = False):
        return comm.broadcast(torch.tensor(
            [streams, int(stop)], dtype=torch.int64, device=self._device), 0)

    def _run(self, aa_b, win_b):
        aa_b = comm.broadcast(aa_b.to(torch.int32), 0)
        win_b = comm.broadcast(win_b, 0)
        local = win_b.shape[0] // self._n
        rows = slice(self._index * local, (self._index + 1) * local)
        coords, final_w, over = self._run_local(aa_b[rows], win_b[rows])
        return (comm.all_gather(coords, self._group),
                comm.all_gather(final_w, self._group),
                comm.all_gather(over.to(torch.int32), self._group) > 0)

    def __call__(self, aa_b, win_b):
        self._header(win_b.shape[0])
        return self._run(aa_b, win_b)

    def follow(self) -> None:
        t, r = self._shape
        while True:
            streams, stop = self._header().tolist()
            if stop:
                return
            self._run(
                torch.zeros(streams, r, dtype=torch.int32,
                            device=self._device),
                torch.zeros(streams, t, r, 3, device=self._device))

    def stop(self) -> None:
        self._header(stop=True)


def serve_follower(params, cfg: ModelConfig, mesh, *,
                   segment_steps: int = 64, threshold: float = 8.0,
                   clip: Optional[float] = None,
                   stream_chunk: Optional[int] = None,
                   data_axis: str = "data", device=None) -> None:
    """The loop of a rank other than global rank 0 under a mesh server:
    run rank 0's segments on this rank's streams until rank 0 closes its
    ``RolloutServer``. The options must be rank 0's."""
    check_supported(cfg)
    dev = resolve_device(device)
    if dev.type == "cuda":
        load_kernels()
    params = _params_to(params, dev)
    segment = _MeshSegment(
        _scan_segment(params, cfg, int(segment_steps), float(threshold), clip,
                      stream_chunk), mesh, data_axis, cfg, dev)
    with torch.no_grad():
        segment.follow()


class RolloutServer:
    """Batches concurrent autoregressive-rollout requests onto one card.

    ``submit(aa, window, num_steps)`` returns a ``concurrent.futures.
    Future`` of a :class:`RolloutResult`. Any number of threads (or socket
    handlers, see ``cli/serve.py``) may submit at once; everything in
    flight shares each segment.

    - ``segment_steps``: the scheduling quantum. Small values cut join
      latency and tail waste, large values spread the per-segment host
      work over more steps.
    - ``max_streams``: the stream axis' capacity per segment.
    - ``impl``: "scan" (plain tensor path, one amino-acid sequence per
      request) or "persistent" (the rollout kernels, one shared sequence
      passed as ``aa``).
    - ``stream_chunk``: (impl="scan") run a segment's streams in
      sequential chunks of this size where it divides the padded count.
    - ``mesh``, ``data_axis``: spread each segment's streams over the
      mesh's data axis (``impl="scan"`` only; ``max_streams`` must divide
      by the axis size). Built on global rank 0, with every other rank in
      ``serve_follower``.
    - ``device``: ``cuda`` unless the caller passes ``"cpu"``; a missing
      card is an error.

    A request's predicted coordinates stay on the device until it
    completes (num_steps x R x 3 floats). For very long horizons split
    the request: ``final_window`` is made to be resubmitted.
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        segment_steps: int = 64,
        max_streams: int = 8,
        threshold: float = 8.0,
        clip: Optional[float] = None,
        impl: str = "scan",
        aa: Optional[np.ndarray] = None,
        stream_chunk: Optional[int] = None,
        mesh=None,
        data_axis: str = "data",
        device=None,
    ):
        if segment_steps < 1:
            raise ValueError("segment_steps must be >= 1")
        if max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        if impl not in ("scan", "persistent"):
            raise ValueError(f"unknown impl: {impl!r}")
        if impl == "persistent" and aa is None:
            raise ValueError(
                "impl='persistent' embeds one amino-acid sequence in the "
                "kernels; pass it as aa= (every request must match it)")
        if stream_chunk is not None and impl != "scan":
            raise ValueError("stream_chunk applies to impl='scan' only")
        if mesh is not None:
            if impl != "scan":
                raise ValueError(
                    "mesh sharding applies to impl='scan' (the persistent "
                    "kernels are a per-card program; run one server per "
                    "card)")
            n = axis_size(mesh, data_axis)
            if max_streams % n:
                raise ValueError(
                    f"max_streams {max_streams} must be divisible by the "
                    f"'{data_axis}' axis size {n}")
        check_supported(cfg)
        self._device = resolve_device(device)
        self._cuda = self._device.type == "cuda"
        self._params = _params_to(params, self._device)
        self._cfg = cfg
        self._segment_steps = int(segment_steps)
        self._max_streams = int(max_streams)
        self._threshold = float(threshold)
        self._clip = clip
        self._impl = impl
        self._stream_chunk = stream_chunk
        self._server_aa = None if aa is None else np.asarray(aa, np.int32)
        self._mesh, self._data_axis = mesh, data_axis
        self._shards = 1 if mesh is None else axis_size(mesh, data_axis)

        # items: a _Request, a list of them (submit_many) or None (close)
        self._queue: "queue.Queue" = queue.Queue()
        self._backlog: "collections.deque[_Request]" = collections.deque()
        self._active: list[_Request] = []
        self._stats_lock = threading.Lock()
        self._stats = {
            "segments_run": 0,
            "steps_computed": 0,  # segment_steps x padded stream count
            "steps_served": 0,  # steps that landed in a request's output
            "requests_completed": 0,
        }
        self._stopping = False
        self._cancel = False
        self._fatal: Optional[BaseException] = None
        # one segment at a time touches the segment's buffers: the
        # scheduler and warmup() both enqueue under this lock, on one stream
        self._segment_lock = threading.Lock()
        self._compute_stream = self._copy_stream = None
        if self._cuda:
            # build and load every kernel here, on the caller's thread: a
            # compiler error is the caller's to see
            load_kernels()
            self._compute_stream = torch.cuda.Stream(self._device)
            self._copy_stream = torch.cuda.Stream(self._device)
        self._segment = self._build_segment()
        self._read_queue: "queue.Queue" = queue.Queue(maxsize=8)
        self._reader = threading.Thread(
            target=self._reader_loop, name="rollout-server-reader",
            daemon=True)
        self._reader.start()
        self._thread = threading.Thread(
            target=self._scheduler_loop, name="rollout-server", daemon=True)
        self._thread.start()

    # -- the segment ---------------------------------------------------------

    def _build_segment(self):
        """run(aa_b (S, R) int tensor, win_b (S, T, R, 3)) -> (coords
        (S, segment_steps, R, 3), final windows (S, T, R, 3), overflow: a
        bool tensor, (S,) or scalar)."""
        cfg, seg = self._cfg, self._segment_steps
        if self._impl == "persistent":
            run_prepared = make_persistent_rollout_fn(
                cfg, seg, self._threshold, self._clip, self._device,
            ).prepare(self._params, self._server_aa)

            def run(aa_b, win_b):
                # aa_b is checked against the server's sequence at submit
                coords, final_w, diags = run_prepared(win_b)
                return coords, final_w, diags["edge_overflow"]

            return run

        run = _scan_segment(self._params, cfg, seg, self._threshold,
                            self._clip, self._stream_chunk)
        if self._mesh is None:
            return run
        return _MeshSegment(run, self._mesh, self._data_axis, cfg,
                            self._device)

    def _on_compute_stream(self):
        if self._cuda:
            return torch.cuda.stream(self._compute_stream)
        return contextlib.nullcontext()

    # -- public API ----------------------------------------------------------

    def submit(self, aa, window, num_steps: int) -> Future:
        """Enqueue one rollout request; returns a Future[RolloutResult]."""
        req = self._request(aa, window, num_steps)
        self._queue.put(req)
        return req.future

    def submit_many(self, requests) -> list:
        """Enqueue several ``(aa, window, num_steps)`` requests as one
        item: they are admitted together, in order, so up to
        ``max_streams`` of them share their first segment whatever the
        scheduler is doing when they arrive. Returns their futures. All
        are checked before any is enqueued."""
        reqs = [self._request(*r) for r in requests]
        self._queue.put(reqs)
        return [r.future for r in reqs]

    def _request(self, aa, window, num_steps: int) -> _Request:
        cfg = self._cfg
        if self._stopping:
            raise RuntimeError("server is shut down")
        if self._fatal is not None:
            raise RuntimeError("server scheduler died") from self._fatal
        aa = np.asarray(aa, np.int32)
        window = np.asarray(window, np.float32)
        r, t = cfg.num_residues, cfg.window_size
        if aa.shape != (r,):
            raise ValueError(f"aa must be ({r},), got {aa.shape}")
        if window.shape != (t, r, 3):
            raise ValueError(
                f"window must be ({t}, {r}, 3), got {window.shape}")
        if int(num_steps) < 1:
            raise ValueError("num_steps must be >= 1")
        if self._server_aa is not None and not np.array_equal(
                aa, self._server_aa):
            raise ValueError(
                "impl='persistent' serves one amino-acid sequence; the "
                "request's aa differs from the server's")
        return _Request(aa=aa, window=window, remaining=int(num_steps),
                        chunks=[], overflow=None, future=Future())

    def rollout(self, aa, window, num_steps: int,
                timeout: Optional[float] = None) -> RolloutResult:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(aa, window, num_steps).result(timeout=timeout)

    def warmup(self, batch_sizes=None) -> None:
        """Run one segment at each padded stream count (all of them up to
        ``max_streams`` unless given), so that the first requests find
        their buffers allocated and the card's libraries loaded. Counts
        for nothing in ``stats``."""
        cfg = self._cfg
        if batch_sizes is None:
            batch_sizes, s = [], self._shards
            while s <= self._max_streams:
                batch_sizes.append(s)
                s *= 2
            if batch_sizes[-1] != self._max_streams:
                batch_sizes.append(self._max_streams)
        r, t = cfg.num_residues, cfg.window_size
        aa = (np.zeros((r,), np.int32) if self._server_aa is None
              else self._server_aa)
        for s in batch_sizes:
            aa_b = torch.as_tensor(np.broadcast_to(aa, (s, r)).copy(),
                                   device=self._device)
            win_b = torch.zeros(s, t, r, 3, device=self._device)
            with self._segment_lock, torch.no_grad(), \
                    self._on_compute_stream():
                self._segment(aa_b, win_b)
        if self._cuda:
            self._compute_stream.synchronize()

    @property
    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self._stats)
        out["occupancy"] = (
            out["steps_served"] / out["steps_computed"]
            if out["steps_computed"] else 0.0)
        return out

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop the scheduler. ``drain=True`` serves everything already
        submitted first; ``drain=False`` cancels queued and active
        requests. With a ``timeout`` (seconds, for each of the two
        threads) a thread that does not stop raises ``TimeoutError``
        instead of blocking the caller for ever."""
        self._stopping = True
        self._cancel = not drain  # the scheduler thread does the dropping
        self._queue.put(None)  # wake the scheduler
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("the scheduler thread did not stop")
        self._read_queue.put(None)  # the scheduler enqueues no more reads
        self._reader.join(timeout)
        if self._reader.is_alive():
            raise TimeoutError("the reader thread did not stop")
        if isinstance(self._segment, _MeshSegment):
            segment, self._segment = self._segment, None
            with torch.no_grad():
                segment.stop()  # the followers return

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    # -- scheduler -----------------------------------------------------------

    def _drop_pending(self, err: BaseException) -> None:
        for req in list(self._active) + list(self._backlog):
            req.future.set_exception(err)
        self._active = []
        self._backlog.clear()
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            for req in item if isinstance(item, list) else [item]:
                if req is not None:
                    req.future.set_exception(err)

    def _admit(self) -> bool:
        """Move queued requests into the active set. Blocks when idle.
        Returns False when the server should exit."""
        block = not self._active
        while len(self._active) < self._max_streams:
            if self._backlog:
                self._active.append(self._backlog.popleft())
                block = False
                continue
            try:
                req = self._queue.get(timeout=0.05 if block else 0)
            except queue.Empty:
                if not block:
                    return True
                if self._stopping:
                    return False
                continue
            if req is None:  # close() sentinel
                if self._stopping and not self._active \
                        and self._queue.empty():
                    return False
                continue
            if isinstance(req, list):
                self._backlog.extend(req)
                continue
            self._active.append(req)
            block = False
        return True

    def _run_segment(self) -> None:
        """Enqueue one segment for the active requests and hand each its
        part. Reads no device value."""
        seg, t_len = self._segment_steps, self._cfg.window_size
        dev = self._device
        batch = self._active
        s_pad = _pad_size(len(batch), self._max_streams, self._shards)
        for req in batch:
            if isinstance(req.window, np.ndarray):
                req.window = torch.as_tensor(req.window).to(
                    dev, non_blocking=True)
        slots = [batch[i % len(batch)] for i in range(s_pad)]
        aa_b = torch.as_tensor(np.stack([q.aa for q in slots])).to(
            dev, non_blocking=True)
        win_b = torch.stack([q.window for q in slots])
        with self._segment_lock:
            coords, final_w, over = self._segment(aa_b, win_b)
        served = 0
        still_active, completed = [], []
        for i, req in enumerate(batch):
            take = min(req.remaining, seg)
            chunk = coords[i] if take == seg else coords[i, :take]
            req.chunks.append(chunk)
            if take == seg:
                req.window = final_w[i]
            else:
                # tail segment: the segment ran the full quantum; the
                # carry after only `take` steps
                req.window = torch.cat([req.window, chunk])[-t_len:]
            ov = over if over.dim() == 0 else over[i]
            req.overflow = ov if req.overflow is None else req.overflow | ov
            req.remaining -= take
            served += take
            (still_active if req.remaining else completed).append(req)
        self._active = still_active
        with self._stats_lock:
            self._stats["segments_run"] += 1
            self._stats["steps_computed"] += s_pad * seg
            self._stats["steps_served"] += served
            segments = self._stats["segments_run"]
        event = None
        if self._cuda and (completed or segments % 8 == 0):
            event = torch.cuda.Event()
            event.record(self._compute_stream)
        for req in completed:
            req.done = event
            self._read_queue.put(req)
        # a marker every 8th segment: with the bounded read queue it keeps
        # the scheduler at most some 64 segments ahead of the card when no
        # request completes for a long time
        if segments % 8 == 0:
            self._read_queue.put(_SegmentMarker(event))

    def _scheduler_loop(self) -> None:
        try:
            with torch.no_grad(), self._on_compute_stream():
                while True:
                    if self._cancel:
                        self._drop_pending(RuntimeError("server shut down"))
                        return
                    if not self._admit():
                        return
                    if self._active:
                        self._run_segment()
        except Exception as e:  # noqa: BLE001: fail every waiter
            self._fatal = e
            self._drop_pending(e)

    # -- reader --------------------------------------------------------------

    def _to_host(self, req: _Request):
        """(coords, window, overflow) of a finished request as host
        values. On the card: wait for the request's last segment on the
        copy stream, gather and copy there into pinned memory, and wait
        for that copy alone; the request's tensors stay referenced until
        it is done."""
        if not self._cuda:
            return (torch.cat(req.chunks).numpy(), req.window.numpy(),
                    bool(req.overflow))
        stream = self._copy_stream
        with torch.no_grad(), torch.cuda.stream(stream):
            stream.wait_event(req.done)
            coords_dev = (req.chunks[0] if len(req.chunks) == 1
                          else torch.cat(req.chunks))
            outs = []
            for t in (coords_dev, req.window, req.overflow):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
                outs.append(host)
            copied = torch.cuda.Event()
            copied.record(stream)
        copied.synchronize()
        coords, window, over = outs
        return coords.numpy().copy(), window.numpy().copy(), bool(over)

    def _reader_loop(self) -> None:
        while True:
            item = self._read_queue.get()
            if item is None:
                return
            if isinstance(item, _SegmentMarker):
                try:
                    if item.event is not None:
                        item.event.synchronize()
                except Exception:  # noqa: BLE001: the scheduler reports it
                    pass
                continue
            req = item
            try:
                coords, window, over = self._to_host(req)
                with self._stats_lock:
                    self._stats["requests_completed"] += 1
                req.future.set_result(RolloutResult(
                    coords=np.asarray(coords, np.float32),
                    final_window=np.asarray(window, np.float32),
                    edge_overflow=over))
            except Exception as e:  # noqa: BLE001: the waiter gets it
                if not req.future.done():
                    req.future.set_exception(e)
