"""CUDA graphs of the port's step loops.

The JAX package runs each of its loops as one compiled program: the TPU
rollout kernel as one launch over ``grid=(num_steps,)``, every train step
as one ``jax.jit``. On the H100 the counterpart is a CUDA graph: the
step's launches are captured once over fixed buffers and the loop
submits the graph, so no Python runs between the launches of a step.

``capture`` records a body into a graph after an eager warm-up run (the
card's libraries and the kernels' launch plans are set up outside the
capture). A graph replays its launches without passing through the kernel
wrappers, so ``Captured.replay`` adds to each wrapper's ``launches`` what
one replay launches; the warm-up and the capture itself count nothing.
The first replay of a graph waits for the card once, so that a kernel
that fails inside the graph raises there with the graph's name. Nothing
falls back to an eager loop: a capture or a replay that fails raises.

``BlockLoop`` is the rollouts' form: a block of ``GRAPH_BLOCK`` steps
captured over a static window and a static block of outputs, replayed
``num_steps // GRAPH_BLOCK`` times, and a tail graph of its own length
for the rest, each cached. ``KeepLast`` keeps a rollout function's
prepared graphs across calls with the same parameters.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable

import torch

# steps in one captured rollout block
GRAPH_BLOCK = 64

# the values made once for the capture in progress on this thread
_capturing = threading.local()


def stays_eager(cfg) -> bool:
    """Configurations whose loops run op by op on the card too: the dense
    graph and the cell-list rebuild of the large systems, whose steps keep
    the card busy (busy share 0.95 and more), so a graph saves nothing."""
    return cfg.graph_mode == "dense" or cfg.neighbor_impl == "cell_list"


def tree_identity(tree) -> tuple:
    """(id, version) of every tensor leaf of nested dicts: equal while the
    leaves are the same tensors, unchanged in place."""
    if isinstance(tree, dict):
        return tuple(x for v in tree.values() for x in tree_identity(v))
    return ((id(tree), getattr(tree, "_version", None)),)


def per_capture(key, make: Callable):
    """Inside ``capture`` on this thread, ``make()`` once per ``key`` for
    the capture in progress: its operations become the graph's own, redone
    from what they read at every replay, into the graph's pool. None
    outside a capture, where the caller keeps its own cache."""
    cache = getattr(_capturing, "cache", None)
    if cache is None:
        return None
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _counters() -> dict:
    """name -> (read, write) of every kernel wrapper's launch count."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        fused_gkn,
        persistent_rollout as pr,
        train_conv,
    )

    def attr(fn):
        return (lambda: fn.launches,
                lambda v: setattr(fn, "launches", v))

    def item(d, k):
        return (lambda: d[k], lambda v: d.__setitem__(k, v))

    out = {fn.__name__: attr(fn) for fn in pr.KERNELS}
    out["fused_edge_conv_stack"] = attr(fused_gkn.fused_edge_conv_stack)
    out.update({k: item(train_conv.launches, k) for k in train_conv.launches})
    return out


def launch_counts() -> dict:
    return {k: read() for k, (read, _) in _counters().items()}


def _set_counts(counts: dict) -> None:
    for k, (_, write) in _counters().items():
        write(counts[k])


class Captured:
    """A captured graph, the launches one replay makes, and a name for its
    errors."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: dict,
                 name: str):
        self.graph, self.launches, self.name = graph, launches, name
        self._checked = False

    def replay(self) -> None:
        self.graph.replay()
        counters = _counters()
        for k, n in self.launches.items():
            read, write = counters[k]
            write(read() + n)
        if not self._checked:
            try:
                torch.cuda.current_stream().synchronize()
            except RuntimeError as exc:
                raise RuntimeError(
                    f"{self.name}: the captured CUDA graph failed at its "
                    f"first replay: {exc}") from exc
            self._checked = True


def capture(body: Callable, name: str, warmup: Callable | None = None,
            pool=None):
    """(Captured, body's result): ``warmup()`` run eagerly, then ``body()``
    captured on a side stream with ``capture_error_mode="thread_local"``
    (another thread of the process, such as a server's reader, may go on
    allocating pinned memory meanwhile). What the body returns are the
    graph's static outputs. The launch counts are left as they were."""
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    try:
        if warmup is not None:
            warmup()
        start = launch_counts()
        # a garbage collection inside the capture could free another
        # graph, whose teardown the capturing stream refuses; the capture
        # collects once before it begins
        gc.disable()
        _capturing.cache = {}
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = body()
        except RuntimeError as exc:
            raise RuntimeError(f"{name}: CUDA graph capture failed: "
                               f"{exc}") from exc
        finally:
            _capturing.cache = None
        captured = {k: n - start[k] for k, n in launch_counts().items()
                    if n != start[k]}
    finally:
        if collecting:
            gc.enable()
        _set_counts(before)
    return Captured(graph, captured, name), out


class BlockLoop:
    """A rollout loop on the card as replays of captured blocks of steps.

    ``capture_block(n)`` returns a body that runs ``n`` steps from the
    loop's static inputs into its static output blocks (rows ``:n``);
    ``warmup()`` runs one step eagerly. ``run(num_steps, outputs)``
    replays whole blocks and then the tail, and after each replay copies
    its rows of each static block into its rows of the caller's
    ``(num_steps, ...)`` tensor, before the next replay overwrites them."""

    def __init__(self, capture_block: Callable, warmup: Callable, name: str,
                 pool=None):
        self._capture_block, self._warmup = capture_block, warmup
        self._name, self._pool = name, pool
        self._graphs: dict = {}

    def graph(self, n: int) -> Captured:
        if n not in self._graphs:
            self._graphs[n], _ = capture(
                self._capture_block(n), f"{self._name} ({n} steps)",
                warmup=self._warmup, pool=self._pool)
        return self._graphs[n]

    def prepare(self, num_steps: int) -> None:
        """Capture the graphs a ``num_steps`` run replays, before any
        input is copied in (a capture's warm-up writes the buffers)."""
        full, tail = divmod(num_steps, GRAPH_BLOCK)
        if full:
            self.graph(GRAPH_BLOCK)
        if tail:
            self.graph(tail)

    def run(self, num_steps: int, outputs: list) -> None:
        """``outputs``: (static block, result) pairs."""
        start = 0
        while start < num_steps:
            n = min(GRAPH_BLOCK, num_steps - start)
            self.graph(n).replay()
            for block, out in outputs:
                out[start:start + n].copy_(block[:n])
            start += n


class KeepLast:
    """``get(key, sources, make)``: the object ``make()`` built for the
    last key, rebuilt when the key changes. It holds ``sources``, the
    tensors the key names by ``tree_identity``, so that their ids cannot
    be reused while it lives."""

    def __init__(self):
        self._entry = None

    def get(self, key, sources, make: Callable):
        if self._entry is None or self._entry[0] != key:
            # the old object and its graphs go before the new one is made
            self._entry = None
            self._entry = (key, sources, make())
        return self._entry[2]
