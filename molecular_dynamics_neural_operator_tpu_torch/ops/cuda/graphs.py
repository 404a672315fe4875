"""CUDA graphs of the port's step loops.

The JAX package runs each of its loops as one compiled program: the TPU
rollout kernel as one launch over ``grid=(num_steps,)``, every train step
as one ``jax.jit``. On the H100 the counterpart is a CUDA graph: the
step's launches are captured once over fixed buffers and the loop
submits the graph, so no Python runs between the launches of a step.

``capture`` records a body into a graph after an eager warm-up run (the
card's libraries and the kernels' launch plans are set up outside the
capture). A graph replays its launches without passing through the code
that counts them, so a capture holds the program counts its body makes
(``utils/profiling.py::held``) and ``Captured.replay`` adds them: a
counter counts what ran, eager or replayed, and the warm-up and the
capture itself count nothing.
``capture_count()`` counts the captures made: one inside a timed window
is a graph built again. Under ``utils/profiling.py::tracing()`` a replay
is the span ``graph.replay`` and a capture ``graph.capture``, each with
the graph's name; the capture records no span of what it captures.
The first replay of a graph waits for the card once, so that a kernel
that fails inside the graph raises there with the graph's name. Nothing
falls back to an eager loop: a capture or a replay that fails raises.

``BlockLoop`` is the rollouts' form: a block of ``GRAPH_BLOCK`` steps
captured over a static window and a static block of outputs, replayed
``num_steps // GRAPH_BLOCK`` times, and a tail graph of its own length
for the rest, each cached. ``StepGraphs`` keeps, for any step function,
the static inputs, carry and output blocks of each input shape with their
``BlockLoop`` (the scan rollout's and the serving bundle's loops).
``KeepLast`` keeps a rollout function's prepared graphs across calls with
the same parameters. ``stays_eager`` names the configurations whose loops
run op by op, and ``step_stays_eager`` the train steps, multi-rank ones
included.
"""

from __future__ import annotations

import gc
import threading
from types import SimpleNamespace
from typing import Callable

import torch
import torch.distributed as dist

from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import (
    count,
    held,
    paused,
    span,
)

# steps in one captured rollout block
GRAPH_BLOCK = 64

# graphs captured in this process (capture_count)
_captures = 0

# the values made once for the capture in progress on this thread
_capturing = threading.local()


def stays_eager(cfg) -> bool:
    """Configurations whose loops run op by op on the card too: the
    cell-list rebuild of the large systems. Issued op by op, a
    ``SOLVATED_10K`` rollout step keeps the card busy all of its wall
    time (251.15 ms of device time by ``torch.profiler`` in 250.24 ms of
    wall time a step, busy share 1.004; ``chip_smoke.py`` phase 22e on
    an NVIDIA H100 80GB HBM3 at 700 W), so a graph saves nothing there.
    The dense graph's loops replay graphs: issued op by op, its BBA
    rollout step kept the same card busy 0.18 of the time."""
    return cfg.neighbor_impl == "cell_list"


def step_stays_eager(cfg=None, groups=()) -> bool:
    """The rule for a train step on the card: op by op where its model
    configuration ``stays_eager`` (``cfg`` None for the FNO), or where a
    process group it reduces over is not NCCL; else CUDA graphs. Gloo
    stages card tensors through the host (``parallel/comm.py``), a copy
    that a capture refuses, so ranks that share a card (gloo) run
    eagerly, and ranks with a card each (NCCL) replay graphs with their
    collectives inside. Decided from the configuration and the backends
    alone: no path tries a capture and falls back."""
    if cfg is not None and stays_eager(cfg):
        return True
    return any(dist.get_backend(g) != "nccl" for g in groups)


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


def capture_count() -> int:
    """The CUDA graphs ``capture`` has made in this process."""
    return _captures


class Captured:
    """A captured graph, the program counts one replay adds (those its
    capture held), and a name for its errors."""

    def __init__(self, graph: torch.cuda.CUDAGraph, counts: dict,
                 name: str):
        self.graph, self.counts, self.name = graph, counts, name
        self._checked = False

    def replay(self) -> None:
        with span("graph.replay", self.name):
            self.graph.replay()
        for name, n in self.counts.items():
            count(name, n)
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
    graph's static outputs. The program counters are left as they
    were."""
    with span("graph.capture", name):
        return _capture(body, name, warmup, pool)


def _capture(body: Callable, name: str, warmup, pool):
    global _captures
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    try:
        if warmup is not None:
            with held():
                warmup()
        # a garbage collection inside the capture could free another
        # graph, whose teardown the capturing stream refuses; the capture
        # collects once before it begins
        gc.disable()
        _capturing.cache = {}
        try:
            with paused(), held() as counts, torch.cuda.graph(
                    graph, pool=pool, capture_error_mode="thread_local"):
                out = body()
        except RuntimeError as exc:
            raise RuntimeError(f"{name}: CUDA graph capture failed: "
                               f"{exc}") from exc
        finally:
            _capturing.cache = None
        _captures += 1
    finally:
        if collecting:
            gc.enable()
    return Captured(graph, counts, name), out


def _blocks(num_steps: int) -> list:
    """(first step, steps) of each block of a ``num_steps`` loop."""
    return [(start, min(GRAPH_BLOCK, num_steps - start))
            for start in range(0, num_steps, GRAPH_BLOCK)]


class BlockLoop:
    """A rollout loop on the card as replays of captured blocks of steps.

    ``capture_block(n)`` returns a body that runs ``n`` steps from the
    loop's static inputs into its static output blocks (rows ``:n``);
    ``warmup()`` runs one step eagerly. ``capture_first(n)``, if given,
    is the body of the loop's first block, which starts from other static
    inputs than the later blocks. ``run(num_steps, outputs)`` replays
    whole blocks and then the tail, and after each replay copies its rows
    of each static block into its rows of the caller's ``(num_steps,
    ...)`` tensor, before the next replay overwrites them."""

    def __init__(self, capture_block: Callable, warmup: Callable, name: str,
                 pool=None, capture_first: Callable | None = None):
        self._capture_block, self._warmup = capture_block, warmup
        self._capture_first = capture_first
        self._name, self._pool = name, pool
        self._graphs: dict = {}

    def graph(self, n: int, first: bool = False) -> Captured:
        first = first and self._capture_first is not None
        if (n, first) not in self._graphs:
            make = self._capture_first if first else self._capture_block
            self._graphs[n, first], _ = capture(
                make(n), f"{self._name} ({n} steps"
                + (", the first block)" if first else ")"),
                warmup=self._warmup, pool=self._pool)
        return self._graphs[n, first]

    def prepare(self, num_steps: int) -> None:
        """Capture the graphs a ``num_steps`` run replays, before any
        input is copied in (a capture's warm-up writes the buffers)."""
        for start, n in _blocks(num_steps):
            self.graph(n, first=start == 0)

    def run(self, num_steps: int, outputs: list) -> None:
        """``outputs``: (static block, result) pairs."""
        for start, n in _blocks(num_steps):
            self.graph(n, first=start == 0).replay()
            for block, out in outputs:
                out[start:start + n].copy_(block[:n])


class StepGraphs:
    """A step loop on the card as replays of captured blocks of steps.

    ``step(inputs, carry) -> (carry', outputs, flag)``: ``inputs`` a tuple
    of tensors that stay as they are through the loop, ``carry`` the
    tensor each step advances (a window (..., T, R, 3), or an FNO's
    channels (R, R, T)), ``outputs`` a tuple of the tensors the loop
    collects from each step, ``flag`` a bool tensor OR-ed over the steps,
    or None. For each shape of inputs and carry the object keeps static
    inputs, a static carry and flag, static blocks of ``GRAPH_BLOCK`` of
    each output (shaped by one eager step when the shape is first seen,
    which counts nothing)
    and their ``BlockLoop``, all in one graph memory pool. ``step`` must
    hold no reference to the owner of this object: the graphs are freed
    with it, not by a later garbage collection. Calls are serialised by
    the caller, on one stream.

    A step's arithmetic may depend on its carry's memory layout (a
    product over a permuted tensor takes another kernel). The loop's
    first step reads a carry laid out as the caller's, the later ones a
    carry laid out as a step's own result, as the loop issued op by op
    does; where the two layouts differ the first block has graphs of its
    own."""

    def __init__(self, step: Callable, name: str):
        self._step, self._name = step, name
        self._loops: dict = {}
        self._pool = torch.cuda.graph_pool_handle()

    def _loop(self, inputs: tuple, carry0: torch.Tensor):
        key = tuple((tuple(t.shape), t.stride(), t.dtype)
                    for t in (*inputs, carry0))
        if key in self._loops:
            return self._loops[key]
        step = self._step
        st = SimpleNamespace(inputs=tuple(t.clone() for t in inputs),
                             first=carry0.clone())
        # a warm-up step, counted as none as a capture's warm-up is
        with held():
            carry1, outs, flag = step(st.inputs, st.first)
        st.carry = st.first if carry1.stride() == st.first.stride() \
            else torch.empty_like(carry1)
        st.blocks = [torch.empty((GRAPH_BLOCK,) + tuple(o.shape),
                                 dtype=o.dtype, device=o.device)
                     for o in outs]
        st.flag = None if flag is None else torch.zeros_like(flag)

        def run_steps(n, first=False):
            carry, flag = (st.first if first else st.carry), st.flag
            for i in range(n):
                carry, outs, f = step(st.inputs, carry)
                if flag is not None:
                    flag = flag | f
                for block, out in zip(st.blocks, outs):
                    block[i].copy_(out)
            st.carry.copy_(carry)
            if flag is not None:
                st.flag.copy_(flag)

        loop = BlockLoop(
            lambda n: (lambda: run_steps(n)), lambda: run_steps(1),
            f"{self._name} of {tuple(carry0.shape)}", self._pool,
            None if st.carry is st.first
            else (lambda n: (lambda: run_steps(n, first=True))))
        self._loops[key] = (loop, st)
        return loop, st

    def __call__(self, inputs: tuple, carry0: torch.Tensor, num_steps: int):
        """(outputs, each stacked on a step axis after the carry's
        leading axes ``carry0.shape[:-3]``; the final carry; the flags
        OR-ed, or None)."""
        loop, st = self._loop(inputs, carry0)
        loop.prepare(num_steps)
        for static, given in zip(st.inputs, inputs):
            static.copy_(given)
        st.first.copy_(carry0)
        if st.flag is not None:
            st.flag.zero_()
        outs = [(block, torch.empty((num_steps,) + block.shape[1:],
                                    dtype=block.dtype, device=block.device))
                for block in st.blocks]
        loop.run(num_steps, outs)
        lead = carry0.dim() - 3
        stacked = tuple(torch.movedim(out, 0, lead).contiguous() if lead
                        else out for _, out in outs)
        final = st.carry if num_steps else st.first
        return (stacked, final.clone(),
                None if st.flag is None else st.flag.clone())


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
