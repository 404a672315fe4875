"""The port's spans and counters (``utils/profiling.py``): off, a span is
one shared object and records nothing; on, the server, the trainer and
the graphs record the spans their layers promise, on the threads that do
the work, and the server's queue counters agree with them.

The tests marked ``gpu`` hold the spans against ``torch.profiler``'s
trace of the card (``portbench/spans.py`` joins the two), the capture
counter and the counts a replay adds, and skip without a card:
``python -m pytest --noconftest tests/test_torch_port_tracing.py`` there.
This file imports no JAX."""

import threading
import time

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import graphs
from molecular_dynamics_neural_operator_tpu_torch.serving import (
    RolloutServer,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    create_train_state,
    make_train_step,
    train_epoch,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

OPTS = dict(width=8, ker_width=16, depth=1, window_size=4, num_residues=10,
            max_edges=128, graph_mode="sparse", compute_dtype="float32",
            predict_delta=True)
WAIT = 120  # seconds a test waits for a result before it fails


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device's trace and CUDA graphs")
    return torch.device("cuda")


def _names(spans, name):
    return [s for s in spans if s.name == name]


def test_off_a_span_is_one_shared_object_and_records_nothing():
    a, b = profiling.span("x"), profiling.span("y", request=3)
    assert a is b
    with a as inside:
        inside.discard()
    profiling.record("z", 0, 1)
    with profiling.tracing() as spans:
        pass
    assert spans == [] and spans.threads == {}


def test_held_counts_stay_out_of_the_store_on_their_thread_alone():
    """Inside ``held()`` this thread's counts go into the block's dict;
    another thread's go into the store meanwhile."""
    before = profiling.counters()
    with profiling.held() as mine:
        profiling.count("held test", 2)
        other = threading.Thread(
            target=lambda: profiling.count("held test other", 3))
        other.start()
        other.join(WAIT)
        assert not other.is_alive()
    profiling.count("held test", 5)
    after = profiling.counters()
    assert mine == {"held test": 2}
    assert after["held test"] - before.get("held test", 0) == 5
    assert after["held test other"] - before.get("held test other", 0) == 3


def test_a_backward_nodes_counts_go_into_the_open_held_block():
    """A CUDA backward runs on the autograd engine's own thread while the
    thread that called it waits, inside that thread's ``held()`` when a
    graphed training step is warmed up or captured: a count made by a
    backward node on a thread that holds nothing goes into the open
    block's dict; that thread's other counts go into the store."""

    class Counted(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            profiling.count("held test forward")
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            profiling.count("held test backward")
            return 2 * g

    def engine_thread():
        Counted.apply(torch.ones(3, requires_grad=True)).sum().backward()

    before = profiling.counters()
    with profiling.held() as mine:
        other = threading.Thread(target=engine_thread)
        other.start()
        other.join(WAIT)
        assert not other.is_alive()
    engine_thread()
    after = profiling.counters()
    assert mine == {"held test backward": 1}
    assert after["held test forward"] - before.get("held test forward",
                                                   0) == 2
    assert after["held test backward"] - before.get("held test backward",
                                                    0) == 1


def test_each_launch_view_reads_and_resets_its_own_names():
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
        train_conv as tc,
    )

    profiling.count("conv_head_wide", 4)
    profiling.count("train_conv_fwd", 2)
    before = tc.launch_counts()
    pr.reset_launch_counts()
    assert pr.launch_counts() == {"graph_encode": 0, "edge_mlp": 0,
                                  "conv_head": 0, "conv_head_wide": 0}
    assert tc.launch_counts() == before and before["train_conv_fwd"] >= 2
    tc.reset_launch_counts()
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}


def test_on_spans_nest_per_thread_and_come_back_from_every_thread():
    def worker():
        with profiling.span("worker.outer"):
            with profiling.span("worker.inner", request=7):
                pass

    with profiling.tracing() as spans:
        with pytest.raises(RuntimeError, match="already on"):
            with profiling.tracing():
                pass
        with profiling.span("main.outer"):
            t = threading.Thread(target=worker, name="tracing-worker")
            t.start()
            t.join(WAIT)
            with profiling.span("main.dropped") as dropped:
                dropped.discard()
        profiling.record("across", 5, 9, request=7)
    assert not t.is_alive()
    by = {s.name: s for s in spans}
    assert set(by) == {"main.outer", "worker.outer", "worker.inner",
                       "across"}
    assert by["worker.inner"].parent == "worker.outer"
    assert by["worker.inner"].request == 7
    assert by["worker.outer"].parent is None
    assert by["main.outer"].thread == threading.get_native_id()
    assert by["worker.outer"].thread != by["main.outer"].thread
    assert by["across"][1:] == (5, 9, None, None, 7)
    assert spans.threads[by["worker.outer"].thread][0] == "tracing-worker"
    assert spans.threads[threading.get_native_id()] == (
        threading.current_thread().name, threading.get_ident())
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
    # off again once the block ends
    assert profiling.span("x") is profiling.span("y")


def test_the_servers_spans_and_queue_counters():
    cfg = ModelConfig(**OPTS)
    params = gkn_init(cfg, seed=0, device="cpu")
    traj = synthetic_trajectory(num_frames=64, num_residues=10, seed=5)
    aa = traj.aminoacids
    with profiling.tracing() as spans:
        srv = RolloutServer(params, cfg, segment_steps=4, max_streams=2,
                            device="cpu")
        try:
            futs = [srv.submit(aa, traj.positions[3 * i:3 * i + 4], n)
                    for i, n in enumerate((3, 9, 6))]
            for f in futs:
                f.result(timeout=WAIT)
            stats = srv.stats
        finally:
            srv.close(timeout=WAIT)
    queued, read = _names(spans, "serve.queued"), _names(spans, "serve.read")
    ids = sorted(s.request for s in queued)
    assert len(set(ids)) == 3 and sorted(s.request for s in read) == ids
    assert all(s.thread is None for s in queued)
    replays = _names(spans, "serve.replay")
    assert replays and all(s.parent == "serve.segment" for s in replays)
    assert len(_names(spans, "serve.segment")) == stats["segments_run"]
    assert all(s.parent == "serve.admit" for s in _names(spans, "serve.idle"))
    assert stats["requests_admitted"] == 3
    assert stats["queue_wait_s"] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in queued) / 1e9, rel=1e-9)
    workers = {spans.threads[s.thread][0] for s in replays + read}
    assert workers == {"rollout-server", "rollout-server-reader"}


def test_the_trainers_spans():
    cfg = ModelConfig(**OPTS)
    traj = synthetic_trajectory(num_frames=64, num_residues=10, seed=4)
    ds = WindowDataset(traj, window_size=4, graph_mode="sparse",
                       max_edges=128)
    state, tx, _ = create_train_state(
        0, cfg, TrainConfig(lr=1e-3, batch_size=4), device="cpu")
    with profiling.tracing() as spans:
        state, m = train_epoch(state, make_train_step(cfg, tx), ds,
                               np.arange(22), 4, seed=1)
    steps = 22 // 4
    assert int(state.step) == steps
    assert len(_names(spans, "train.step")) == steps
    assert len(_names(spans, "train.wait_batch")) == steps
    assert len(_names(spans, "train.put")) == steps
    assert len(_names(spans, "train.epoch")) == 1
    assert len(_names(spans, "train.read_metrics")) == 1
    main = threading.get_native_id()
    for s in _names(spans, "train.step") + _names(spans, "train.wait_batch"):
        assert s.thread == main and s.parent == "train.epoch"
    produced = _names(spans, "train.produce")
    assert len(produced) >= steps
    assert {spans.threads[s.thread][0] for s in produced} == {
        "prefetch_to_device"}
    assert m["steps_per_sec"] > 0


def test_a_profiler_event_inside_a_span_lies_within_it():
    """Spans and the profiler's host events share one clock."""
    from torch.profiler import ProfilerActivity, profile

    with profiling.tracing() as spans:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("outer"):
                with torch.profiler.record_function("inner"):
                    torch.randn(64, 64) @ torch.randn(64, 64)
    (outer,) = spans
    (inner,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "inner"]
    assert outer.start_ns <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= outer.end_ns


def test_the_chrome_trace_carries_the_spans(tmp_path):
    import json

    with profiling.trace(str(tmp_path)):
        with profiling.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.randn(8) + 1
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    (outer,) = [e for e in events if e.get("cat") == "span"]
    (inner,) = [e for e in events if e.get("name") == "inner"
                and e.get("ph") == "X"]
    assert outer["name"] == "outer"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def _traced(work):
    """(Timeline of the device in a window around ``work()``, spans)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.spans import Timeline
    from portbench.trace import WINDOW

    torch.cuda.synchronize()
    with profiling.tracing() as spans:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                work()
                torch.cuda.synchronize()
    return Timeline.from_profile(prof), spans


@pytest.mark.gpu
def test_a_span_around_a_host_sleep_gets_that_idle_gap(cuda):
    from portbench.spans import idle_by_span

    x = torch.ones(1024, device=cuda)
    x.add_(1)

    def work():
        x.add_(1)
        with profiling.span("host.sleep"):
            time.sleep(0.005)
        x.add_(1)

    timeline, spans = _traced(work)
    idle = idle_by_span(timeline, spans)
    assert idle["host.sleep"] >= 0.9 * 0.005


@pytest.mark.gpu
def test_a_span_around_a_launch_gets_its_device_time(cuda):
    from portbench.spans import device_by_span

    torch.cuda._sleep(1000)

    def work():
        with profiling.span("launch"):
            torch.cuda._sleep(2_000_000)

    timeline, spans = _traced(work)
    ops = [(s, e) for s, e, _, _ in timeline.device]
    assert len(ops) == 1 and ops[0][1] - ops[0][0] > 100_000  # the spin
    assert device_by_span(timeline, spans) == {"launch": ops}


@pytest.mark.gpu
def test_a_capture_counts_and_a_replay_does_not(cuda):
    x = torch.zeros(16, device=cuda)

    def body():
        with profiling.span("inside"):
            x.add_(1)

    with profiling.tracing() as spans:
        before = graphs.capture_count()
        captured, _ = graphs.capture(body, "tracing test", warmup=body)
        assert graphs.capture_count() == before + 1
        captured.replay()
        captured.replay()
        assert graphs.capture_count() == before + 1
    torch.cuda.synchronize()
    assert float(x[0]) == 3.0        # the warm-up and two replays
    assert len(_names(spans, "inside")) == 1       # the warm-up's alone
    assert [s.request for s in _names(spans, "graph.replay")] == [
        "tracing test"] * 2
    (cap,) = _names(spans, "graph.capture")
    assert cap.request == "tracing test"


@pytest.mark.gpu
def test_a_replay_adds_the_counts_its_capture_held(cuda):
    """A counter counts what ran: the warm-up and the capture count
    nothing, each replay what the captured body counted."""
    x = torch.zeros(16, device=cuda)

    def body():
        profiling.count("replay test", 2)
        x.add_(1)

    def counted():
        return profiling.counters().get("replay test", 0)

    before = counted()
    captured, _ = graphs.capture(body, "counter test", warmup=body)
    assert counted() == before and captured.counts == {"replay test": 2}
    captured.replay()
    captured.replay()
    torch.cuda.synchronize()
    assert counted() == before + 4 and float(x[0]) == 3.0
