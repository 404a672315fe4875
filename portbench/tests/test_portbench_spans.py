"""``portbench/spans.py``: the program's spans joined with the device's
timeline on a made-up trace of two threads, and the harness's traced run
with the spans on, at a tiny size on the CPU."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import (
    Span,
    Spans,
)
from portbench import spans as sp
from portbench.tests import tiny
from portbench.trace import WINDOW

MAIN, WORKER = 100, 101
IDENT = 0x7F00_9234_5678            # the worker's threading.get_ident()
CUPTI = (IDENT & 0xFFFFFFFF) - (1 << 32)   # as the profiler names it


def event(name, start, end, device=False, corr=0, thread=MAIN):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start, correlation_id=lambda: corr,
        device_resource_id=lambda: 0 if device else thread,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU)


def fake(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def made_up():
    """A 1,000 ns window. The main thread trains (an epoch from 0 to 900
    with a wait for a batch, a step and a cell-list rebuild in it); a
    worker runs a server's segment (400 to 800) with a replay in it."""
    prof = fake([
        event(WINDOW, 0, 1000),
        event(WINDOW, 0, 1000, device=True),            # its mirror
        event("cudaLaunchKernel", 40, 45, corr=1),
        event("op1", 50, 100, device=True, corr=1),
        event("aten::add", 305, 320, corr=2),           # not a launch
        event("cudaLaunchKernel", 310, 315, corr=2),
        event("op2", 300, 350, device=True, corr=2),
        event("cudaGraphLaunch", 550, 555, corr=3, thread=CUPTI),
        event("op3", 560, 600, device=True, corr=3),
        event("cudaLaunchKernel", 640, 645, corr=4),
        event("op4", 650, 700, device=True, corr=4),
        event("cudaLaunchKernel", 950, 955, corr=5),
        event("op5", 960, 970, device=True, corr=5),
        event("cudaLaunchKernel", 975, 978, corr=6),
        event("op6", 985, 990, device=True, corr=6),
        event("op7", 992, 995, device=True, corr=7),    # no launch
    ])
    spans = Spans([
        Span("train.epoch", 0, 900, MAIN, None, None),
        Span("serve.queued", 100, 700, None, None, 1),
        Span("train.wait_batch", 100, 300, MAIN, "train.epoch", None),
        Span("serve.queued", 200, 250, None, None, 2),
        Span("train.step", 300, 400, MAIN, "train.epoch", None),
        Span("serve.segment", 400, 800, WORKER, None, None),
        Span("serve.replay", 500, 600, WORKER, "serve.segment", None),
        Span("geometry.cell_list", 600, 700, MAIN, "train.epoch", None),
        Span("serve.queued", 1200, 1300, None, None, 3),
    ])
    spans.threads = {MAIN: ("MainThread", 0x7F00_0000_0001),
                     WORKER: ("worker", IDENT)}
    return prof, spans


def test_idle_and_device_time_by_span():
    prof, spans = made_up()
    t = sp.Timeline.from_profile(prof)
    assert t.window == (0, 1000)
    assert len(t.device) == 7                   # the mirror left out
    assert t.launches[2] == (310, MAIN)
    assert t.busy_s == pytest.approx((50 + 50 + 40 + 50 + 10 + 5 + 3) * 1e-9)
    idle = sp.idle_by_span(t, spans)
    assert dict(idle) == pytest.approx({
        "train.epoch": (50 + 260) * 1e-9,    # before op1; 700 to 960
        "train.wait_batch": 200e-9,          # 100 to 300, mid 200
        "serve.segment": 210e-9,             # 350 to 560, the worker's
        "geometry.cell_list": 50e-9,         # 600 to 650
        "outside any span (MainThread)": 15e-9,   # 970 to 985
        sp.UNTRACED: 2e-9,                   # 990 to 992: op7's
        sp.AFTER_LAST: 5e-9,                 # 995 to 1000
    })
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)
    dev = sp.device_by_span(t, spans)
    assert dev == {"train.epoch": [(50, 100)],
                   "train.step": [(300, 350)],
                   "serve.replay": [(560, 600)],
                   "geometry.cell_list": [(650, 700)],
                   "outside any span (MainThread)": [(960, 970),
                                                     (985, 990)],
                   sp.UNTRACED: [(992, 995)]}


def test_the_four_readings():
    prof, spans = made_up()
    t = sp.Timeline.from_profile(prof)
    got = sp.readings(t, spans, t.window)
    assert got == pytest.approx({
        "queue_wait_p95_ms.serve": float(np.percentile([600e-6, 50e-6], 95)),
        "scheduler_busy.serve": 40.0,
        "input_stall.train": 20.0,
        "cell_list_share.rollout": 100.0 * 50 / 208,
    })
    # nothing to read: no queue, no segment, no step, no rebuild
    assert sp.readings(t, Spans(), t.window) == {}
    assert sp.readings(None, spans, t.window) == pytest.approx({
        k: got[k] for k in ("queue_wait_p95_ms.serve",
                            "scheduler_busy.serve")})


def test_innermost_takes_the_latest_open_span():
    spans = [Span("a", 0, 100, 1, None, None),
             Span("b", 10, 20, 1, "a", None),
             Span("c", 10, 50, 1, "a", None),      # b and c start together
             Span("d", 0, 100, 2, None, None)]
    got = sp.innermost(spans, [(5, 1), (15, 1), (30, 1), (60, 1), (30, 2),
                               (150, 1), (30, 3)])
    assert got == ["a", "b", "c", "a", "d", None, None]


TRACED = ("res, prof, got = spans.traced(args, require_cuda=False, "
          "device='cpu')\n"
          "out = None if prof is None else spans.report(prof, got)\n")
COST = ("res, got = spans.spans_on(args, require_cuda=False, device='cpu')\n"
        "out = sorted({s.name for s in got})\n")


def traced(root, cell: str, trace: int, seed: int = 3_000_000_011,
           how: str = TRACED) -> dict:
    """``spans.traced`` (or ``how``) of a cell of the tiny copy in a fresh
    process: the harness's result line and the spans' report (None at
    trace 0)."""
    code = (
        "import json\n"
        "from portbench import run, spans\n"
        f"args = run.parse(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '1', '--trace', '{trace}'])\n"
        + how + "print(json.dumps({'result': res, 'spans': out}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(root), str(tiny.REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(out.stderr[-4000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("portbench_spans"))


SPANS = {"bba.rollout.s1": {"rollout.call"},
         "solvated10k.rollout": {"rollout.call", "geometry.cell_list"},
         "bba.serve.open": {"serve.queued", "serve.admit", "serve.segment",
                            "serve.replay", "serve.read", "rollout.call"},
         tiny.ONE_RANK: {"train.epoch", "train.wait_batch", "train.put",
                         "train.step", "train.read_metrics",
                         "train.produce"}}


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_a_traced_run_with_spans(root, cell):
    """The harness's line is as a traced run without spans has it (the
    same metrics and checks), and the spans the cell's layers promise are
    there. Without a card only the server's readings have something to
    read."""
    got = traced(root, cell, trace=1)
    plain = tiny.execute(root, cell, seed=3_000_000_011, trace=1)
    res, rep = got["result"], got["spans"]
    assert res["correct"] is True and plain["correct"] is True
    assert set(res["metrics"]) == set(plain["metrics"])
    assert set(res["checks"]) == set(plain["checks"])
    assert SPANS[cell] <= set(rep["spans"])
    want = ({"queue_wait_p95_ms.serve", "scheduler_busy.serve"}
            if cell == "bba.serve.open" else set())
    assert set(rep["readings"]) == want
    for v in rep["readings"].values():
        assert v > 0


def test_a_run_at_trace_0_records_no_span(root):
    got = traced(root, "bba.serve.open", trace=0)
    assert got["spans"] is None
    assert set(got["result"]["metrics"]) == {"request_p95_ms", "setup_s"}


def test_spans_on_for_a_whole_untraced_run(root):
    got = traced(root, "bba.serve.open", trace=0, how=COST)
    assert got["result"]["correct"] is True
    assert set(got["result"]["metrics"]) == {"request_p95_ms", "setup_s"}
    assert {"serve.queued", "serve.segment", "serve.read"} <= set(
        got["spans"])
