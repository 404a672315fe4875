"""The two training cells of the villin configuration's PR at a tiny size
on the CPU: ``villin.curriculum.k4`` (the K = 4 curriculum on the dense
graph, ``entries/train_curriculum.py`` against ``reference/
curriculum.py``) and ``bba.train.b128`` (the teacher-forced step on one
card), run through ``portbench.run`` in a copy, as
``test_portbench_adding.py`` runs its cell; the curriculum cell's three
readers on a made-up timeline; and ``counts/gkn_dense.py`` against a hand
count."""

import importlib.util
import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import run as harness
from portbench.counts import gkn_dense
from portbench.tests import tiny
from portbench.trace import WINDOW, Trace

CELLS = ["villin.curriculum.k4", "bba.train.b128"]
SMALL_MIX = {"batch_size": 8, "start": {"source": "chain", "num_frames": 120,
                                        "chain_seed": 13}}
BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy whose two mixes hold 8 windows a batch of a 120-frame
    chain."""
    root = tiny.make(tmp_path_factory.mktemp("curriculum"))
    for mix in ("curriculum_k4_tiny", "train_b128_tiny"):
        path = root / "portbench" / "traffic" / f"{mix}.json"
        body = json.loads(path.read_text())
        body.update(SMALL_MIX)
        path.write_text(json.dumps(body))
    return root


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_new_cells_run_and_are_correct(root, cell, trace):
    res = tiny.execute(root, cell, trace=trace)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert res["correct"] is True and res["failed"] == 0, res
    assert res["attempted"] >= 1
    e2e = {m["name"] for m in harness.end_to_end_for(bench, cell)}
    assert e2e == {"train_samples_per_s", "setup_s"}
    if trace == 0:
        assert set(res["metrics"]) == e2e
    else:
        allowed = {m["name"] for m in harness.per_layer_for(bench, cell, e2e)}
        assert set(res["metrics"]) <= allowed
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


CURRICULUM = ("from molecular_dynamics_neural_operator_tpu_torch.train import "
              "curriculum\n")
FAULTS = {
    "state_unchanged": CURRICULUM + (
        "def apply_update(state, grads, tx):\n"
        "    return state._replace(step=state.step + 1)\n"
        "curriculum.apply_update = apply_update\n"),
    "answer_altered": CURRICULUM + (
        "orig = curriculum.apply_update\n"
        "def apply_update(state, grads, tx):\n"
        "    new = orig(state, grads, tx)\n"
        "    old = state.params['conv1']['root']\n"
        "    new_root = new.params['conv1']['root']\n"
        "    new.params['conv1']['root'] = old + 2 * (new_root - old)\n"
        "    return new\n"
        "curriculum.apply_update = apply_update\n"),
    "one_step_unrolled": CURRICULUM + (
        "orig = curriculum.curriculum_loss_batched\n"
        "def loss(params, cfg, gbatch, y_seq, **kw):\n"
        "    l2, aux = orig(params, cfg, gbatch, y_seq[:, :1], **kw)\n"
        "    return l2, aux\n"
        "curriculum.curriculum_loss_batched = loss\n"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_curriculum_step_is_not_correct(root, fault):
    res = tiny.execute(root, "villin.curriculum.k4", patch=FAULTS[fault])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def reader(name: str):
    path = tiny.REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def event(name, start, end, device):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start,
        duration_ns=lambda: end - start,
        device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU)


MODEL = json.loads((tiny.REPO / "portbench/configs/villin_hp35_dense.json")
                   .read_text())["model"]


def made_up_run(counters):
    """A 1 ms window, 600 us of it busy: a GEMM 0-300, an
    elementwise pass 200-400 (overlapping it), a copy 500-700."""
    events = [event(WINDOW, 0, 1_000_000, False),
              event("nvjet_tss_256x128_64x4_h_bz_NNT", 0, 300_000, True),
              event("void at::native::vectorized_elementwise_kernel", 200_000,
                    400_000, True),
              event("Memcpy DtoD (Device -> Device)", 500_000, 700_000, True)]
    results = SimpleNamespace(events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    return SimpleNamespace(trace=Trace(prof), counters=counters, model=MODEL,
                           chips=1, work={"batch_size": 128})


def test_the_readers_on_a_made_up_timeline():
    pairs = 128 * 35 * 35
    run = made_up_run({"curriculum_steps": 1, "curriculum_unrolled": 4,
                       "curriculum_supervised": 4, "dense_pairs": 4 * pairs})
    assert reader("device_idle.curriculum")(run) == pytest.approx(40.0)
    # not a product: 200-400 (its 200-300 overlaps the GEMM) and 500-700
    assert reader("kernel_tensor_share.curriculum")(run) == pytest.approx(
        100.0 * 400 / 600)
    want = 12 * gkn_dense.step_flops(MODEL, pairs, 128)
    assert reader("mfu.curriculum")(run) == pytest.approx(
        100.0 * want / (1e-3 * 989e12))
    # a step is 19.9 TFLOP at villin's shapes
    assert 19.8e12 < want < 20.0e12


def test_mfu_reads_nothing_without_the_counters():
    """The parent has no counters: the reader returns None and the line
    leaves the metric out."""
    assert reader("mfu.curriculum")(made_up_run({})) is None


def test_dense_counts_by_hand():
    """R = 5, T = 2, width 4, ker_width 8, depth 1, bf16, B = 2: 50 pairs."""
    model = dict(num_residues=5, window_size=2, width=4, ker_width=8,
                 depth=1, compute_dtype="bfloat16")
    enc = 10 * (2 * 2 * (2 * 3 * 12) + 2 * 9 + 2 * 7 * 4)
    mlp = 2 * 50 * (6 * 8 + 8 * 8 + 8 * 16)
    convs = 2 * (2 * 50 * 16 + 2 * 2 * 5 * 16)
    head = 2 * 5 * 2 * 4 * 3
    one = enc + mlp + convs + head
    assert gkn_dense.step_flops(model, 50, 2) == one == 31_700
    weights = (6 * 8 * 2 + 4 * 8) + (8 * 8 * 2 + 4 * 8) + (8 * 16 * 2 + 4 * 16)
    conv = 50 * 16 * 2 + 2 * 4 * 2 * 5 * 4 + 4 * 2 * 5 + 16 * 2 + 4 * 4
    frames = 4 * 2 * 2 * 5 * 3 + 4 * 2 * 5 * 3
    nbytes = weights + 50 * (6 * 2 + 16 * 2) + 2 * conv + frames
    assert gkn_dense.step_bytes(model, 50, 2) == nbytes == 7_184
    assert gkn_dense.curriculum_flops(model, 50, 2, 4, 3) == 10 * one
    assert gkn_dense.curriculum_bytes(model, 50, 2, 4, 4) == 12 * nbytes


def test_the_villin_configuration_and_its_entries():
    cfg = next(c for c in BENCH["configs"] if c["name"] == "villin_hp35_dense")
    body = json.loads((tiny.REPO / cfg["file"]).read_text())
    assert cfg["reduced"] == body["reduced"] == []
    m = body["model"]
    assert (m["width"], m["ker_width"], m["depth"], m["window_size"],
            m["num_residues"], m["graph_mode"], m["compute_dtype"]) == (
        64, 1024, 6, 10, 35, "dense", "bfloat16")
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells["villin.curriculum.k4"]["config"] == "villin_hp35_dense"
    assert cells["bba.train.b128"]["config"] == "bba_1fme_sparse"
    assert all(cells[c]["chips"] == 1 for c in CELLS)
    e2e = next(m for m in BENCH["end_to_end"]
               if m["name"] == "train_samples_per_s")
    assert set(CELLS) <= set(e2e["workloads"])
    for name in ("mfu.curriculum", "device_idle.curriculum",
                 "kernel_tensor_share.curriculum"):
        metric = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert metric["workloads"] == ["villin.curriculum.k4"]
        assert metric["moves"] == "train_samples_per_s"
