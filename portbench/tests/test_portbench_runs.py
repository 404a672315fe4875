"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped, the program on its plain path): the last line's
schema, the judgement passing the program, and failing it where the
timed path is broken underneath."""

import json

import pytest

from portbench import run as harness
from portbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]] + [tiny.ONE_RANK]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(root, cell, trace):
    res = tiny.execute(root, cell, trace=trace)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert list(res)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name
    e2e = harness.end_to_end_for(bench, cell)
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    if trace == 0:
        assert set(res["metrics"]) == {m["name"] for m in e2e}
    else:
        allowed = {m["name"] for m in harness.per_layer_for(
            bench, cell, {m["name"] for m in e2e})}
        assert set(res["metrics"]) <= allowed
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0


# the timed path broken underneath: the persistent rollout's step (the
# rollout kernels and the server) and the plain rollout's step
PR = ("from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import "
      "persistent_rollout as pr\n")
SCAN = ("from molecular_dynamics_neural_operator_tpu_torch.rollout import "
        "scan\n")
LOOP = ("from molecular_dynamics_neural_operator_tpu_torch.train import "
        "loop\n"
        "from molecular_dynamics_neural_operator_tpu_torch.parallel import "
        "mesh\n")
FAULTS = {
    "state_unchanged": {
        "pr": PR + (
            "def step(bufs, weights, cfg, threshold, clip, window, coords):\n"
            "    coords.copy_(window[:, -1])\n"
            "    window.copy_(torch.cat([window[:, 1:], coords[:, None]],"
            " 1))\n"
            "import torch\npr.step = step\n"),
        "scan": SCAN + (
            "def _step(params, cfg, aa, window, *a, **k):\n"
            "    out = window[..., -1, :, :]\n"
            "    return torch.cat([window[..., 1:, :, :],"
            " out[..., None, :, :]], dim=-3), out,"
            " torch.zeros((), dtype=torch.bool)\n"
            "import torch\nscan._step = _step\n"),
        "train": LOOP + (
            "def apply_update(state, grads, tx):\n"
            "    return state._replace(step=state.step + 1)\n"
            "loop.apply_update = mesh.apply_update = apply_update\n"),
    },
    "half_batch": {
        "train": LOOP + (
            "orig = loop._loss_fn\n"
            "def _loss_fn(params, cfg, g):\n"
            "    h = g.window.shape[0] // 2\n"
            "    half = type(g)(aa=g.aa, window=g.window[:h],\n"
            "                   graph=type(g.graph)(*(t[:h]"
            " for t in g.graph)),\n"
            "                   y=g.y[:h])\n"
            "    l2, aux = orig(params, cfg, half)\n"
            "    return 2 * l2, aux\n"
            "loop._loss_fn = mesh._loss_fn = _loss_fn\n"),
    },
    "exchange_left_out": {
        "dp": LOOP + (
            "def sum_over_data(grads, l2, m, overflow, group, n):\n"
            "    return grads, l2, m, overflow\n"
            "mesh.sum_over_data = sum_over_data\n"),
    },
    "answer_altered": {
        "pr": PR + (
            "head = pr.conv_head\n"
            "def conv_head(bufs, weights, cfg, clip, window, coords):\n"
            "    head(bufs, weights, cfg, clip, window, coords)\n"
            "    coords[:, 0, 0] += 1e-2\n"
            "    window[:, -1, 0, 0] += 1e-2\n"
            "pr.conv_head = conv_head\n"),
        "scan": SCAN + (
            "orig = scan._step\n"
            "def _step(*a, **k):\n"
            "    w, out, over = orig(*a, **k)\n"
            "    out = out.clone(); out[..., 0, 0] += 1e-2\n"
            "    w = w.clone(); w[..., -1, 0, 0] += 1e-2\n"
            "    return w, out, over\n"
            "scan._step = _step\n"),
        "train": LOOP + (
            "orig = loop.apply_update\n"
            "def apply_update(state, grads, tx):\n"
            "    new = orig(state, grads, tx)\n"
            "    old = state.params['conv1']['root']\n"
            "    new_root = new.params['conv1']['root']\n"
            "    new.params['conv1']['root'] = old + 2 * (new_root - old)\n"
            "    return new\n"
            "loop.apply_update = mesh.apply_update = apply_update\n"),
    },
}


def kinds(cell: str) -> tuple:
    if ".train." in cell:
        return ("train", "dp") if cell.endswith("dp4") else ("train",)
    return ("scan",) if cell.startswith("solvated") else ("pr",)


CASES = [(cell, fault, k) for cell in CELLS for fault in sorted(FAULTS)
         for k in kinds(cell) if k in FAULTS[fault]]


@pytest.mark.parametrize("cell,fault,kind", CASES)
def test_broken_timed_path_is_not_correct(root, cell, fault, kind):
    res = tiny.execute(root, cell, patch=FAULTS[fault][kind])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_overflow_is_judged_not_failed(tmp_path):
    """Frames over their edge slots keep the first ones in row-major
    order and are flagged, in the program and the reference alike: the
    run is correct. A program that drops the flag is not."""
    root = tiny.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    path = root / next(c["file"] for c in bench["configs"]
                       if c["name"] == "bba_1fme_sparse")
    cfg = json.loads(path.read_text())
    cfg["model"]["max_edges"] = 150         # the chain's frames hold 170+
    path.write_text(json.dumps(cfg))
    res = tiny.execute(root, "bba.rollout.s1")
    assert res["correct"] is True
    drop = PR + (
        "encode = pr.graph_encode\n"
        "def graph_encode(window, weights, threshold, out):\n"
        "    encode(window, weights, threshold, out)\n"
        "    out.overflow.zero_()\n"
        "pr.graph_encode = graph_encode\n")
    res = tiny.execute(root, "bba.rollout.s1", patch=drop)
    assert res["correct"] is False
    assert res["checks"]["overflow_flags_wrong"]["value"] > 0
