"""The two cells of the λ-repressor FNO configuration's PR at a tiny size
on the CPU: ``lambda.fno.curriculum.k4`` (FNO-2d's K = 4 curriculum,
``entries/train_fno_curriculum.py`` against ``reference/fno.py``) and
``bba.serve.saturated`` (the server above its knee, judged by its
throughput), run through ``portbench.run`` in a copy, as
``test_portbench_adding.py`` runs its cell; broken timed paths judged
not correct; the FNO cell's control; its two readers on a made-up
timeline; and ``counts/fno.py`` against a hand count."""

import importlib.util
import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import control_fno
from portbench import run as harness
from portbench.counts import fno as counts
from portbench.tests import tiny
from portbench.trace import WINDOW, Trace

FNO_CELL, SERVE_CELL = "lambda.fno.curriculum.k4", "bba.serve.saturated"
SMALL = {"fno_curriculum_k4_tiny": {
    "batch_size": 8, "check": {"steps": 3, "chunk": 4},
    "start": {"source": "chain", "num_frames": 120, "chain_seed": 13}},
    "serve_saturated_tiny": {"rate_per_s": 20.0, "length_max": 96}}
BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())


def _small(root):
    for mix, changes in SMALL.items():
        path = root / "portbench" / "traffic" / f"{mix}.json"
        body = json.loads(path.read_text())
        body.update(changes)
        path.write_text(json.dumps(body))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy (width 8, depth 2) whose FNO mix holds 8 windows a
    batch of a 120-frame chain and whose saturated mix offers 20 short
    requests a second."""
    return _small(tiny.make(tmp_path_factory.mktemp("fno")))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [FNO_CELL, SERVE_CELL])
def test_the_new_cells_run_and_are_correct(root, cell, trace):
    res = tiny.execute(root, cell, trace=trace)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert res["correct"] is True and res["failed"] == 0, res
    assert res["attempted"] >= 1
    e2e = {m["name"] for m in harness.end_to_end_for(bench, cell)}
    assert e2e == {"setup_s", "train_samples_per_s" if cell == FNO_CELL
                   else "rollout_steps_per_s"}
    if trace == 0:
        assert set(res["metrics"]) == e2e
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        allowed = {m["name"] for m in harness.per_layer_for(bench, cell, e2e)}
        assert set(res["metrics"]) <= allowed
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


FNO = ("from molecular_dynamics_neural_operator_tpu_torch.models import "
       "fno\n"
       "from molecular_dynamics_neural_operator_tpu_torch.train import "
       "state\n")
FAULTS = {
    "state_unchanged": FNO + (
        "def apply_update(st, grads, tx):\n"
        "    return st._replace(step=st.step + 1)\n"
        "state.apply_update = apply_update\n"),
    "answer_altered": FNO + (
        "orig = state.apply_update\n"
        "def apply_update(st, grads, tx):\n"
        "    new = orig(st, grads, tx)\n"
        "    old = st.params['lift']['w']\n"
        "    new.params['lift']['w'] = old + 2 * (new.params['lift']['w']"
        " - old)\n"
        "    return new\n"
        "state.apply_update = apply_update\n"),
    "one_step_unrolled": FNO + (
        "orig = fno.fno_curriculum_loss\n"
        "def loss(cfg, k, weights=None):\n"
        "    one = orig(cfg, 1, weights)\n"
        "    return lambda p, b: one(p, dict(b, y_seq=b['y_seq'][:, :1]))\n"
        "fno.fno_curriculum_loss = loss\n"),
    "no_feedback": FNO + (
        "fno.sym_zero_diag = lambda p: 0.0 * p\n"),
}
ALTERED_HEAD = (
    "from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import "
    "persistent_rollout as pr\n"
    "head = pr.conv_head\n"
    "def conv_head(bufs, weights, cfg, clip, window, coords):\n"
    "    head(bufs, weights, cfg, clip, window, coords)\n"
    "    coords[:, 0, 0] += 1e-2\n"
    "    window[:, -1, 0, 0] += 1e-2\n"
    "pr.conv_head = conv_head\n")


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_fno_step_is_not_correct(root, fault):
    res = tiny.execute(root, FNO_CELL, patch=FAULTS[fault])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_a_broken_server_step_is_not_correct(root):
    res = tiny.execute(root, SERVE_CELL, patch=ALTERED_HEAD)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """A copy at the published widths whose FNO mix holds 8 windows a
    batch."""
    return _small(tiny.make(tmp_path_factory.mktemp("fno_wide"),
                            widths=True))


def test_the_control_fails_a_limit(wide):
    """The reference with its products' operands rounded to TF32, in the
    program's place, fails a limit the program passes (on the CPU
    ``tf32`` is the program itself: the flags move no CPU product)."""
    low = control_fno.readings(FNO_CELL, 11, "tf32-operands", "cpu", wide)
    limits = low["limits"]
    assert any(low[n] > limits[n] for n in limits), low
    mine = control_fno.readings(FNO_CELL, 11, "program", "cpu", wide)
    assert all(mine[n] <= limits[n] for n in limits), mine


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


MODEL = json.loads((tiny.REPO / "portbench/configs/lambda_repressor_fno2d"
                    ".json").read_text())["model"]


def made_up_run(counters):
    """A 1 ms window, 600 us of it busy: a complex GEMM 0-300, a
    complex elementwise pass 200-400 (overlapping it), a real GEMM
    500-700."""
    events = [event(WINDOW, 0, 1_000_000, False),
              event("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nn_n_tilesize32x64x8"
                    "_stage3_warpsize2x2x1_ffma_aligna8_alignc8_execute_"
                    "kernel__5x_cublas", 0, 300_000, True),
              event("void at::native::vectorized_elementwise_kernel<2, "
                    "at::native::CUDAFunctor_add<c10::complex<float> >, "
                    "std::array<char*, 3ul> >", 200_000, 400_000, True),
              event("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64_8x5"
                    "_nt_align1>(cutlass_80_simt_sgemm_64x64_8x5_nt_align1"
                    "::Params)", 500_000, 700_000, True)]
    results = SimpleNamespace(events=lambda: events)
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))
    return SimpleNamespace(trace=Trace(prof), counters=counters, model=MODEL,
                           chips=1, work={"batch_size": 128})


def test_the_readers_on_a_made_up_timeline():
    run = made_up_run({"curriculum_steps": 1, "curriculum_unrolled": 4,
                       "curriculum_supervised": 4,
                       "fno_points": 4 * 128 * 80 * 80})
    # complex: 0-400 of the 600 busy
    assert reader("spectral_share.fno")(run) == pytest.approx(
        100.0 * 400 / 600)
    want = 12 * counts.step_flops(MODEL, 128, 80)
    assert reader("mfu.fno")(run) == pytest.approx(
        100.0 * want / (1e-3 * 67e12))
    # a K = 4 step is 615 GFLOP at λ-repressor's shapes
    assert 610e9 < want < 620e9


def test_mfu_reads_nothing_without_the_counters():
    """The parent has no FNO counters: the reader returns None and the
    line leaves the metric out."""
    assert reader("mfu.fno")(made_up_run({})) is None
    assert reader("mfu.fno")(made_up_run({"curriculum_unrolled": 4})) is None


def test_fno_counts_by_hand():
    """R = 6, width 2, 2 modes an axis, depth 1, 3 channels, B = 1."""
    model = dict(width=2, modes1=2, modes2=2, depth=1, in_channels=3,
                 out_channels=1)
    macs = (4 * 6 * 6 * 2 + 2 * 6 * 4 * 2 + 4 * 2 * 2 * 2 + 6 * 4 * 2 * 2
            + 6 * 2 * 6 * 2)
    assert counts.spectral_macs(model, 6) == macs == 656
    one = 8 * macs + 2 * 36 * 4 + 2 * 36 * (3 * 2 + 2 * 128 + 128)
    assert counts.step_flops(model, 1, 6) == one == 33_616
    params = 3 * 2 + 2 + (2 * 4 * 4 + 4 + 2) + 2 * 128 + 128 + 128 + 1
    assert counts.parameters(model) == params == 559
    assert counts.step_bytes(model, 1, 6) == 4 * (params + 36 * 4)
    assert counts.curriculum_flops(model, 1, 6, 4, 3) == 10 * one
