"""The two cells of the FNO-3d configuration's PR at a tiny size on the
CPU: ``lambda.fno3d.block40`` (FNO-3d's 40-frame block,
``entries/train_fno3d.py`` against ``reference/fno3d.py``) and
``bba.curriculum.k4`` (the K = 4 curriculum on the sparse graph,
``entries/train_curriculum_sparse.py`` against ``reference/
curriculum_sparse.py``), run through ``portbench.run`` in a copy, as
``test_portbench_fno.py`` runs its cells; broken timed paths judged not
correct; both cells' controls; FNO-3d's readers on a made-up timeline;
and ``counts/fno3d.py`` against a hand count."""

import importlib.util
import json
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import control_curriculum_sparse, control_fno3d
from portbench import run as harness
from portbench.counts import fno3d as counts
from portbench.tests import tiny
from portbench.trace import WINDOW, Trace

FNO3D_CELL, SPARSE_CELL = "lambda.fno3d.block40", "bba.curriculum.k4"
CHAIN = {"source": "chain", "num_frames": 120, "chain_seed": 13}
SMALL = {"fno3d_block_t40_tiny": {"batch_size": 4, "start": CHAIN,
                                  "check": {"steps": 3, "chunk": 2}},
         "curriculum_k4_sparse_tiny": {"batch_size": 8, "start": CHAIN}}


def _small(root, mixes=SMALL):
    for mix, changes in mixes.items():
        path = root / "portbench" / "traffic" / f"{mix}.json"
        if path.exists():
            body = json.loads(path.read_text())
            body.update(changes)
            path.write_text(json.dumps(body))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny copy (width 8, depth 2; FNO-3d keeps its grid of 80 x 80 x
    46) whose new mixes hold 4 and 8 windows a batch of a 120-frame
    chain."""
    return _small(tiny.make(tmp_path_factory.mktemp("fno3d")))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [FNO3D_CELL, SPARSE_CELL])
def test_the_new_cells_run_and_are_correct(root, cell, trace):
    res = tiny.execute(root, cell, trace=trace)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert res["correct"] is True and res["failed"] == 0, res
    assert res["attempted"] >= 1
    e2e = {m["name"] for m in harness.end_to_end_for(bench, cell)}
    assert e2e == {"setup_s", "train_samples_per_s"}
    if trace == 0:
        assert set(res["metrics"]) == e2e
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        allowed = {m["name"] for m in harness.per_layer_for(bench, cell, e2e)}
        assert set(res["metrics"]) <= allowed
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


FNO3D = ("from molecular_dynamics_neural_operator_tpu_torch.models import "
         "fno3d\n"
         "from molecular_dynamics_neural_operator_tpu_torch.train import "
         "state\n")
CURRICULUM = ("from molecular_dynamics_neural_operator_tpu_torch.train "
              "import curriculum\n")
FAULTS = {
    FNO3D_CELL: {
        "state_unchanged": FNO3D + (
            "def apply_update(st, grads, tx):\n"
            "    return st._replace(step=st.step + 1)\n"
            "state.apply_update = apply_update\n"),
        "answer_altered": FNO3D + (
            "orig = state.apply_update\n"
            "def apply_update(st, grads, tx):\n"
            "    new = orig(st, grads, tx)\n"
            "    old = st.params['lift']['w']\n"
            "    new.params['lift']['w'] = old + 2 * (new.params['lift']"
            "['w'] - old)\n"
            "    return new\n"
            "state.apply_update = apply_update\n"),
        "one_corner": FNO3D + (
            "orig = fno3d._corner_weights\n"
            "def _corner_weights(sp):\n"
            "    w = orig(sp)\n"
            "    m1 = w.shape[2] // 2\n"
            "    return torch.cat([w[:, :, :m1], 0 * w[:, :, m1:]], 2)\n"
            "import torch\n"
            "fno3d._corner_weights = _corner_weights\n"),
        "no_time_pad": FNO3D + (
            "orig = fno3d._lift\n"
            "def _lift(params, cfg, x):\n"
            "    h = orig(params, cfg, x)\n"
            "    return torch.cat([h[..., :cfg.out_frames],"
            " h[..., :cfg.time_pad]], -1)\n"
            "import torch\n"
            "fno3d._lift = _lift\n"),
    },
    SPARSE_CELL: {
        "state_unchanged": CURRICULUM + (
            "def apply_update(st, grads, tx):\n"
            "    return st._replace(step=st.step + 1)\n"
            "curriculum.apply_update = apply_update\n"),
        "one_step_unrolled": CURRICULUM + (
            "orig = curriculum.curriculum_loss_batched\n"
            "def loss(params, cfg, gbatch, y_seq, **kw):\n"
            "    return orig(params, cfg, gbatch, y_seq[:, :1], **kw)\n"
            "curriculum.curriculum_loss_batched = loss\n"),
    },
}
CASES = [(cell, f) for cell in FAULTS for f in sorted(FAULTS[cell])]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_step_is_not_correct(root, cell, fault):
    res = tiny.execute(root, cell, patch=FAULTS[cell][fault])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    """A copy at the published widths whose new mixes hold 4 and 8
    windows a batch."""
    return _small(tiny.make(tmp_path_factory.mktemp("fno3d_wide"),
                            widths=True),
                  {"fno3d_block_t40_tiny": dict(
                      SMALL["fno3d_block_t40_tiny"], batch_size=2,
                      check={"steps": 3, "chunk": 1}),
                   "curriculum_k4_sparse_tiny": SMALL[
                       "curriculum_k4_sparse_tiny"]})


def test_the_fno3d_control_fails_a_limit(wide):
    """The reference with its products' operands rounded to TF32, in the
    program's place, fails a limit the program passes, at the published
    widths (on the CPU ``tf32`` is the program itself: the flags move no
    CPU product)."""
    low = control_fno3d.readings(FNO3D_CELL, 11, "tf32-operands", "cpu",
                                 wide)
    limits = low["limits"]
    assert any(low[n] > limits[n] for n in limits), low
    # the loss limit is set from the card's readings (at most 1.19e-7);
    # the CPU's transforms sum in another order (1.35e-6 at B = 2), and
    # the loss does not tell TF32 from f32 on either device
    mine = control_fno3d.readings(FNO3D_CELL, 11, "program", "cpu", wide)
    assert all(mine[n] <= limits[n] for n in ("grad_gap", "move_gap")), mine
    assert low["grad_gap"] > 10 * mine["grad_gap"], (low, mine)


def test_the_sparse_curriculum_control_fails_a_limit(wide):
    """The reference in fp8 in the program's place fails a limit, at the
    published widths."""
    low = control_curriculum_sparse.readings(SPARSE_CELL, 11, "fp8", "cpu",
                                             wide)
    limits = low["limits"]
    assert any(low[n] > limits[n] for n in ("loss_gap", "grad_gap",
                                            "move_gap")), low


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


MODEL = json.loads((tiny.REPO / "portbench/configs/lambda_repressor_fno3d"
                    ".json").read_text())["model"]


def made_up_run(counters):
    """A 1 ms window, 600 us of it busy: a complex GEMM 0-300, a complex
    elementwise pass 200-400 (overlapping it), a real GEMM 500-700."""
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
                           chips=1, work={"batch_size": 32})


def test_the_readers_on_a_made_up_timeline():
    z = MODEL["out_frames"] + MODEL["time_pad"]
    run = made_up_run({"fno3d_steps": 2, "fno3d_points": 2 * 32 * 80 * 80 * z,
                       "fno3d_frames": 2 * 32 * 40,
                       "fno3d_spectral_dft": 8})
    assert reader("spectral_share.fno3d")(run) == pytest.approx(
        100.0 * 400 / 600)
    want = 2 * counts.block_step_flops(MODEL, 32, 80)
    assert reader("mfu.fno3d")(run) == pytest.approx(
        100.0 * want / (1e-3 * 67e12))
    # a B = 32 step is 491 GFLOP at the published sizes on 80 x 80 x 46
    assert 490e9 < want / 2 < 492e9


def test_mfu_reads_nothing_without_the_counters():
    """The parent has no FNO-3d counters: the reader returns None and the
    line leaves the metric out."""
    assert reader("mfu.fno3d")(made_up_run({})) is None
    assert reader("mfu.fno3d")(made_up_run({"fno3d_steps": 3})) is None


def test_fno3d_counts_by_hand():
    """R = 4, width 2, modes 1/1/2, depth 1, 2 frames in and 3 out, pad 1
    (Z = 4), projection 3, B = 1."""
    model = dict(width=2, modes1=1, modes2=1, modes3=2, depth=1,
                 window_size=2, out_frames=3, time_pad=1, projection=3)
    time = 4 * 4 * 4 * 2 * 4 * 2            # R R c Z m3, 4 FLOPs a term
    second = 8 * 2 * 4 * 2 * 4 * 2           # c X 2m2 Y m3
    first = 8 * 2 * 2 * 4 * 2 * 2            # c 2m1 X 2m2 m3
    mix = 8 * 2 * 2 * 2 * 2 * 2
    assert counts.spectral_flops(model, 4) == 2 * (time + second + first) \
        + mix == 5_376
    one = (5_376 + 2 * 16 * 4 * 4 + 2 * (16 * 2 * 2 + 16 * 3 * 3 * 2)
           + 2 * 16 * 3 * (2 * 3 + 3))
    assert counts.call_flops(model, 1, 4) == one
    params = (5 * 2 + 2 + 2 * 4 * 2 * 2 * 1 * 1 * 2 + 4 + 2 + 2 * 3 + 3
              + 3 + 1)
    assert counts.parameters(model) == params == 95
    assert counts.call_bytes(model, 1, 4) == 4 * (params + 16 * 5)
    assert counts.block_step_flops(model, 1, 4) == 3 * one
