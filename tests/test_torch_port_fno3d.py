"""FNO-3d's block forecast on distance matrices, held against the
benchmark's plain reference (``portbench/reference/fno3d.py``), which
computes the spectral convolution by full complex FFTs of the padded grid
rather than by either of the program's forms; the inverse of a
non-Hermitian spectrum against the CPU's ``irfftn``; the refusals of
overlapping modes; the step's spans and counters (``utils/profiling.
py``); FNO-3d's operation count (``portbench/counts/fno3d.py``) against
torch's FLOP counter; and ``cli/train.py --operator fno3d`` for one CPU
epoch.

Seeded random weights (``portbench/weights_fno3d.py``: linear layers
uniform +-1/sqrt(fan in), spectral weights U[0, 1)/width^2) at width 4,
modes 3/3/2, depth 2, projection 8; windows of the benchmark's synthetic
chain at R = 12, 3 frames in and 5 out, time padding 2; B = 4; f32. This
file imports no JAX."""

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from molecular_dynamics_neural_operator_tpu_torch.configs import FNO3dConfig
from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
    distance_matrix_channels,
)
from molecular_dynamics_neural_operator_tpu_torch.models.fno3d import (
    _dft3_tensors,
    _dft_inverse,
    _fft_inverse,
    fno3d_apply,
    fno3d_block_loss,
    fno3d_init,
    make_fno3d_train_step,
    spectral_conv3d,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    TrainState,
    make_optimizer,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    value_and_grad,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling
from portbench import weights_fno3d
from portbench.counts import fno3d as counts
from portbench.reference import fno3d as ref
from portbench.reference.train import leaves
from portbench.traffic import sources

R, T_IN, T, PAD, B = 12, 3, 5, 2, 4
LR, WD, CLIP_NORM = 1e-3, 1e-4, 1.0
MODEL = dict(width=4, modes1=3, modes2=3, modes3=2, depth=2,
             window_size=T_IN, out_frames=T, time_pad=PAD, projection=8,
             num_residues=R, compute_dtype="float32")

# the block (f32 against f32, the transforms taken another way): they
# agree to some 6e-8 of its norm, so 1e-5; TF32 operands move it by 2.7e-4
OUT_RTOL = 1e-5
# the block loss, summed in other orders: some 9e-8 of itself, so 1e-5
# (TF32 operands move it by 7.8e-6: the loss alone does not see them)
LOSS_RTOL = 1e-5
# a gradient leaf's difference over the larger of its norm and the median
# leaf's: up to 7e-7 in f32, so 1e-4; TF32 operands move it by 7.3e-4
GRAD_RTOL = 1e-4
# the weights after one Adam step from the same start: each element moves
# by about the learning rate; f32 keeps the two within 2.3e-4 of it, so
# 2e-3 of it; TF32 operands move them by 0.84 of it
MOVE_ATOL = 2e-3 * LR


def cfg_of(impl: str = "auto", **over) -> FNO3dConfig:
    m = dict(MODEL, **over)
    return FNO3dConfig(
        width=m["width"], modes1=m["modes1"], modes2=m["modes2"],
        modes3=m["modes3"], depth=m["depth"], in_frames=m["window_size"],
        out_frames=m["out_frames"], time_pad=m["time_pad"],
        projection=m["projection"], num_residues=m["num_residues"],
        spectral_impl=impl)


def params_of(seed: int) -> dict:
    return weights_fno3d.make(MODEL, seed, "cpu")


def batch_of(seed: int, b: int = B) -> dict:
    """b windows of the chain (b, T_in, R, 3) with their T-frame
    continuations (b, T, R, 3)."""
    frames, _ = sources.chain_trajectory(200, R, 13)
    idx = np.random.default_rng(seed).choice(200 - T_IN - T, b,
                                             replace=False)
    window = torch.as_tensor(np.stack([frames[f:f + T_IN] for f in idx]))
    y_seq = torch.as_tensor(np.stack([frames[f + T_IN:f + T_IN + T]
                                      for f in idx]))
    return {"window": window, "y": y_seq[:, 0], "y_seq": y_seq}


def test_the_published_sizes_have_the_papers_parameter_count():
    """Modes 8/8/8, width 20, 4 layers, 13 lifted channels, projection
    128: 6,558,377 parameters, the paper's 6,558,537 less its four unused
    BatchNorm3d layers' 160; the benchmark's count agrees."""
    params = fno3d_init(FNO3dConfig(), seed=0)
    assert sum(v.numel() for _, v in leaves(params)) == 6_558_377
    published = dict(width=20, modes1=8, modes2=8, modes3=8, depth=4,
                     window_size=10, out_frames=40, time_pad=6,
                     projection=128)
    assert counts.parameters(published) == 6_558_377
    assert {k: v.shape for k, v in leaves(params)} == {
        k: v.shape for k, v in leaves(weights_fno3d.make(
            published, 0, "cpu"))}


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_fno3d_apply_matches_the_reference(impl, seed):
    """The forward block of both spectral forms against the reference's
    full complex transforms of the padded grid."""
    params, batch = params_of(seed), batch_of(seed)
    x = distance_matrix_channels(batch["window"])
    got = fno3d_apply(params, cfg_of(impl), x)
    want = ref.model_step(params, MODEL, x, ref.rounding_fn())
    assert got.shape == (B, R, R, T)
    assert float((got - want).norm()) <= OUT_RTOL * float(want.norm())


@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_both_forms_invert_a_non_hermitian_spectrum_as_the_cpu(impl):
    """A kept spectrum whose k3 = 0 plane is not Hermitian (random
    complex values), inverted by the form's inverse, against numpy's
    ``irfftn`` of the same half spectrum (a complex inverse over the
    residue axes, then a real inverse over time that drops the DC bin's
    imaginary part), written out here as CPU code does it."""
    nx, ny, nz, m1, m2, m3 = 12, 10, 9, 3, 2, 3
    gen = torch.Generator().manual_seed(5)
    kept = torch.complex(torch.randn(2, 3, 2 * m1, 2 * m2, m3, generator=gen),
                         torch.randn(2, 3, 2 * m1, 2 * m2, m3, generator=gen))
    half = torch.zeros(2, 3, nx, ny, nz // 2 + 1, dtype=torch.complex64)
    for sx, sy, kx, ky in ((slice(None, m1), slice(None, m2), 0, 0),
                           (slice(-m1, None), slice(None, m2), 1, 0),
                           (slice(None, m1), slice(-m2, None), 0, 1),
                           (slice(-m1, None), slice(-m2, None), 1, 1)):
        half[:, :, sx, sy, :m3] = kept[:, :, kx * m1:(kx + 1) * m1,
                                       ky * m2:(ky + 1) * m2]
    want = np.fft.irfftn(half.numpy(), s=(nx, ny, nz), axes=(2, 3, 4))
    z = half[..., :m3]
    if impl == "fft":
        got = _fft_inverse(z, nz)
    else:
        _, _, _, bx, by, bz = _dft3_tensors((nx, ny, nz, m1, m2, m3),
                                            torch.device("cpu"))
        got = _dft_inverse(kept, bx, by, bz,
                           torch.zeros(2, 3, nx, ny, nz))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    assert float(kept[..., 0].imag.abs().max()) > 0.1


@pytest.mark.parametrize("shape,modes", [
    ((12, 12, 7), (7, 3, 2)),      # 2 * m1 > X
    ((12, 10, 7), (3, 6, 2)),      # 2 * m2 > Y
    ((12, 12, 7), (3, 3, 5)),      # m3 > Z // 2 + 1
])
@pytest.mark.parametrize("impl", ["auto", "dft", "fft"])
def test_overlapping_modes_are_refused(shape, modes, impl):
    w = MODEL["width"]
    sp = {"w_real": torch.zeros(4, w, w, *modes),
          "w_imag": torch.zeros(4, w, w, *modes)}
    h = torch.zeros((1, w) + shape)
    with pytest.raises(ValueError, match="overlap"):
        spectral_conv3d(sp, h, *modes, impl, h)


def test_the_init_refuses_overlapping_modes_and_unknown_forms():
    with pytest.raises(ValueError, match="overlap"):
        fno3d_init(cfg_of(modes1=7))
    with pytest.raises(ValueError, match="overlap"):
        fno3d_init(cfg_of(modes3=5))       # Z = 7: 4 bins
    sp = params_of(1)["spectral_0"]
    h = torch.zeros(1, 4, R, R, T + PAD)
    with pytest.raises(ValueError, match="unknown spectral impl"):
        spectral_conv3d(sp, h, 3, 3, 2, "x", h)


def gaps(seed: int, impl: str = "auto", rounding=None) -> dict:
    """The program (f32), or the reference with product operands in
    ``rounding`` in its place, against the f32 reference: the block loss,
    every gradient leaf and the weights after one Adam step (gradient
    clip, L2 decay)."""
    params, batch = params_of(seed), batch_of(seed)
    want_loss, want_grads = ref.loss_and_grads(params, MODEL, batch, chunk=3)
    want = ref.train(params, MODEL, [batch], LR, WD, CLIP_NORM, chunk=3)
    if rounding is None:
        (loss, _), g = value_and_grad(fno3d_block_loss(cfg_of(impl)), params,
                                      batch)
        loss, grads = float(loss), dict(leaves(g))
        tx, _ = make_optimizer(lr=LR, weight_decay=WD,
                               grad_clip_norm=CLIP_NORM,
                               skip_nonfinite_updates=True)
        step = make_fno3d_train_step(cfg_of(impl), tx)
        new, _ = step(TrainState(params, tx.init(params), 0, 0), batch)
        moved = dict(leaves(new.params))
    else:
        loss, grads = ref.loss_and_grads(params, MODEL, batch, rounding,
                                         chunk=3)
        moved = ref.train(params, MODEL, [batch], LR, WD, CLIP_NORM,
                          rounding, chunk=3)["params"]
    norms = {k: float(v.norm()) for k, v in want_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {
        "loss": abs(loss - want_loss) / abs(want_loss),
        "grad": max(float((grads[k] - g).norm()) / max(norms[k], median)
                    for k, g in want_grads.items()),
        "move": max(float((moved[k] - p).abs().max())
                    for k, p in want["params"].items()),
        "leaves": set(grads) == set(want_grads) == set(moved),
    }


@pytest.mark.parametrize("impl", ["dft", "fft"])
@pytest.mark.parametrize("seed", [1, 2])
def test_the_block_step_matches_the_reference(seed, impl):
    """The block loss, every gradient leaf and the weights after one
    train step (clip, decay, Adam) against the reference's."""
    g = gaps(seed, impl)
    assert g["leaves"]
    assert g["loss"] <= LOSS_RTOL, g
    assert g["grad"] <= GRAD_RTOL, g
    assert g["move"] <= MOVE_ATOL, g


def test_the_comparison_fails_tf32_operands():
    """The reference with every product's operands rounded to TF32's
    10-bit mantissa, in the program's place, fails the tolerances the
    program meets."""
    g = gaps(1, rounding="tf32")
    assert (g["loss"] > LOSS_RTOL or g["grad"] > GRAD_RTOL
            or g["move"] > MOVE_ATOL), g
    params, batch = params_of(1), batch_of(1)
    x = distance_matrix_channels(batch["window"])
    want = ref.model_step(params, MODEL, x, ref.rounding_fn())
    low = ref.model_step(params, MODEL, x, ref.rounding_fn("tf32"))
    assert float((low - want).norm()) > 10 * OUT_RTOL * float(want.norm())


def _counted(step, state, batch, n: int) -> dict:
    before = profiling.counters()
    for _ in range(n):
        state, _ = step(state, batch)
    after = profiling.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("impl", ["auto", "fft"])
def test_the_fno3d_counters(impl):
    """Each step call counts one step, B * R^2 * (T + pad) grid points,
    B * T forecast frames and each spectral convolution of the forward
    under its form (``"auto"`` takes the DFT at R = 12); host integers,
    read around the calls."""
    params = params_of(3)
    tx, _ = make_optimizer(lr=LR, weight_decay=WD)
    step = make_fno3d_train_step(cfg_of(impl), tx)
    got = _counted(step, TrainState(params, tx.init(params), 0, 0),
                   batch_of(3), 2)
    form = "dft" if impl == "auto" else "fft"
    assert got == {"fno3d_steps": 2,
                   "fno3d_points": 2 * B * R * R * (T + PAD),
                   "fno3d_frames": 2 * B * T,
                   f"fno3d_spectral_{form}": 2 * MODEL["depth"]}


def test_the_fno3d_span_and_the_frames_it_needs():
    """``train.fno3d`` around each step call, eager or not, recorded only
    under ``tracing()``; a batch with another number of frames is
    refused."""
    params, batch = params_of(4), batch_of(4)
    tx, _ = make_optimizer(lr=LR, weight_decay=WD)
    step = make_fno3d_train_step(cfg_of(), tx)
    state = TrainState(params, tx.init(params), 0, 0)
    state, _ = step(state, batch)              # outside tracing()
    with profiling.tracing() as spans:
        state, _ = step(state, batch)
        step.eager(state, batch)
    assert [s.name for s in spans] == ["train.fno3d"] * 2
    with pytest.raises(ValueError, match="rollout_horizon=5"):
        step(state, dict(batch, y_seq=batch["y_seq"][:, :4]))


@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_the_count_against_torchs_flop_counter(impl):
    """``counts/fno3d.py`` against ``FlopCounterMode`` over the DFT form:
    torch counts 2 FLOPs a multiply-add whatever the dtype, the count 8
    for a complex one, so the count is torch's plus 3x torch's count of
    the complex products (the residue axes' transforms and the mixing).
    The FFT form runs other operations; the count is the same."""
    params, batch = params_of(5), batch_of(5)
    x = distance_matrix_channels(batch["window"])
    with FlopCounterMode(display=False) as whole:
        fno3d_apply(params, cfg_of("dft"), x)
    c, z = MODEL["width"], T + PAD
    _, fx, fy, bx, by, _ = _dft3_tensors((R, R, z, 3, 3, 2),
                                         torch.device("cpu"))
    w = torch.complex(params["spectral_0"]["w_real"],
                      params["spectral_0"]["w_imag"])
    kept = torch.zeros(B * c * R, R, 2, dtype=torch.complex64)
    with FlopCounterMode(display=False) as spectral:
        y = torch.matmul(fy, kept).view(B * c, R, 6 * 2)
        y = torch.matmul(fx, y).view(B, c, 6, 6, 2)
        y = torch.einsum("bixyz,ioxyz->boxyz", y,
                         torch.zeros(c, c, 6, 6, 2, dtype=w.dtype))
        y = torch.matmul(bx, y.reshape(B * c, 6, 6 * 2))
        torch.matmul(by, y.view(B * c * R, 6, 2))
    complex_torch = MODEL["depth"] * spectral.get_total_flops()
    assert counts.call_flops(MODEL, B, R) == (whole.get_total_flops()
                                              + 3 * complex_torch)
    assert counts.block_step_flops(MODEL, B, R) == 3 * counts.call_flops(
        MODEL, B, R)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step as a CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_a_graphed_fno3d_step_counts_its_replays(cuda, impl):
    """On the card the step replays a CUDA graph: its first loss is the
    eager step's, and each replay counts what its capture held, depth
    spectral convolutions of its form."""
    params = weights_fno3d.make(MODEL, 6, cuda)
    batch = {k: v.to(cuda) for k, v in batch_of(6).items()}
    tx, _ = make_optimizer(lr=LR, weight_decay=WD, grad_clip_norm=CLIP_NORM,
                           skip_nonfinite_updates=True)
    step = make_fno3d_train_step(cfg_of(impl), tx)
    state = TrainState(params, tx.init(params), 0, 0)
    _, eager = step.eager(state, batch)
    state, graphed = step(state, batch)
    assert step.graphed.graphs
    torch.testing.assert_close(graphed["rel_l2"], eager["rel_l2"],
                               rtol=1e-5, atol=0.0)
    got = _counted(step, state, batch, 3)
    assert got == {"fno3d_steps": 3,
                   "fno3d_points": 3 * B * R * R * (T + PAD),
                   "fno3d_frames": 3 * B * T,
                   f"fno3d_spectral_{impl}": 3 * MODEL["depth"]}


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        write_synthetic_h5,
    )

    path = tmp_path_factory.mktemp("data") / "traj.h5"
    write_synthetic_h5(path, num_frames=200, num_residues=28, seed=13)
    return path


def test_the_cli_trains_fno3d_for_an_epoch_on_the_cpu(h5, tmp_path):
    """``--operator fno3d`` through ``train_epoch`` on the CPU: the run
    directory's configuration (``config.json`` as the other operators
    write it, ``fno3d.json`` the model's), one finite epoch line and the
    checkpoints; the trained weights have the model's shapes; a second
    epoch from ``--resume`` appends epoch 1."""
    pytest.importorskip("h5py")
    from molecular_dynamics_neural_operator_tpu_torch.cli import train
    from molecular_dynamics_neural_operator_tpu_torch.utils import (
        restore_checkpoint,
    )

    run = tmp_path / "run"
    argv = [
        "--data_path", str(h5), "--run_path", str(run), "--device", "cpu",
        "--operator", "fno3d", "--epochs", "1", "--batch_size", "8",
        "--lr", "1e-3", "--weight_decay", "1e-4", "--window_size", "3",
        "--fno3d_width", "4", "--fno3d_modes", "3", "--fno3d_modes3", "2",
        "--fno3d_depth", "2", "--fno3d_out_frames", "5"]
    state = train.main(argv)
    saved = json.loads((run / "fno3d.json").read_text())
    assert saved == dict(width=4, modes1=3, modes2=3, modes3=2, depth=2,
                         in_frames=3, out_frames=5, time_pad=6,
                         projection=128, num_residues=28,
                         spectral_impl="auto")
    assert json.loads((run / "config.json").read_text())["data"][
        "window_size"] == 3
    lines = [json.loads(s) for s in
             (run / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 1 and np.isfinite(lines[0]["avg_train_loss"])
    assert np.isfinite(lines[0]["avg_valid_loss"])
    assert (run / "best.npz").exists() and (run / "last.npz").exists()
    restored, meta = restore_checkpoint(run / "last.npz", state)
    assert meta["epoch"] == 0
    assert {k: v.shape for k, v in leaves(restored.params)} == {
        k: v.shape for k, v in leaves(fno3d_init(cfg_of(
            num_residues=28, time_pad=6, projection=128)))}
    train.main(argv[:argv.index("--epochs")] + [
        "--epochs", "2", "--resume", str(run / "last.npz")]
        + argv[argv.index("--epochs") + 2:])
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(s)["epoch"] for s in lines] == [0, 1]
