"""FNO-2d's K-step rollout curriculum on distance matrices, held against
the benchmark's plain reference (``portbench/reference/fno.py``), which
computes the spectral convolution by full complex FFTs of the grid
rather than by either of the program's forms; the step's spans and
counters (``utils/profiling.py``); and the FNO's operation count
(``portbench/counts/fno.py``) against torch's FLOP counter.

Seeded random weights (``portbench/weights_fno.py``: linear layers
uniform +-1/sqrt(fan in), spectral weights N(0, 1)/width^2) at width 8,
4 modes an axis, depth 2; windows of the benchmark's synthetic chain at
R = 20; B = 4, K = 3; f32. This file imports no JAX."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from molecular_dynamics_neural_operator_tpu_torch.configs import FNOConfig
from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
    _spectral_conv,
    distance_matrix_channels,
    fno_apply,
    fno_curriculum_loss,
    make_fno_curriculum_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    TrainState,
    make_optimizer,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    value_and_grad,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling
from portbench import weights_fno
from portbench.counts import fno as counts
from portbench.reference import fno as ref
from portbench.reference.train import leaves
from portbench.traffic import sources

R, T, B, K = 20, 10, 4, 3
LR, WD, CLIP_NORM = 1e-3, 1e-4, 1.0
MODEL = dict(width=8, modes1=4, modes2=4, depth=2, in_channels=T,
             out_channels=1, num_residues=R, compute_dtype="float32",
             predict_delta=True, predict_prior="last", head_scale=0.05)

# the model's correction (its output less the prior) in f32 against f32,
# the transforms taken another way: they agree to some 3e-8 of its norm,
# so 1e-5; TF32 operands move it by 8e-4
OUT_RTOL = 1e-5
# the K-step loss, summed in other orders: some 1e-7 of itself, so 1e-5
# (TF32 operands move it by 1.1e-6: the loss alone does not see them)
LOSS_RTOL = 1e-5
# a gradient leaf's difference over the larger of its norm and the median
# leaf's: some 4e-7 in f32, so 1e-4; TF32 operands move it by 5e-4 to 7e-4
GRAD_RTOL = 1e-4
# the weights after one Adam step from the same start: each element moves
# by about the learning rate (m / sqrt(v) is +-1 at step 1); f32 keeps the
# two within 1e-4 of it, so 2e-3 of it; TF32 operands move them by 0.1
MOVE_ATOL = 2e-3 * LR


def cfg_of(impl: str = "auto") -> FNOConfig:
    names = FNOConfig.__dataclass_fields__
    return FNOConfig(**{k: v for k, v in MODEL.items() if k in names},
                     spectral_impl=impl)


def params_of(seed: int) -> dict:
    return weights_fno.make(MODEL, seed, "cpu")


def batch_of(seed: int, k: int = K) -> dict:
    """B windows of the chain (B, T, R, 3) with their k-step
    continuations (B, k, R, 3)."""
    frames, _ = sources.chain_trajectory(200, R, 13)
    idx = np.random.default_rng(seed).choice(200 - T - k, B, replace=False)
    window = torch.as_tensor(np.stack([frames[f:f + T] for f in idx]))
    y_seq = torch.as_tensor(np.stack([frames[f + T:f + T + k] for f in idx]))
    return {"window": window, "y": y_seq[:, 0], "y_seq": y_seq}


def gaps(seed: int, rounding=None) -> dict:
    """The program (f32), or the reference with product operands in
    ``rounding`` in its place, against the f32 reference: the loss, every
    gradient leaf and the weights after one Adam step (gradient clip, L2
    decay)."""
    params, batch = params_of(seed), batch_of(seed)
    want_loss, want_grads = ref.loss_and_grads(params, MODEL, batch,
                                               chunk=3)
    want = ref.train(params, MODEL, [batch], LR, WD, CLIP_NORM, chunk=3)
    if rounding is None:
        loss_fn = fno_curriculum_loss(cfg_of(), K)
        (loss, _), g = value_and_grad(loss_fn, params, batch)
        loss, grads = float(loss), dict(leaves(g))
        tx, _ = make_optimizer(lr=LR, weight_decay=WD,
                               grad_clip_norm=CLIP_NORM,
                               skip_nonfinite_updates=True)
        step = make_fno_curriculum_train_step(cfg_of(), tx, K)
        new, _ = step(TrainState(params, tx.init(params), 0, 0), batch)
        moved = dict(leaves(new.params))
        mu1 = dict(leaves(new.opt_state.mu))
    else:
        loss, grads = ref.loss_and_grads(params, MODEL, batch, rounding,
                                         chunk=3)
        low = ref.train(params, MODEL, [batch], LR, WD, CLIP_NORM, rounding,
                        chunk=3)
        moved = low["params"]
        p0 = dict(leaves(params))
        mu1 = {k: 0.1 * (g + WD * p0[k]) for k, g in low["grad1"].items()}
    norms = {k: float(v.norm()) for k, v in want_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    p0 = dict(leaves(params))
    want_mu1 = {k: 0.1 * (g + WD * p0[k]) for k, g in want["grad1"].items()}
    return {
        "loss": abs(loss - want_loss) / abs(want_loss),
        "grad": max(float((grads[k] - g).norm()) / max(norms[k], median)
                    for k, g in want_grads.items()),
        "mu1": max(float((mu1[k] - m).norm())
                   / max(float(want_mu1[k].norm()), 0.1 * median)
                   for k, m in want_mu1.items()),
        "move": max(float((moved[k] - p).abs().max())
                    for k, p in want["params"].items()),
        "leaves": set(grads) == set(want_grads) == set(moved),
    }


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("impl", ["dft", "fft"])
def test_fno_apply_matches_the_reference(impl, seed):
    """One model step of both spectral forms against the reference's full
    complex transforms, by the correction the head adds to the prior."""
    params, batch = params_of(seed), batch_of(seed)
    x = distance_matrix_channels(batch["window"])
    got = fno_apply(params, cfg_of(impl), x)[..., 0]
    want = ref.model_step(params, MODEL, x, ref.rounding_fn())
    prior = x[..., -1]
    assert float((got - want).norm()) <= OUT_RTOL * float(
        (want - prior).norm())


@pytest.mark.parametrize("seed", [1, 2])
def test_fno_curriculum_matches_the_reference(seed):
    """The K-step loss, every gradient leaf, the first Adam moment and the
    weights after one curriculum train step against the reference's."""
    g = gaps(seed)
    assert g["leaves"]
    assert g["loss"] <= LOSS_RTOL, g
    assert g["grad"] <= GRAD_RTOL, g
    assert g["mu1"] <= GRAD_RTOL, g
    assert g["move"] <= MOVE_ATOL, g


def test_the_comparison_fails_tf32_operands():
    """The reference with every product's operands rounded to TF32's
    10-bit mantissa, in the program's place, fails the tolerances the
    program meets."""
    g = gaps(1, "tf32")
    assert (g["loss"] > LOSS_RTOL or g["grad"] > GRAD_RTOL
            or g["move"] > MOVE_ATOL), g
    params, batch = params_of(1), batch_of(1)
    x = distance_matrix_channels(batch["window"])
    want = ref.model_step(params, MODEL, x, ref.rounding_fn())
    low = ref.model_step(params, MODEL, x, ref.rounding_fn("tf32"))
    assert float((low - want).norm()) > 10 * OUT_RTOL * float(
        (want - x[..., -1]).norm())


def _counted(step, state, batch, n: int) -> dict:
    before = profiling.counters()
    for _ in range(n):
        state, _ = step(state, batch)
    after = profiling.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("impl", ["auto", "fft"])
def test_the_fno_curriculum_counters(impl):
    """Each step call counts one optimizer step, K model steps, all
    supervised, B * R^2 grid points a model step, and each spectral
    convolution of the forward passes under its form (``"auto"`` takes
    the DFT at R = 20); host integers, read around the calls."""
    params = params_of(3)
    tx, _ = make_optimizer(lr=LR, weight_decay=WD)
    step = make_fno_curriculum_train_step(cfg_of(impl), tx, K)
    got = _counted(step, TrainState(params, tx.init(params), 0, 0),
                   batch_of(3), 2)
    form = "dft" if impl == "auto" else "fft"
    assert got == {"curriculum_steps": 2, "curriculum_unrolled": 2 * K,
                   "curriculum_supervised": 2 * K,
                   "fno_points": 2 * K * B * R * R,
                   f"fno_spectral_{form}": 2 * K * MODEL["depth"]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step as a CUDA graph")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_graphed_k4_fno_step_counts_its_replays(cuda):
    """On the card the step replays a CUDA graph: its first loss is the
    eager step's, and each replay counts what its capture held, depth
    spectral convolutions (the DFT at R = 20) for each of the K = 4
    model steps."""
    params = weights_fno.make(MODEL, 6, cuda)
    batch = {k: v.to(cuda) for k, v in batch_of(6, 4).items()}
    tx, _ = make_optimizer(lr=LR, weight_decay=WD, grad_clip_norm=CLIP_NORM,
                           skip_nonfinite_updates=True)
    step = make_fno_curriculum_train_step(cfg_of(), tx, 4)
    state = TrainState(params, tx.init(params), 0, 0)
    _, eager = step.eager(state, batch)
    state, graphed = step(state, batch)
    assert step.graphed.graphs
    torch.testing.assert_close(graphed["rel_l2"], eager["rel_l2"],
                               rtol=1e-5, atol=0.0)
    got = _counted(step, state, batch, 3)
    assert got == {"curriculum_steps": 3, "curriculum_unrolled": 12,
                   "curriculum_supervised": 12,
                   "fno_points": 12 * B * R * R,
                   "fno_spectral_dft": 12 * MODEL["depth"]}


def test_the_fno_curriculum_span():
    """``train.curriculum`` around each step call, eager or not, recorded
    only under ``tracing()``."""
    params, batch = params_of(4), batch_of(4)
    tx, _ = make_optimizer(lr=LR, weight_decay=WD)
    step = make_fno_curriculum_train_step(cfg_of(), tx, K)
    state = TrainState(params, tx.init(params), 0, 0)
    state, _ = step(state, batch)              # outside tracing()
    with profiling.tracing() as spans:
        state, _ = step(state, batch)
        step.eager(state, batch)
    assert [s.name for s in spans] == ["train.curriculum"] * 2
    assert profiling.span("train.curriculum") is profiling.span("x")


def test_the_count_against_torchs_flop_counter():
    """``counts/fno.py`` against ``FlopCounterMode`` over the DFT form:
    torch counts 2 FLOPs a multiply-add whatever the dtype, the count 8
    for a complex one, so the count is torch's plus 3x torch's count of
    the complex products (the spectral convolutions alone)."""
    params, batch = params_of(5), batch_of(5)
    x = distance_matrix_channels(batch["window"])
    with FlopCounterMode(display=False) as whole:
        fno_apply(params, cfg_of("dft"), x)
    h = torch.randn(B, R, R, MODEL["width"])
    with FlopCounterMode(display=False) as spectral:
        _spectral_conv(params["spectral_0"], h, MODEL["modes1"],
                       MODEL["modes2"], "dft")
    complex_torch = MODEL["depth"] * spectral.get_total_flops()
    assert counts.step_flops(MODEL, B, R) == (whole.get_total_flops()
                                              + 3 * complex_torch)
    assert counts.step_parts(MODEL, B, R)["spectral"] == 4 * complex_torch
    assert counts.curriculum_flops(MODEL, B, R, 4, 3) == 10 * (
        counts.step_flops(MODEL, B, R))
