"""Fourier Neural Operator on C-alpha distance matrices
(``molecular_dynamics_neural_operator_tpu/models/fno.py``).

The second operator family: the state is the (R, R) matrix of pairwise
distances; a window of them forms the input channels and the operator
predicts the next matrix. The FNO-2d layout: a pointwise lift, ``depth``
blocks of a spectral convolution on the lowest modes1 x modes2 modes
plus a pointwise bypass under a GELU (the tanh form, as ``jax.nn.gelu``
defaults to), and a two-layer projection head. The complex spectral
weights are stored as ``w_real`` and ``w_imag`` leaves, so checkpoints
keep the JAX package's keys.

The spectral convolution has two forms that compute the same function:
``"fft"`` (``torch.fft``) and ``"dft"`` (the truncated transforms as
small complex matmuls); ``"auto"`` takes ``"dft"`` for grids up to 128.
The FFT form writes the conjugate-side rows with conj(w), so the
spectrum it inverts is not Hermitian along its DC column. Its inverse is
written out as what the JAX package's ``irfft2`` computes on the CPU: an
inverse FFT over the rows, the real part of the DC and Nyquist columns,
then a real inverse FFT over the columns. cuFFT leaves a two-axis C2R of
a non-Hermitian spectrum undefined, so the port does not hand it one, on
any device.

Everything takes leading batch axes; ``fno_rollout_scan``'s ``lax.scan``
is a Python loop. The train, eval and curriculum steps have the GKN
steps' form: (state, batch) -> (state, metrics) with 0-d tensors that
stay on the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from molecular_dynamics_neural_operator_tpu_torch.configs import FNOConfig
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import (
    linear_apply,
    linear_init,
)

SPECTRAL_IMPLS = ("auto", "dft", "fft")


class FNOBatch(NamedTuple):
    """x: (B, R, R, C_in) input channels (a window of distance matrices);
    y: (B, R, R, C_out) the target (the next distance matrix)."""

    x: torch.Tensor
    y: torch.Tensor


def _spectral_init(gen: torch.Generator, width: int, modes1: int,
                   modes2: int, device=None):
    scale = 1.0 / (width * width)
    shape = (width, width, modes1, modes2)
    return {"w_real": (scale * torch.randn(shape, generator=gen)).to(device),
            "w_imag": (scale * torch.randn(shape, generator=gen)).to(device)}


def fno_init(cfg: FNOConfig, seed: int = 0, device=None):
    """Random parameters with the JAX package's structure and shapes (the
    values differ: a torch generator is not JAX's PRNG). Raises
    ``ValueError`` for retained modes past the grid's spectrum and for the
    extrapolating prior with one input channel."""
    half = cfg.num_residues // 2 + 1
    if cfg.modes1 > cfg.num_residues or cfg.modes2 > half:
        raise ValueError(
            f"FNO retained modes ({cfg.modes1}, {cfg.modes2}) exceed the "
            f"{cfg.num_residues}-point grid's spectrum "
            f"({cfg.num_residues} rows x {half} rfft columns); shrink "
            "modes1/modes2 for this num_residues")
    if (cfg.predict_delta and cfg.predict_prior == "extrapolate"
            and cfg.in_channels < 2):
        raise ValueError(
            "predict_prior='extrapolate' needs in_channels >= 2 (two "
            f"distance-matrix frames), got in_channels={cfg.in_channels}")
    gen = torch.Generator().manual_seed(seed)
    params = {
        "lift": linear_init(gen, cfg.in_channels, cfg.width, device),
        "proj1": linear_init(gen, cfg.width, 128, device),
        "proj2": linear_init(gen, 128, cfg.out_channels, device),
    }
    for d in range(cfg.depth):
        params[f"spectral_{d}"] = _spectral_init(gen, cfg.width, cfg.modes1,
                                                 cfg.modes2, device)
        params[f"pointwise_{d}"] = linear_init(gen, cfg.width, cfg.width,
                                               device)
    if cfg.head_init == "zero":
        # the first forecast is exactly the prior
        params["proj2"] = {k: torch.zeros_like(v)
                           for k, v in params["proj2"].items()}
    elif cfg.head_init != "default":
        raise ValueError(f"unknown head_init: {cfg.head_init!r}")
    return params


@functools.lru_cache(maxsize=8)
def _dft_mats(r1: int, r2: int, m1: int, m2: int):
    """Truncated DFT matrices of the matmul form, numpy complex64.

    F1 (2*m1, R1): the forward row transform at the retained row
    frequencies [0, m1) and [-m1, 0); F2 (m2, R2): the forward column
    transform at [0, m2); B1 (R1, 2*m1): the inverse row transform with
    its 1/R1; B2 (R2, m2): the inverse column transform with 1/R2 and the
    real FFT's doubling of every column but DC and, on an even grid, the
    Nyquist column, which are their own conjugate partners."""
    freqs1 = np.concatenate([np.arange(m1), np.arange(r1 - m1, r1)])
    n1 = np.arange(r1)
    f1 = np.exp(-2j * np.pi * freqs1[:, None] * n1[None, :] / r1)
    b1 = np.exp(+2j * np.pi * n1[:, None] * freqs1[None, :] / r1) / r1
    g2 = np.arange(m2)
    n2 = np.arange(r2)
    f2 = np.exp(-2j * np.pi * g2[:, None] * n2[None, :] / r2)
    scale = np.where((g2 > 0) & ~((r2 % 2 == 0) & (g2 == r2 // 2)),
                     2.0, 1.0)
    b2 = (np.exp(+2j * np.pi * n2[:, None] * g2[None, :] / r2)
          * scale[None, :] / r2)
    c64 = np.complex64
    return f1.astype(c64), f2.astype(c64), b1.astype(c64), b2.astype(c64)


@functools.lru_cache(maxsize=16)
def _cached_dft_tensors(r1: int, r2: int, m1: int, m2: int,
                        device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _dft_mats(r1, r2, m1, m2))


def _dft_tensors(r1: int, r2: int, m1: int, m2: int, device: torch.device):
    """``_dft_mats`` as tensors on ``device``, made once per shape in
    eager calls. Under ``torch.export`` or ``torch.compile`` they are
    made anew from the cached numpy arrays: a tensor made while a trace
    runs is the trace's (a FakeTensor), and a cache that kept it would
    hand it to every later eager call."""
    if torch.compiler.is_compiling():
        return tuple(torch.as_tensor(a, device=device)
                     for a in _dft_mats(r1, r2, m1, m2))
    return _cached_dft_tensors(r1, r2, m1, m2, device)


def _mix(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-mode channel mixing: xf (..., X, Y, i) with w (i, o, X, Y)."""
    return torch.einsum("...xyi,ioxy->...xyo", xf, w)


def _irfft2(out_f: torch.Tensor, r2: int) -> torch.Tensor:
    """The inverse of a (..., R1, R2//2 + 1, w) half spectrum over axes -3
    and -2, as the JAX package's ``irfft2`` computes it on the CPU for a
    spectrum that need not be Hermitian: an inverse FFT over the rows,
    the imaginary part of the DC column (and, for even R2, the Nyquist
    column) dropped, a real inverse FFT over the columns."""
    z = torch.fft.ifft(out_f, dim=-3)
    keep = torch.ones(z.shape[-2], 1, dtype=z.real.dtype, device=z.device)
    keep[0] = 0.0
    if r2 % 2 == 0:
        keep[r2 // 2] = 0.0
    z = torch.complex(z.real, z.imag * keep)
    return torch.fft.irfft(z, n=r2, dim=-2)


def _spectral_conv(sp_params, x: torch.Tensor, modes1: int, modes2: int,
                   impl: str = "auto") -> torch.Tensor:
    """x (..., R1, R2, width) -> the same shape: the lowest Fourier modes
    multiplied by per-mode (width, width) complex matrices, the rest
    dropped.

    When the retained row blocks overlap (2*modes1 > R1) or modes2 passes
    the half spectrum, the FFT form's second write overwrites the overlap
    while the DFT form would sum it: such modes run on "fft" only, "auto"
    never takes "dft" for them, and "dft" raises ``ValueError``."""
    r1, r2 = x.shape[-3], x.shape[-2]
    w = torch.complex(sp_params["w_real"], sp_params["w_imag"])
    m1, m2 = modes1, modes2
    overlapping = 2 * m1 > r1 or m2 > r2 // 2 + 1
    if impl not in SPECTRAL_IMPLS:
        raise ValueError(f"unknown spectral impl: {impl!r}")
    if impl == "auto":
        impl = "dft" if max(r1, r2) <= 128 and not overlapping else "fft"
    if impl == "dft" and overlapping:
        raise ValueError(
            f"spectral_impl='dft' requires 2*modes1 <= {r1} and modes2 <= "
            f"{r2 // 2 + 1} (got modes=({m1}, {m2})); use 'fft' or fewer "
            "modes")

    if impl == "dft":
        f1, f2, b1, b2 = _dft_tensors(r1, r2, m1, m2, x.device)
        xc = x.to(torch.complex64)
        # rows then columns: (..., 2*m1, m2, width), the [lo ; hi] blocks
        xf = torch.einsum("fr,...rcw->...fcw", f1, xc)
        xf = torch.einsum("gc,...fcw->...fgw", f2, xf)
        y = torch.cat([_mix(xf[..., :m1, :, :], w),
                       _mix(xf[..., m1:, :, :], w.conj())], dim=-3)
        z = torch.einsum("rf,...fgw->...rgw", b1, y)
        return torch.einsum("cg,...rgw->...rcw", b2, z).real

    xf = torch.fft.rfft2(x, dim=(-3, -2))       # (..., R1, R2//2+1, width)
    out_f = torch.zeros_like(xf)
    out_f[..., :m1, :m2, :] = _mix(xf[..., :m1, :m2, :], w)
    out_f[..., -m1:, :m2, :] = _mix(xf[..., -m1:, :m2, :], w.conj())
    return _irfft2(out_f, r2)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def fno_apply(params, cfg: FNOConfig, x: torch.Tensor,
              return_latent: bool = False):
    """x (..., R, R, C_in) -> (..., R, R, C_out) [, the (..., R, R, width)
    latent]. Under ``predict_delta`` the head's output, times
    ``head_scale``, corrects a prior: the last input channel ("last") or
    its damped extrapolation from the last two ("extrapolate")."""
    h = linear_apply(params["lift"], x)
    for d in range(cfg.depth):
        s = _spectral_conv(params[f"spectral_{d}"], h, cfg.modes1,
                           cfg.modes2, impl=cfg.spectral_impl)
        h = _gelu(s + linear_apply(params[f"pointwise_{d}"], h))
    latent = h
    out = linear_apply(params["proj2"],
                       _gelu(linear_apply(params["proj1"], h)))
    if cfg.predict_delta:
        out = out * float(cfg.head_scale)
        if cfg.predict_prior == "last":
            out = out + x[..., -1:]
        elif cfg.predict_prior == "extrapolate":
            if x.shape[-1] < 2:
                raise ValueError(
                    "predict_prior='extrapolate' needs >= 2 input "
                    f"channels, got x with {x.shape[-1]}")
            out = (out + x[..., -1:]
                   + cfg.prior_damping * (x[..., -1:] - x[..., -2:-1]))
        else:
            raise ValueError(f"unknown predict_prior: {cfg.predict_prior!r}")
    if return_latent:
        return out, latent
    return out


def distance_matrix_channels(positions: torch.Tensor) -> torch.Tensor:
    """(..., T, R, 3) coordinate windows -> (..., R, R, T) distance
    matrices as channels."""
    diff = positions[..., :, :, None, :] - positions[..., :, None, :, :]
    d = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
    return torch.movedim(d, -3, -1)


def sym_zero_diag(p: torch.Tensor) -> torch.Tensor:
    """A (..., R, R) prediction projected onto distance matrices
    (symmetric, zero diagonal): the stabilisation of every fed-back
    matrix, in the rollout and in the curriculum."""
    p = 0.5 * (p + p.transpose(-1, -2))
    r = p.shape[-1]
    return p * (1.0 - torch.eye(r, dtype=p.dtype, device=p.device))


def fno_rollout_step(params, cfg: FNOConfig,
                     channels: torch.Tensor) -> torch.Tensor:
    """One rollout step on channels (..., R, R, C): the next matrix,
    projected onto distance matrices, slid in as the last channel."""
    p = sym_zero_diag(fno_apply(params, cfg, channels)[..., 0])
    return torch.cat([channels[..., 1:], p[..., None]], dim=-1)


def fno_rollout_scan(params, cfg: FNOConfig, channels0: torch.Tensor,
                     num_steps: int):
    """Autoregressive distance-matrix rollout from channels0
    (..., R, R, C): predict the next matrix, project it, slide the
    window. Returns (predictions (..., num_steps, R, R), final
    channels)."""
    channels, preds = channels0, []
    for _ in range(num_steps):
        channels = fno_rollout_step(params, cfg, channels)
        preds.append(channels[..., -1])
    if not preds:
        return channels0.new_zeros(channels0.shape[:-3] + (0,)
                                   + channels0.shape[-3:-1]), channels
    return torch.stack(preds, dim=channels0.dim() - 3), channels


def window_batch_to_fno(batch: dict) -> FNOBatch:
    """A coordinate window batch as distance channels, on the batch's
    device: window (B, T, R, 3) -> x (B, R, R, T); y (B, R, 3) ->
    (B, R, R, 1)."""
    return FNOBatch(x=distance_matrix_channels(batch["window"]),
                    y=distance_matrix_channels(batch["y"][:, None]))


def _teacher_loss(params, cfg: FNOConfig, fb: FNOBatch):
    from molecular_dynamics_neural_operator_tpu_torch.models.losses import (
        lp_rel,
        mse,
    )

    out = fno_apply(params, cfg, fb.x)
    b = out.shape[0]
    return lp_rel(out.reshape(b, -1), fb.y.reshape(b, -1),
                  size_average=False), mse(out, fb.y)


def _train_step(loss_fn, tx):
    """(state, batch) -> (state, {"rel_l2", "mse"}) for a loss_fn(params,
    batch) -> (rel_l2, mse)."""
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        value_and_grad,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        apply_update,
    )

    def step(state, batch):
        (l2, m), grads = value_and_grad(loss_fn, state.params, batch)
        return apply_update(state, grads, tx), {"rel_l2": l2, "mse": m}

    return step


def fno_window_loss(cfg: FNOConfig):
    """loss_fn(params, window batch) -> (batch-sum rel_l2, mse) of the
    teacher-forced step, distance matrices made on the device."""
    return lambda params, batch: _teacher_loss(params, cfg,
                                               window_batch_to_fno(batch))


def make_fno_window_train_step(cfg: FNOConfig, tx):
    """Train step on coordinate window batches, featurised to distance
    matrices on the device inside the step."""
    return _train_step(fno_window_loss(cfg), tx)


def make_fno_window_eval_step(cfg: FNOConfig):
    """(params, window batch) -> {"rel_l2", "mse"}, no gradient."""

    @torch.no_grad()
    def step(params, batch: dict):
        l2, m = _teacher_loss(params, cfg, window_batch_to_fno(batch))
        return {"rel_l2": l2, "mse": m}

    return step


def make_fno_train_step(cfg: FNOConfig, tx):
    """Train step on ``FNOBatch``es of distance channels."""
    return _train_step(
        lambda params, fb: _teacher_loss(params, cfg, fb), tx)


def make_fno_curriculum_train_step(cfg: FNOConfig, tx, rollout_steps: int,
                                   step_weights=None):
    """Train step of ``fno_curriculum_loss``."""
    return _train_step(fno_curriculum_loss(cfg, rollout_steps, step_weights),
                       tx)


def fno_curriculum_loss(cfg: FNOConfig, rollout_steps: int,
                        step_weights=None):
    """The K-step rollout curriculum on distance matrices: step 1 predicts
    from the true window, steps 2..K from the model's own predictions,
    each projected by ``sym_zero_diag`` before it is fed back (the loss
    reads the raw prediction, so K = 1 is the teacher-forced step). The
    batch carries ``y_seq`` (B, K, R, 3) coordinates
    (``batch_iterator(..., rollout_horizon=K)``); a batch with another K
    raises ``ValueError``. The loss is the weighted sum of per-step
    relative L2 errors (weights normalised to sum 1), the MSE averaged
    over the K steps."""

    def rel(pred, truth):
        num = torch.sqrt(torch.sum((pred - truth) ** 2, dim=(1, 2)))
        return num / torch.sqrt(torch.sum(truth ** 2, dim=(1, 2)))

    def loss_fn(params, batch: dict):
        channels = distance_matrix_channels(batch["window"])
        y_seq = batch["y_seq"]
        k = y_seq.shape[1]
        if k != rollout_steps:
            raise ValueError(
                f"batch carries y_seq with K={k} but the step was built "
                f"for rollout_steps={rollout_steps} (assemble batches "
                "with rollout_horizon=rollout_steps)")
        dm_seq = torch.movedim(distance_matrix_channels(y_seq), -1, 1)
        weights = (torch.ones(k) if step_weights is None
                   else torch.as_tensor(step_weights, dtype=torch.float32))
        weights = (weights / weights.sum()).to(channels.device)
        loss_vec, sq = 0.0, 0.0
        for t in range(k):
            p = fno_apply(params, cfg, channels)[..., 0]
            loss_vec = loss_vec + weights[t] * rel(p, dm_seq[:, t])
            sq = sq + torch.sum((p - dm_seq[:, t]) ** 2, dim=(1, 2))
            if t + 1 < k:
                channels = torch.cat(
                    [channels[..., 1:], sym_zero_diag(p)[..., None]], dim=-1)
        r = dm_seq.shape[-1]
        return torch.sum(loss_vec), torch.mean(sq / (k * r * r))

    return loss_fn
