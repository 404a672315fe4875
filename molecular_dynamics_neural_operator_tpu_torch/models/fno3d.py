"""FNO-3d on C-alpha distance matrices: the space-time Fourier Neural
Operator of Li et al. ("Fourier Neural Operator for Parametric Partial
Differential Equations", ICLR 2021, arXiv:2010.08895, section 5.3 and
its ``fourier_3d.py``), which maps ``in_frames`` distance matrices to the
next ``out_frames`` in one call. The JAX package has no counterpart.

The layout of ``fourier_3d.py``'s ``FNO3d``, at its sizes by default
(``configs.FNO3dConfig``: modes 8 on each axis, width 20, 4 Fourier
layers, time padding 6, projection 128; 6,558,377 parameters):

1. the lift ``fc0`` at every point (i, j, t) of the (R, R, T) grid, of the
   in_frames input matrices (the same at every t) and the grid
   coordinates (i, j, t), each ``linspace(0, 1)`` over its axis; then
   ``time_pad`` zeros after the time axis, which is not periodic;
2. ``depth`` layers h' = gelu(spectral(h) + h @ w + b), without the GELU
   after the last; the spectral convolution keeps the modes k1 in
   [0, m1) and [R - m1, R), k2 likewise and k3 in [0, m3) of h's
   three-dimensional real Fourier transform and mixes each mode's width
   channels by a complex (width, width) matrix, one independent weight
   for each of the four (k1, k2) corners;
3. the padding cropped, then the projection width -> 128 -> 1 with a
   GELU between (the exact erf form, as ``F.gelu`` is in the paper).

Inside, the grid is held channels-first, (B, width, R, R, T + pad), so
that the time transforms, which touch the whole grid, are products over
its contiguous axis. The lift is computed as the paper's linear layer
split in two, the frames' part at each (i, j) and the grid's part at
each (i, j, t), added in one pass that also writes the padding.

The spectral convolution has two forms that compute the same function.
``"dft"``: the truncated transforms as products, time first (a real
product with the cosines and sines of the m3 kept frequencies), then the
two residue axes (complex products with the 2 * m kept frequencies),
the mixing, and back the other way, the last a real product that adds
the pointwise layer's output (``addmm``). ``"fft"``: ``torch.fft``, a
real transform over time cut to its m3 kept bins, a complex transform
over the residue axes, the mixing into a zero spectrum, and the inverse
written out. ``"auto"`` takes ``"dft"`` on grids up to 128 points an
axis.

With four independent corner weights the spectrum's k3 = 0 plane is not
Hermitian, and cuFFT leaves a multi-axis complex-to-real inverse of such
a spectrum undefined. Both forms therefore compute the inverse as the
CPU's ``irfftn`` does: a complex inverse over the two residue axes, the
imaginary part of the time axis's DC bin (and Nyquist bin) dropped, then
a real inverse over time. The DFT form's real inverse product drops it
by construction (the DC and Nyquist basis vectors are real).

Departures from ``fourier_3d.py``: the four ``BatchNorm3d`` layers the
paper's module builds and never calls are left out (160 parameters); the
input is a window of distance matrices and the output the next
``out_frames`` matrices, where the paper maps vorticity; there are no
unit-Gaussian normalisers.

The train step (``make_fno3d_train_step``) takes a batch of coordinate
windows (B, in_frames, R, 3) with their continuations ``y_seq``
(B, out_frames, R, 3) (``batch_iterator(..., rollout_horizon=
out_frames)``), makes the distance matrices on the device, and trains
the relative L2 error of each example's whole block, summed over the
batch, with the MSE beside it. On the card it is a CUDA graph
(``train/graphed.py``) named ``FNO3d train step``.

Spans and counters (``utils/profiling.py``): the step opens
``train.fno3d`` around each call and counts ``fno3d_steps``,
``fno3d_points`` (B * R^2 * (T + pad), the grid its model call
covers) and ``fno3d_frames`` (B * T forecast frames); each spectral
convolution adds 1 to ``fno3d_spectral_dft`` or ``fno3d_spectral_fft``
by the form it took.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from molecular_dynamics_neural_operator_tpu_torch.configs import FNO3dConfig
from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
    SPECTRAL_IMPLS,
    _dft_mats,
    distance_matrix_channels,
)
from molecular_dynamics_neural_operator_tpu_torch.models.losses import lp_rel
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import (
    linear_apply,
    linear_init,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import (
    count,
    span,
)

GRID_CHANNELS = 3   # the coordinates (i, j, t) beside the input frames
CORNERS = 4         # (k1, k2) low/low, high/low, low/high, high/high


def check_modes(r1: int, r2: int, z: int, m1: int, m2: int, m3: int):
    """Raise ``ValueError`` where the kept corners would overlap on a
    (r1, r2, z) grid: 2 * m1 > r1, 2 * m2 > r2 or m3 > z // 2 + 1."""
    if 2 * m1 > r1 or 2 * m2 > r2 or m3 > z // 2 + 1:
        raise ValueError(
            f"FNO-3d modes ({m1}, {m2}, {m3}) overlap on the ({r1}, {r2}, "
            f"{z}) grid: they need 2*modes1 <= {r1}, 2*modes2 <= {r2} and "
            f"modes3 <= {z // 2 + 1}")


def fno3d_init(cfg: FNO3dConfig, seed: int = 0, device=None):
    """Random parameters drawn as ``fourier_3d.py`` draws them: each
    linear layer (and the pointwise layer, a 1x1x1 convolution there)
    uniform in +-1/sqrt(fan in); the spectral weights' real and
    imaginary parts 1/width^2 * U[0, 1). Raises ``ValueError`` for
    modes that overlap on the configured grid."""
    check_modes(cfg.num_residues, cfg.num_residues,
                cfg.out_frames + cfg.time_pad, cfg.modes1, cfg.modes2,
                cfg.modes3)
    gen = torch.Generator().manual_seed(seed)
    w = cfg.width
    params = {"lift": linear_init(gen, cfg.in_frames + GRID_CHANNELS, w,
                                  device)}
    shape = (CORNERS, w, w, cfg.modes1, cfg.modes2, cfg.modes3)
    scale = 1.0 / (w * w)
    for d in range(cfg.depth):
        params[f"spectral_{d}"] = {
            part: (scale * torch.rand(shape, generator=gen)).to(device)
            for part in ("w_real", "w_imag")}
        params[f"pointwise_{d}"] = linear_init(gen, w, w, device)
    params["proj1"] = linear_init(gen, w, cfg.projection, device)
    params["proj2"] = linear_init(gen, cfg.projection, 1, device)
    return params


@functools.lru_cache(maxsize=8)
def _dft3_mats(r1: int, r2: int, z: int, m1: int, m2: int, m3: int):
    """The DFT form's matrices, numpy: ``fz`` (z, 2*m3) f32, the forward
    time transform at the kept bins with each bin's real and imaginary
    parts in adjacent columns; ``fx`` (2*m1, r1), ``fy`` (2*m2, r2),
    ``bx`` (r1, 2*m1), ``by`` (r2, 2*m2) complex64, the residue axes'
    forward and inverse transforms at the kept frequencies
    (``models/fno.py::_dft_mats``); ``bz`` (2*m3, z) f32, the real
    inverse over time with its 1/z and the doubling of every bin but DC
    and Nyquist: out[t] = sum_k Re(c_k) bz[2k, t] + Im(c_k) bz[2k+1, t]."""
    fx, fz_c, bx, bz_c = _dft_mats(r1, z, m1, m3)
    fy, _, by, _ = _dft_mats(r2, z, m2, m3)
    fz = np.stack([fz_c.real.T, fz_c.imag.T], axis=-1).reshape(z, 2 * m3)
    bz = np.stack([bz_c.real.T, -bz_c.imag.T], axis=1).reshape(2 * m3, z)
    f32 = np.float32
    return fz.astype(f32), fx, fy, bx, by, bz.astype(f32)


@functools.lru_cache(maxsize=None)
def _dft3_tensors(shape: tuple, device: torch.device):
    """``_dft3_mats`` as tensors on ``device``, made once a shape."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _dft3_mats(*shape))


def _corner_weights(sp_params) -> torch.Tensor:
    """The four corners' weights (4, i, o, m1, m2, m3) as one complex
    block (i, o, 2*m1, 2*m2, m3) in the DFT form's frequency order: k1
    low then high, k2 low then high."""
    w = torch.complex(sp_params["w_real"], sp_params["w_imag"])
    low1 = torch.cat([w[0], w[2]], dim=-2)
    high1 = torch.cat([w[1], w[3]], dim=-2)
    return torch.cat([low1, high1], dim=-3)


def _mix(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-mode channel mixing, channels-first: xf (b, i, X, Y, Z) with
    w (i, o, X, Y, Z)."""
    return torch.einsum("bixyz,ioxyz->boxyz", xf, w)


def _dft_inverse(z, bx, by, bz, bypass):
    """``bypass`` (b, c, X, Y, Z) plus the DFT form's inverse of the kept
    spectrum z (b, c, 2*m1, 2*m2, m3) onto that grid: complex products
    over the residue axes, then the real product over time, which drops
    each DC (and Nyquist) bin's imaginary part, adding into the bypass
    (``addmm``)."""
    z = torch.einsum("xf,bofgk->boxgk", bx, z)
    z = torch.einsum("yg,boxgk->boxyk", by, z)
    zr = torch.view_as_real(z).reshape(-1, bz.shape[0])
    return torch.addmm(bypass.reshape(-1, bz.shape[-1]), zr,
                       bz).view(bypass.shape)


def _spectral_dft(sp_params, h, modes, bypass):
    """Time first, as one real product of the (b c X Y, Z) rows; the
    residue axes as complex products of the smaller kept tensor, each
    ``einsum`` one product after a transpose of its operand. Batched over
    the leading axes instead (51,200 products of 16 x 80 by 80 x 8 at
    B = 32), the step took 95.0 against 89.3 ms on an H100."""
    m3 = modes[2]
    fz, fx, fy, bx, by, bz = _dft3_tensors(tuple(h.shape[-3:]) + modes,
                                           h.device)
    z = torch.view_as_complex((h @ fz).unflatten(-1, (m3, 2)))
    z = torch.einsum("gy,bcxyk->bcxgk", fy, z)
    z = torch.einsum("fx,bcxgk->bcfgk", fx, z)
    return _dft_inverse(_mix(z, _corner_weights(sp_params)), bx, by, bz,
                        bypass)


def _fft_inverse(z: torch.Tensor, z_len: int) -> torch.Tensor:
    """The inverse of the kept time bins z (..., X, Y, m3) of a real
    transform over the last three axes onto (..., X, Y, z_len), as the
    CPU's ``irfftn`` computes it for a spectrum that need not be
    Hermitian: a complex inverse over the residue axes, the imaginary
    part of the DC bin (and the Nyquist bin) dropped, a real inverse over
    time."""
    z = torch.fft.ifft2(z, dim=(-3, -2))
    bins = torch.arange(z.shape[-1], device=z.device)
    drop = bins == 0
    if z_len % 2 == 0:
        drop = drop | (bins == z_len // 2)
    z = torch.complex(z.real, torch.where(drop, 0.0, z.imag))
    return torch.fft.irfft(z, n=z_len, dim=-1)


def _spectral_fft(sp_params, h, modes, bypass):
    m1, m2, m3 = modes
    w = torch.complex(sp_params["w_real"], sp_params["w_imag"])
    xf = torch.fft.rfft(h, dim=-1)[..., :m3]
    xf = torch.fft.fft2(xf, dim=(-3, -2))
    out = torch.zeros_like(xf)
    for c, (sx, sy) in enumerate(((slice(None, m1), slice(None, m2)),
                                  (slice(-m1, None), slice(None, m2)),
                                  (slice(None, m1), slice(-m2, None)),
                                  (slice(-m1, None), slice(-m2, None)))):
        out[..., sx, sy, :] = _mix(xf[..., sx, sy, :], w[c])
    return _fft_inverse(out, h.shape[-1]) + bypass


def spectral_conv3d(sp_params, h: torch.Tensor, modes1: int, modes2: int,
                    modes3: int, impl: str,
                    bypass: torch.Tensor) -> torch.Tensor:
    """h (B, width, X, Y, Z) channels-first -> the same shape: the kept
    Fourier modes mixed by the four corners' complex (width, width)
    matrices, the rest dropped, plus ``bypass`` (the same shape, the
    pointwise layer's output). Raises ``ValueError`` for an unknown form
    and for modes that overlap on the grid (``check_modes``)."""
    if impl not in SPECTRAL_IMPLS:
        raise ValueError(f"unknown spectral impl: {impl!r}")
    x_len, y_len, z_len = h.shape[-3:]
    check_modes(x_len, y_len, z_len, modes1, modes2, modes3)
    if impl == "auto":
        impl = "dft" if max(x_len, y_len, z_len) <= 128 else "fft"
    count(f"fno3d_spectral_{impl}")
    form = _spectral_dft if impl == "dft" else _spectral_fft
    return form(sp_params, h, (modes1, modes2, modes3), bypass)


def _grid(r: int, t: int, device) -> torch.Tensor:
    """(r, r, t, 3): the coordinates (i, j, t), each linspace(0, 1)."""
    gi = torch.linspace(0.0, 1.0, r, device=device)
    gt = torch.linspace(0.0, 1.0, t, device=device)
    return torch.stack(torch.meshgrid(gi, gi, gt, indexing="ij"), dim=-1)


def _lift(params, cfg: FNO3dConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, R, R, in_frames) -> the lifted, padded grid (B, width, R, R,
    out_frames + time_pad): ``fc0`` of [the frames ; (i, j, t)] at every
    point, as the frames' part at each (i, j) plus the grid's part, the
    padding zero, in one pass (``addcmul`` with the frames' part masked
    off the padding)."""
    w, b = params["lift"]["w"], params["lift"]["b"]
    r, n, t = x.shape[-2], cfg.in_frames, cfg.out_frames
    frames = (x @ w[:n]).movedim(-1, 1)[..., None]         # (B, w, R, R, 1)
    grid = F.pad((_grid(r, t, x.device) @ w[n:] + b).movedim(-1, 0),
                 (0, cfg.time_pad))                         # (w, R, R, Z)
    inside = (torch.arange(t + cfg.time_pad, device=x.device) < t).to(
        x.dtype)
    return torch.addcmul(grid, frames, inside)


def _pointwise(layer, h: torch.Tensor) -> torch.Tensor:
    """The 1x1x1 convolution h @ w + b over channels-first h. As one
    product of the (b X Y Z, width) rows (``matmul`` folds the examples
    in), its weight's gradient is one product with the grid as its inner
    axis, which cuBLAS splits; batched over the examples it would sum
    each example's 294,400 points in one chain, slower and less exact."""
    b, c = h.shape[:2]
    out = torch.matmul(layer["w"].t(), h.reshape(b, c, -1))
    return (out + layer["b"][:, None]).reshape((b, -1) + h.shape[2:])


def fno3d_apply(params, cfg: FNO3dConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, R, R, in_frames) distance matrices -> (B, R, R, out_frames),
    the next ``out_frames`` matrices."""
    if x.shape[-1] != cfg.in_frames:
        raise ValueError(f"FNO-3d takes {cfg.in_frames} input frames, got "
                         f"x with {x.shape[-1]}")
    h = _lift(params, cfg, x)
    for d in range(cfg.depth):
        h = spectral_conv3d(params[f"spectral_{d}"], h, cfg.modes1,
                            cfg.modes2, cfg.modes3, cfg.spectral_impl,
                            _pointwise(params[f"pointwise_{d}"], h))
        if d + 1 < cfg.depth:
            h = F.gelu(h)
    h = h[..., :cfg.out_frames].movedim(1, -1)          # (B, R, R, T, w)
    out = linear_apply(params["proj2"],
                       F.gelu(linear_apply(params["proj1"], h)))
    return out[..., 0]


def fno3d_block_loss(cfg: FNO3dConfig):
    """loss_fn(params, batch) -> (the batch's sum of each example's
    relative L2 error over its whole block, the MSE): window (B,
    in_frames, R, 3) and y_seq (B, out_frames, R, 3) coordinates, made
    into distance matrices on the device. A batch with another number of
    frames raises ``ValueError``."""

    def loss_fn(params, batch: dict):
        y_seq = batch["y_seq"]
        if y_seq.shape[1] != cfg.out_frames:
            raise ValueError(
                f"batch carries y_seq with {y_seq.shape[1]} frames but the "
                f"step forecasts out_frames={cfg.out_frames} (assemble "
                f"batches with rollout_horizon={cfg.out_frames})")
        pred = fno3d_apply(params, cfg,
                           distance_matrix_channels(batch["window"]))
        truth = distance_matrix_channels(y_seq)
        return (lp_rel(pred, truth, size_average=False),
                torch.mean((pred - truth) ** 2))

    return loss_fn


def make_fno3d_train_step(cfg: FNO3dConfig, tx):
    """(state, batch) -> (state, {"rel_l2", "mse"}) of
    ``fno3d_block_loss``, traced and counted as the module docstring
    says; on the card a CUDA graph per batch shape. ``step.eager`` runs
    the body op by op, ``step.graphed`` is the ``GraphedStep``."""
    from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
        graphed_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        value_and_grad,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        apply_update,
    )

    loss_fn = fno3d_block_loss(cfg)

    def body(state, batch):
        (l2, m), grads = value_and_grad(loss_fn, state.params, batch)
        return apply_update(state, grads, tx), {"rel_l2": l2, "mse": m}

    inner = graphed_step(body, name="FNO3d train step")

    def counted(run):
        def step(state, batch: dict):
            with span("train.fno3d"):
                out = run(state, batch)
            b, r = batch["window"].shape[0], batch["window"].shape[-2]
            count("fno3d_steps")
            count("fno3d_points",
                  b * r * r * (cfg.out_frames + cfg.time_pad))
            count("fno3d_frames", b * cfg.out_frames)
            return out
        return step

    step = counted(inner)
    step.eager, step.graphed = counted(inner.eager), inner.graphed
    return step


def make_fno3d_eval_step(cfg: FNO3dConfig):
    """(params, batch) -> {"rel_l2", "mse"} of ``fno3d_block_loss``, no
    gradient."""
    loss_fn = fno3d_block_loss(cfg)

    @torch.no_grad()
    def step(params, batch: dict):
        l2, m = loss_fn(params, batch)
        return {"rel_l2": l2, "mse": m}

    return step
