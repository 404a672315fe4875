"""FNO-2d on C-alpha distance matrices under the K-step rollout
curriculum, in plain PyTorch: the benchmark's frozen reference for the
FNO's training cells (``entries/train_fno_curriculum.py``).

The model is Li et al.'s Fourier Neural Operator for 2-d problems
("Fourier Neural Operator for Parametric Partial Differential
Equations", ICLR 2021, arXiv:2010.08895, section 5 and its
``fourier_2d.py``), on a window of T distance matrices (R, R) as its T
input channels:

1. the lift, a linear layer T -> width at every grid point;
2. ``depth`` blocks h' = gelu(spectral(h) + h @ w + b), the spectral
   convolution keeping the row frequencies [0, m1) and [R - m1, R) and the
   column frequencies [0, m2) of h's two-dimensional Fourier transform,
   each mode's width channels mixed by a complex (width, width) matrix;
3. the projection width -> 128 -> 1 with a GELU between;
4. the next matrix: the last input channel plus ``head_scale`` times the
   projection (``predict_delta``, prior "last").

The spectral convolution is computed another way than the program's two
forms (truncated DFT matrices, or ``rfft2`` and a real inverse): the
complex-to-complex ``torch.fft.fft2`` of the whole grid; the kept blocks
times w and conj(w), placed in a full zero spectrum with the kept
columns 1 .. m2 - 1 doubled (the DC column, and on an even grid the
Nyquist column, are their own partners and are not); the real part of
the complex-to-complex ``torch.fft.ifft2`` of the whole grid. That real
part is the real inverse of the half spectrum whose DC column need not
be Hermitian, which is what the program computes.

The curriculum: step 1 predicts from the true window's distance
matrices, steps 2..K from windows into which each earlier prediction was
fed back projected onto distance matrices (symmetrised, its diagonal
zeroed); each example's loss is its relative L2 error
||p_t - d_t|| / ||d_t|| over the grid, averaged over the K steps with
equal weights, and the batch's loss is the sum over its examples. Adam
as ``reference/train.py`` has it, after the global gradient norm is
clipped to ``clip_norm``.

Departures from Li et al., each the model the port trains: the negative
row frequencies take conj(w) of the layer's one complex weight, where the
paper's code trains a second, independent weight (``weights2``); the
GELU is the tanh form; there are no grid-coordinate input channels, the
channels being the distance matrices alone; the ``predict_delta`` head;
the ``sym_zero_diag`` feedback of each prediction.

Precision: f32 throughout, TF32 off. ``rounding="tf32"`` rounds the
operands of every product (the linear layers' rows and
weights, each transform's input and the spectrum and weights the modes
mix), which is how a control computes in a lower precision. Examples run
``chunk`` at a time; the loss is a sum over the batch, so the chunks'
gradients add.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.gkn import no_tf32
from portbench.reference.train import B1, B2, EPS, leaves, rebuild_tree


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10-bit mantissa, to nearest, ties away; the
    gradient passes as through a cast."""
    bits = x.detach().float().contiguous().view(torch.int32)
    low = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (low - x).detach()


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDINGS = {"float32": _identity, "tf32": to_tf32}


def rounding_fn(rounding=None):
    return ROUNDINGS[rounding or "float32"]


def _round_complex(z: torch.Tensor, rnd) -> torch.Tensor:
    if rnd is _identity:
        return z
    return torch.complex(rnd(z.real), rnd(z.imag))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of the GELU."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def linear(layer: dict, x: torch.Tensor, rnd) -> torch.Tensor:
    return rnd(x) @ rnd(layer["w"]) + layer["b"]


def spectral_conv(layer: dict, x: torch.Tensor, m1: int, m2: int,
                  rnd) -> torch.Tensor:
    """x (b, R1, R2, width) -> the same shape, by full complex transforms
    (see the module docstring)."""
    r1, r2 = x.shape[1], x.shape[2]
    w = torch.complex(rnd(layer["w_real"]), rnd(layer["w_imag"]))
    xf = torch.fft.fft2(rnd(x).to(torch.complex64), dim=(1, 2))
    xf = _round_complex(xf, rnd)
    lo = torch.einsum("bxyi,ioxy->bxyo", xf[:, :m1, :m2], w)
    hi = torch.einsum("bxyi,ioxy->bxyo", xf[:, r1 - m1:, :m2], w.conj())
    col = torch.arange(m2, device=x.device)
    own = (col == 0) | ((r2 % 2 == 0) & (col == r2 // 2))
    double = torch.where(own, 1.0, 2.0).to(torch.complex64)[None, None, :,
                                                             None]
    spec = torch.zeros(x.shape[0], r1, r2, w.shape[1], dtype=torch.complex64,
                       device=x.device)
    spec[:, :m1, :m2] = lo * double
    spec[:, r1 - m1:, :m2] = hi * double
    spec = _round_complex(spec, rnd)
    return torch.fft.ifft2(spec, dim=(1, 2)).real


def model_step(w: dict, model: dict, x: torch.Tensor, rnd) -> torch.Tensor:
    """The next distance matrix (b, R, R) of channels x (b, R, R, T)."""
    m1, m2 = model["modes1"], model["modes2"]
    h = linear(w["lift"], x, rnd)
    for d in range(model["depth"]):
        s = spectral_conv(w[f"spectral_{d}"], h, m1, m2, rnd)
        h = gelu(s + linear(w[f"pointwise_{d}"], h, rnd))
    out = linear(w["proj2"], gelu(linear(w["proj1"], h, rnd)), rnd)[..., 0]
    if model.get("predict_delta", False):
        out = model.get("head_scale", 1.0) * out + x[..., -1]
    return out


def distances(positions: torch.Tensor) -> torch.Tensor:
    """(b, T, R, 3) frames -> (b, T, R, R) distance matrices."""
    diff = positions[:, :, :, None, :] - positions[:, :, None, :, :]
    return torch.sqrt((diff * diff).sum(dim=-1))


def sym_zero_diag(p: torch.Tensor) -> torch.Tensor:
    """(b, R, R) -> its symmetric part with the diagonal zeroed."""
    p = 0.5 * (p + p.transpose(1, 2))
    return p * (1.0 - torch.eye(p.shape[-1], device=p.device))


def unroll_loss(w: dict, model: dict, window: torch.Tensor,
                y_seq: torch.Tensor, rnd) -> torch.Tensor:
    """The K-step loss of windows (b, T, R, 3) with continuations
    (b, K, R, 3), summed over the examples."""
    x = distances(window).permute(0, 2, 3, 1)
    truth = distances(y_seq)
    k = truth.shape[1]
    loss = 0.0
    for t in range(k):
        p = model_step(w, model, x, rnd)
        err = torch.sqrt(((p - truth[:, t]) ** 2).sum(dim=(1, 2)))
        loss = loss + err / torch.sqrt((truth[:, t] ** 2).sum(dim=(1, 2)))
        x = torch.cat([x[..., 1:], sym_zero_diag(p)[..., None]], dim=-1)
    return (loss / k).sum()


def loss_and_grads(w: dict, model: dict, batch: dict, rounding=None,
                   chunk: int = 32):
    """(loss, {leaf path: gradient}) of one batch at the weights ``w``:
    batch["window"] (B, T, R, 3) and batch["y_seq"] (B, K, R, 3)."""
    no_tf32()
    rnd = rounding_fn(rounding)
    leaf = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(w)}
    tree = rebuild_tree(w, leaf)
    total = 0.0
    window, y_seq = batch["window"], batch["y_seq"]
    for lo in range(0, window.shape[0], chunk):
        loss = unroll_loss(tree, model, window[lo:lo + chunk],
                           y_seq[lo:lo + chunk], rnd)
        loss.backward()
        total += float(loss.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaf.items()}


def train(w0: dict, model: dict, batches: list, lr: float,
          weight_decay: float, clip_norm: float = 1.0, rounding=None,
          chunk: int = 32) -> dict:
    """Follow ``len(batches)`` curriculum steps from w0: {"losses": [...],
    "grad1": the first step's gradient as Adam took it (clipped, before
    the decay), "params": the weights after the last step}, both as
    {leaf path: tensor}."""
    p = {k: v.detach().clone() for k, v in leaves(w0)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    for t, batch in enumerate(batches, start=1):
        loss, g = loss_and_grads(rebuild_tree(w0, p), model, batch, rounding,
                                 chunk)
        losses.append(loss)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in g.values()]))
        if clip_norm and float(norm) >= clip_norm:
            g = {k: v * (clip_norm / norm) for k, v in g.items()}
        grad1 = grad1 if grad1 is not None else g
        c1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32), float(t))
        c2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32), float(t))
        for k in p:
            gk = g[k] + weight_decay * p[k]
            mu[k] = B1 * mu[k] + (1 - B1) * gk
            nu[k] = B2 * nu[k] + (1 - B2) * gk * gk
            upd = (mu[k] / c1.to(gk.device)) / (
                torch.sqrt(nu[k] / c2.to(gk.device)) + EPS)
            p[k] = p[k] - lr * upd
    return {"losses": losses, "grad1": grad1, "params": p}
