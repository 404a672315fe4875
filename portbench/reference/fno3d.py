"""FNO-3d on C-alpha distance matrices, in plain PyTorch: the benchmark's
frozen reference for the block-forecast cell (``entries/train_fno3d.py``).

The model is Li et al.'s space-time Fourier Neural Operator ("Fourier
Neural Operator for Parametric Partial Differential Equations", ICLR
2021, arXiv:2010.08895, section 5.3, Navier-Stokes; the authors'
``fourier_3d.py``, classes ``FNO3d`` and ``SpectralConv3d``), followed
step by step:

1. the input u (b, R, R, T_in), the T_in = 10 frames, repeated along a
   new time axis of the T output frames and joined by the grid
   coordinates (x, y, t), each ``linspace(0, 1)`` over its axis: (b, R,
   R, T, T_in + 3); the lift ``fc0`` to width 20; the channels moved
   first and the time axis padded by ``time_pad`` zeros (the domain is
   not periodic in time);
2. four layers h' = gelu(conv(h) + w(h)), no GELU after the last, w a
   1x1x1 convolution; conv keeps the modes k1 in [0, m1) and
   [R - m1, R), k2 likewise and k3 in [0, m3) and multiplies each by a
   complex (width, width) matrix, one independent weight for each of the
   four (k1, k2) corners;
3. the padding cropped, the channels moved last, ``fc1`` (width -> 128),
   the GELU (the exact erf form of ``F.gelu``) and ``fc2`` (128 -> 1).

The spectral convolution is computed by a route neither of the
program's forms takes: the complex ``torch.fft.fftn`` of the whole
padded grid; the four kept corners' products placed in a full zero
spectrum, whose time half k3 in [Z - m3 + 1, Z) is completed by
conjugate symmetry, S(k1, k2, Z - k3) = conj(S(-k1, -k2, k3)); and the
real part of ``torch.fft.ifftn`` of the whole grid. That real part is
what the real inverse of the half spectrum computes on the CPU when its
k3 = 0 plane is not Hermitian: a complex inverse over the two residue
axes, the imaginary part of the time axis's DC bin dropped, a real
inverse over time.

The block loss: each example's relative L2 error ||p - d|| / ||d|| over
its whole (R, R, T) block of distance matrices, summed over the batch
(``LpLoss(size_average=False)``). Adam as ``reference/train.py`` has it
(L2 decay added to the gradient, b1 0.9, b2 0.999, eps 1e-8), after the
global gradient norm is clipped to ``clip_norm``.

Departures from ``fourier_3d.py``, each for a reason:

- distance matrices of a protein's residues in place of the vorticity on
  a 64 x 64 periodic grid: the repository's data are trajectories;
- R = 80 (lambda-repressor's length, PDB 1LMB) in place of 64;
- no unit-Gaussian normalisers of the input and output, a data-side
  transform the training step does not need;
- a constant learning rate in place of ``StepLR(step_size=100,
  gamma=0.5)``: a 20-s window never reaches epoch 100;
- B = 32 in place of the paper's 10, to fill the card;
- the four unused ``BatchNorm3d`` layers are left out;
- the gradient clip and the skip of non-finite updates, the port's
  training recipe.

Precision: f32 throughout, TF32 off. ``rounding="tf32"`` rounds the
operands of every product (the linear layers' rows and weights, each
transform's input and the spectrum and weights the modes mix), which is
how a control computes in a lower precision on the CPU. Examples run
``chunk`` at a time; the loss is a sum over the batch, so the chunks'
gradients add.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.fno import _round_complex, distances, rounding_fn
from portbench.reference.gkn import no_tf32
from portbench.reference.train import B1, B2, EPS, leaves, rebuild_tree


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU, x * Phi(x)."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(layer: dict, x: torch.Tensor, rnd) -> torch.Tensor:
    return rnd(x) @ rnd(layer["w"]) + layer["b"]


def grid(b: int, r: int, t: int, device) -> torch.Tensor:
    """``FNO3d.get_grid``: (b, r, r, t, 3), the coordinates x, y and t,
    each linspace(0, 1) over its axis."""
    gx = torch.linspace(0.0, 1.0, r, device=device)
    gt = torch.linspace(0.0, 1.0, t, device=device)
    return torch.cat([
        gx.reshape(1, r, 1, 1, 1).repeat(b, 1, r, t, 1),
        gx.reshape(1, 1, r, 1, 1).repeat(b, r, 1, t, 1),
        gt.reshape(1, 1, 1, t, 1).repeat(b, r, r, 1, 1)], dim=-1)


def _negate(s: torch.Tensor, dim: int) -> torch.Tensor:
    """s with index k of ``dim`` moved to -k (mod the axis' length)."""
    return torch.roll(torch.flip(s, dims=[dim]), 1, dims=dim)


def spectral_conv(layer: dict, x: torch.Tensor, m1: int, m2: int, m3: int,
                  rnd) -> torch.Tensor:
    """x (b, width, X, Y, Z) -> the same shape, by full complex transforms
    (see the module docstring)."""
    b, _, nx, ny, nz = x.shape
    w = torch.complex(rnd(layer["w_real"]), rnd(layer["w_imag"]))
    xf = torch.fft.fftn(rnd(x).to(torch.complex64), dim=(-3, -2, -1))
    xf = _round_complex(xf, rnd)
    spec = torch.zeros(b, w.shape[2], nx, ny, nz, dtype=torch.complex64,
                       device=x.device)
    corners = ((slice(0, m1), slice(0, m2)),
               (slice(nx - m1, nx), slice(0, m2)),
               (slice(0, m1), slice(ny - m2, ny)),
               (slice(nx - m1, nx), slice(ny - m2, ny)))
    for c, (sx, sy) in enumerate(corners):
        spec[:, :, sx, sy, :m3] = torch.einsum(
            "bixyz,ioxyz->boxyz", xf[:, :, sx, sy, :m3], w[c])
    mirror = [k for k in range(1, m3) if nz - k >= m3]
    if mirror:
        half = spec[..., mirror]
        spec[..., [nz - k for k in mirror]] = _negate(
            _negate(half, 2), 3).conj()
    spec = _round_complex(spec, rnd)
    return torch.fft.ifftn(spec, dim=(-3, -2, -1)).real


def model_step(w: dict, model: dict, u: torch.Tensor, rnd) -> torch.Tensor:
    """The block (b, R, R, T) of distance matrices u (b, R, R, T_in) in."""
    b, r, _, t_in = u.shape
    t, pad = model["out_frames"], model["time_pad"]
    m = (model["modes1"], model["modes2"], model["modes3"])
    x = u.reshape(b, r, r, 1, t_in).repeat(1, 1, 1, t, 1)
    x = torch.cat([x, grid(b, r, t, u.device)], dim=-1)
    x = linear(w["lift"], x, rnd)
    x = x.permute(0, 4, 1, 2, 3)
    x = torch.nn.functional.pad(x, [0, pad])
    for d in range(model["depth"]):
        pw = w[f"pointwise_{d}"]
        x1 = spectral_conv(w[f"spectral_{d}"], x, *m, rnd)
        x2 = (torch.einsum("bixyz,io->boxyz", rnd(x), rnd(pw["w"]))
              + pw["b"][None, :, None, None, None])
        x = x1 + x2
        if d + 1 < model["depth"]:
            x = gelu(x)
    x = x[..., :t].permute(0, 2, 3, 4, 1)
    x = linear(w["proj2"], gelu(linear(w["proj1"], x, rnd)), rnd)
    return x[..., 0]


def block_loss(w: dict, model: dict, window: torch.Tensor,
               y_seq: torch.Tensor, rnd) -> torch.Tensor:
    """The block loss of windows (b, T_in, R, 3) with continuations
    (b, T, R, 3), summed over the examples."""
    u = distances(window).permute(0, 2, 3, 1)
    truth = distances(y_seq).permute(0, 2, 3, 1)
    p = model_step(w, model, u, rnd)
    num = torch.sqrt(((p - truth) ** 2).sum(dim=(1, 2, 3)))
    return (num / torch.sqrt((truth ** 2).sum(dim=(1, 2, 3)))).sum()


def loss_and_grads(w: dict, model: dict, batch: dict, rounding=None,
                   chunk: int = 8):
    """(loss, {leaf path: gradient}) of one batch at the weights ``w``:
    batch["window"] (B, T_in, R, 3) and batch["y_seq"] (B, T, R, 3)."""
    no_tf32()
    rnd = rounding_fn(rounding)
    leaf = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(w)}
    tree = rebuild_tree(w, leaf)
    total = 0.0
    window, y_seq = batch["window"], batch["y_seq"]
    for lo in range(0, window.shape[0], chunk):
        loss = block_loss(tree, model, window[lo:lo + chunk],
                          y_seq[lo:lo + chunk], rnd)
        loss.backward()
        total += float(loss.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaf.items()}


def train(w0: dict, model: dict, batches: list, lr: float,
          weight_decay: float, clip_norm: float = 1.0, rounding=None,
          chunk: int = 8) -> dict:
    """Follow ``len(batches)`` steps from w0: {"losses": [...], "grad1":
    the first step's gradient as Adam took it (clipped, before the
    decay), "params": the weights after the last step}, both as {leaf
    path: tensor}."""
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
