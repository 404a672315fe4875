"""Debye-Hückel electrostatics on the device
(``molecular_dynamics_neural_operator_tpu/preprocess/grid_jax.py``).

Two uses of the screened-Coulomb potential of point charges,

    phi(r) = lB * sum_i q_i * exp(-kappa |r - r_i|) / |r - r_i|   (kT/e),

the linearized Poisson-Boltzmann solution with the APBS deck's ``bcfl
sdh`` boundary (310 K, 0.15 M salt, eps_s 78):

- at the residue sites, from all other residues (``debye_huckel_at_atoms``):
  the node feature the model reads under ``electrostatics="dh"``, a pure
  function of positions and charges, recomputed from the predicted
  coordinates at every rollout step;
- on a regular grid (``make_grid``, ``debye_huckel_grid``,
  ``batched_debye_huckel_grids``): the preprocessing path that needs no
  external binaries (``cli/preprocess.py --mode dh``), blocked over grid
  points as in JAX so that a 10,000-atom frame on the deck's 97 x 65 x 65
  grid never holds the whole (G, N) distance matrix, and
  ``sample_grid_trilinear``, which reads a grid (this one or an APBS
  ``.dx``) back at the atoms.

Plain PyTorch on whatever device the inputs are on; no kernel of the
JAX package computes these.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Bjerrum length prefactor: e^2 / (4 pi eps0 kB) in units of A * K.
_BJERRUM_A_K = 16712.2

# Minimum interaction distance (A) clamping the screened-Coulomb kernel;
# the plain path and csrc/graph_encode.cu take the same value.
DH_MIN_DIST = 1.0

# Net side-chain charge (elementary units, pH 7) per amino-acid embedding
# index, alphabetical order (ALA ARG ASN ASP CYS GLN GLU GLY HIS ILE LEU
# LYS MET PHE PRO SER THR TRP TYR VAL): ARG/LYS +1, ASP/GLU -1, HIS +0.1.
AMINO_ACID_CHARGES = np.asarray(
    [0.0, 1.0, 0.0, -1.0, 0.0, 0.0, -1.0, 0.0, 0.1, 0.0,
     0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    dtype=np.float32,
)


def bjerrum_length(eps_s: float = 78.0, temperature: float = 310.0) -> float:
    """Bjerrum length in A."""
    return _BJERRUM_A_K / (eps_s * temperature)


def debye_kappa(ionic_strength_M: float = 0.15, eps_s: float = 78.0,
                temperature: float = 310.0) -> float:
    """Inverse Debye length (1/A) for a 1:1 salt."""
    lb = bjerrum_length(eps_s, temperature)
    # kappa^2 = 8 pi lB n, n = ions/A^3 = N_A * I(mol/L) * 1e-27
    n = 6.02214076e23 * ionic_strength_M * 1e-27
    return math.sqrt(8.0 * math.pi * lb * n)


_charge_tables: dict = {}


def _charge_table(device) -> torch.Tensor:
    """``AMINO_ACID_CHARGES`` on ``device``, made once per device in eager
    calls, so that a rollout step captured in a CUDA graph copies nothing
    from the host. Under ``torch.export`` or ``torch.compile`` it is made
    anew: a tensor made while a trace runs is the trace's."""
    if torch.compiler.is_compiling():
        return torch.as_tensor(AMINO_ACID_CHARGES, device=device)
    if device not in _charge_tables:
        _charge_tables[device] = torch.as_tensor(AMINO_ACID_CHARGES,
                                                 device=device)
    return _charge_tables[device]


def residue_charges(aa: torch.Tensor) -> torch.Tensor:
    """Charges of the amino-acid labels ``aa`` (any shape, int), f32."""
    return _charge_table(aa.device)[aa.long() % 20]


def debye_huckel_at_atoms(positions: torch.Tensor, charges: torch.Tensor,
                          eps_s: float = 78.0, temperature: float = 310.0,
                          ionic_strength_M: float = 0.15,
                          min_dist: float = DH_MIN_DIST) -> torch.Tensor:
    """Screened-Coulomb potential (kT/e) at each site from all other
    sites. positions (..., N, 3), charges (N,) or (..., N) -> (..., N).
    The distance is clamped at ``min_dist`` before the square root's
    result is used, and site i sums the charges of the sources j != i."""
    kappa = debye_kappa(ionic_strength_M, eps_s, temperature)
    lb = bjerrum_length(eps_s, temperature)
    diff = positions[..., :, None, :] - positions[..., None, :, :]
    d2 = (diff ** 2).sum(-1)
    d = torch.sqrt(torch.clamp(d2, min=min_dist * min_dist))
    green = torch.exp(-kappa * d) / d
    n = positions.shape[-2]
    green = green * (1.0 - torch.eye(n, dtype=green.dtype,
                                     device=green.device))
    return lb * (green * charges[..., None, :]).sum(-1)


def _linspace_f32(start: torch.Tensor, stop: torch.Tensor,
                  n: int) -> torch.Tensor:
    """JAX's f32 ``linspace`` as XLA compiles it on the CPU: s = i *
    f32(1/div), then start * (1 - s) plus i * (stop * f32(1/div)) with
    the second product fused into the sum (one rounding, made here by an
    exact f64 product), and the last point exactly ``stop``."""
    if n == 1:
        return start.reshape(1)
    div = n - 1
    rcp = torch.tensor(1.0 / div, dtype=torch.float32, device=start.device)
    i = torch.arange(div, dtype=torch.float32, device=start.device)
    head = start * (1 - i * rcp)
    fused = i.double() * (stop * rcp).double() + head.double()
    return torch.cat([fused.float(), stop.reshape(1)])


def make_grid(center, lengths, dime, device=None) -> torch.Tensor:
    """Regular grid points (prod(dime), 3), f32, around ``center``
    spanning ``lengths`` (the deck's fglen box), axis 0 slowest.

    Each axis is ``_linspace_f32``: bit for bit the JAX package's points
    on the deck's 97 x 65 x 65 grid. XLA's CPU code generation picks the
    product it fuses by the loop's shape, so on a few short axes (4
    points) a point may differ from JAX's by 1 ulp."""
    axes = []
    for d in range(3):
        start = torch.as_tensor(center[d] - lengths[d] / 2.0,
                                dtype=torch.float32, device=device)
        stop = torch.as_tensor(center[d] + lengths[d] / 2.0,
                               dtype=torch.float32, device=device)
        axes.append(_linspace_f32(start, stop, int(dime[d])))
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                       dim=-1)


def _dh_block(points, positions, charges, kappa: float, lb: float,
              min_dist: float) -> torch.Tensor:
    """phi at points (B, 3) from positions (..., N, 3): (..., B)."""
    d2 = None
    for k in range(3):
        diff = points[:, k, None] - positions[..., None, :, k]
        d2 = diff * diff if d2 is None else d2.add_(diff * diff)
    d = d2.clamp_(min=min_dist * min_dist).sqrt_()
    green = torch.exp(d * -kappa).div_(d)
    return lb * torch.matmul(green, charges[..., :, None])[..., 0]


def debye_huckel_grid(positions: torch.Tensor, charges: torch.Tensor,
                      grid_points: torch.Tensor, eps_s: float = 78.0,
                      temperature: float = 310.0,
                      ionic_strength_M: float = 0.15, min_dist: float = 1.0,
                      block: int = 4096) -> torch.Tensor:
    """Potential (kT/e) at each grid point from screened point charges:
    positions (..., N, 3) A, charges (N,) or (..., N), grid_points (G, 3)
    -> (..., G). The (G, N) distances are made ``block`` grid points at a
    time, so memory stays at (..., block, N)."""
    kappa = debye_kappa(ionic_strength_M, eps_s, temperature)
    lb = bjerrum_length(eps_s, temperature)
    charges = charges.to(positions.dtype)
    return torch.cat([_dh_block(grid_points[i:i + block], positions,
                                charges, kappa, lb, min_dist)
                      for i in range(0, grid_points.shape[0], block)],
                     dim=-1)


def batched_debye_huckel_grids(trajectory_positions: torch.Tensor,
                               charges: torch.Tensor,
                               grid_points: torch.Tensor,
                               block: int = 4096,
                               max_elements: int = 1 << 26,
                               **kwargs) -> torch.Tensor:
    """Grids for every frame of a (T, N, 3) trajectory: (T, G). Frames go
    through ``debye_huckel_grid`` together, as many at a time as keep a
    (frames, block, N) temporary under ``max_elements``; a JAX
    ``lax.map`` over frames in the JAX package."""
    n_frames, n_atoms = trajectory_positions.shape[:2]
    per = max(1, max_elements // max(1, block * n_atoms))
    return torch.cat([debye_huckel_grid(trajectory_positions[i:i + per],
                                        charges, grid_points, block=block,
                                        **kwargs)
                      for i in range(0, n_frames, per)], dim=0)


def sample_grid_trilinear(grid: torch.Tensor, origin, spacing,
                          positions: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of a (gx, gy, gz) potential grid at
    positions (N, 3): the consumer of APBS ``.dx`` grids
    (``preprocess/electrostatics.py``'s parser) and of
    ``debye_huckel_grid``'s. Positions outside the box clamp to its
    boundary."""
    dev = positions.device
    shape = torch.as_tensor(grid.shape, dtype=torch.float32, device=dev)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    spacing = torch.as_tensor(spacing, dtype=torch.float32, device=dev)
    f = (positions - origin) / spacing  # fractional grid coords (N, 3)
    f = torch.minimum(torch.clamp(f, min=0.0), shape - 1.0)
    f0 = torch.floor(torch.minimum(f, shape - 2.0))
    t = f - f0
    i0 = f0.to(torch.int64)
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                corner = torch.tensor([dx, dy, dz], device=dev)
                idx = i0 + corner
                w = torch.prod(torch.where(corner == 1, t, 1.0 - t), dim=-1)
                term = w * grid[idx[:, 0], idx[:, 1], idx[:, 2]]
                out = term if out is None else out + term
    return out
