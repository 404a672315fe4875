"""Debye-Hückel electrostatics at the residue sites
(``molecular_dynamics_neural_operator_tpu/preprocess/grid_jax.py``).

The part of the JAX module that the model reads under
``electrostatics="dh"``: the screened-Coulomb potential at each residue
from all other residues, a pure function of positions and charges, so it
is recomputed from the predicted coordinates at every rollout step. The
grids (``make_grid``, ``debye_huckel_grid``, ``sample_grid_trilinear``)
are not ported yet.
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


def residue_charges(aa: torch.Tensor) -> torch.Tensor:
    """Charges of the amino-acid labels ``aa`` (any shape, int), f32."""
    table = torch.as_tensor(AMINO_ACID_CHARGES, device=aa.device)
    return table[aa.long() % 20]


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
