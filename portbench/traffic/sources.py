"""Coordinates the traffic draws start windows from. Copies of the
program's generators, kept here so that a change to the program cannot
change the yardstick:

- ``chain_trajectory``: the synthetic BBA-like chain, a random walk of
  5.5 A steps breathing in three modes (the positions and amino acids of
  the port's ``data/synthetic.py::synthetic_trajectory``, bit for bit);
- ``serpentine_grid`` and ``breathing_trajectory``: N atoms on a cubic
  grid walked as a chain, moving in a smooth field of 8 sine modes (the
  ~10k-atom system of ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np


def chain_trajectory(num_frames: int, num_residues: int, seed: int):
    """(positions (num_frames, R, 3) f32, aa (R,) int32): one period of the
    breathing chain, as ``synthetic_trajectory(num_frames, R, seed=seed)``
    gives them."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(num_residues, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    base = np.cumsum(steps * 5.5, axis=0)
    base -= base.mean(axis=0)
    modes = rng.normal(scale=0.6, size=(3, num_residues, 3))
    freqs = np.array([1.0, 2.0, 3.0])[:, None, None, None]
    phases = rng.uniform(0, 2 * np.pi, size=(3, 1, 1))
    aa = rng.integers(0, 20, size=num_residues).astype(np.int32)
    t = np.linspace(0, 2 * np.pi, num_frames)[:, None, None]
    wobble = sum(modes[k] * np.sin(freqs[k] * t + phases[k])
                 for k in range(3))
    return (base[None] + wobble).astype(np.float32), aa


def serpentine_grid(n: int, spacing: float) -> np.ndarray:
    """The first n points of a boustrophedon walk over a cubic grid:
    consecutive chain indices are neighbouring grid points."""
    side = int(np.ceil(n ** (1 / 3)))
    pts = []
    for z in range(side):
        ys = range(side) if z % 2 == 0 else range(side - 1, -1, -1)
        for yi, y in enumerate(ys):
            fwd = (z * side + yi) % 2 == 0
            for x in (range(side) if fwd else range(side - 1, -1, -1)):
                pts.append((x, y, z))
                if len(pts) == n:
                    return np.asarray(pts, np.float32) * spacing
    return np.asarray(pts[:n], np.float32) * spacing


def breathing_trajectory(base: np.ndarray, num_frames: int, seed: int,
                         amplitude: float = 0.35,
                         dt: float = 0.02) -> np.ndarray:
    """base plus a smooth field of 8 sine modes, (num_frames, N, 3)."""
    rng = np.random.default_rng(seed)
    m = 8
    k = rng.normal(size=(m, 3)).astype(np.float32) * 0.15
    phi = rng.uniform(0, 2 * np.pi, size=m).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, size=m).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
    e = rng.normal(size=(m, 3)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    spatial = np.sin(base @ k.T + phi)
    t = (np.arange(num_frames, dtype=np.float32) * dt)[:, None]
    temporal = np.sin(w[None] * t + psi[None]) * amplitude
    disp = np.einsum("rm,nm,mc->nrc", spatial, temporal, e)
    return (base[None] + disp).astype(np.float32)


def chain_contacts(positions: np.ndarray, threshold: float) -> list:
    """Each frame's stored contact list, (2, n) int32 [rows; cols] in
    row-major order, self-loops kept: the trajectory file's contact maps,
    whose distances come from the Gram matrix |a|^2 + |b|^2 - 2<a, b>
    (as ``data/synthetic.py`` stores them)."""
    n2 = np.einsum("irk,irk->ir", positions, positions)
    g = np.matmul(positions, positions.swapaxes(1, 2))
    d2 = n2[:, :, None] + n2[:, None, :] - 2.0 * g
    contact = d2 < threshold ** 2
    out = []
    for frame in contact:
        s, d = np.nonzero(frame)
        out.append(np.stack([s, d]).astype(np.int32))
    return out
