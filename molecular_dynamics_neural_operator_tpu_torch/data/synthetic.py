"""Synthetic BBA-like trajectories (numpy only).

The port's own copy of the JAX package's generator
(``molecular_dynamics_neural_operator_tpu/data/synthetic.py``): the same
random-number consumption and arithmetic, so a seed gives bit-identical
positions, amino acids, stored contact edges and rmsd in both packages.
The rollout's start window and the training data come from
``synthetic_trajectory(num_frames=4000, seed=13)``.
"""

from __future__ import annotations

import numpy as np

from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
    TrajectoryData,
)


def _chain_params(num_residues: int, seed: int):
    """Chain geometry, deformation modes and labels, drawn in the order
    (steps, modes, phases, aa) the JAX package draws them."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(size=(num_residues, 3))
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    base = np.cumsum(steps * 5.5, axis=0)
    base -= base.mean(axis=0)
    modes = rng.normal(scale=0.6, size=(3, num_residues, 3))
    freqs = np.array([1.0, 2.0, 3.0])[:, None, None, None]
    phases = rng.uniform(0, 2 * np.pi, size=(3, 1, 1))
    aa = rng.integers(0, 20, size=num_residues).astype(np.int32)
    return base, modes, freqs, phases, aa


def _positions_at(base, modes, freqs, phases, t) -> np.ndarray:
    """(len(t), R, 3) float32 positions at phase values ``t`` (radians)."""
    t = t[:, None, None]
    wobble = sum(
        modes[k] * np.sin(freqs[k] * t + phases[k]) for k in range(3)
    )
    return (base[None] + wobble).astype(np.float32)


def _contact_edges(positions: np.ndarray, threshold: float):
    """Ragged COO contact lists of a block of frames: (list of flattened
    [rows; cols] int32 arrays, counts (C,)). Distances come from the Gram
    matrix, |a|^2 + |b|^2 - 2<a, b>, as in the JAX package, so the same
    pairs pass the strict ``<`` test."""
    n2 = np.einsum("irk,irk->ir", positions, positions)
    g = np.matmul(positions, positions.swapaxes(1, 2))
    d2 = n2[:, :, None] + n2[:, None, :] - 2.0 * g
    contact = d2 < threshold**2
    counts = contact.sum(axis=(1, 2))
    _, s, d = np.nonzero(contact)  # frame-major order
    splits = np.cumsum(counts)[:-1]
    s_parts = np.split(s.astype(np.int32), splits)
    d_parts = np.split(d.astype(np.int32), splits)
    flat = [np.concatenate([a, b]) for a, b in zip(s_parts, d_parts)]
    return flat, counts


def _time_grid(num_frames: int, dt):
    """One period, ``linspace(0, 2pi, N)``, or ``N`` steps of ``dt``."""
    if dt is None:
        return np.linspace(0, 2 * np.pi, num_frames)
    return np.arange(num_frames, dtype=np.float64) * float(dt)


def synthetic_trajectory(
    num_frames: int = 256,
    num_residues: int = 28,
    threshold: float = 8.0,
    seed: int = 0,
    dt: float | None = None,
) -> TrajectoryData:
    """Random-walk chain breathing smoothly over time, with the contact
    map of every frame at ``threshold`` stored as a ragged edge list."""
    base, modes, freqs, phases, aa = _chain_params(num_residues, seed)
    positions = _positions_at(base, modes, freqs, phases,
                              _time_grid(num_frames, dt))
    flat, _ = _contact_edges(positions, threshold)
    rmsd = (np.linalg.norm(positions - positions[0], axis=(1, 2))
            / np.sqrt(num_residues)).astype(np.float32)
    return TrajectoryData(
        positions=positions,
        edge_indices=[e.reshape(2, -1) for e in flat],
        aminoacids=aa,
        rmsd=rmsd,
    )
