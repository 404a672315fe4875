"""Synthetic BBA-like trajectories (numpy only).

The port's own copy of the JAX package's generator
(``molecular_dynamics_neural_operator_tpu/data/synthetic.py``): the same
random-number consumption and arithmetic, so a seed gives bit-identical
positions, amino acids, stored contact edges and rmsd in both packages.
The rollout's start window and the training data come from
``synthetic_trajectory(num_frames=4000, seed=13)``.

The HDF5 writers (``write_synthetic_h5``, ``write_trajectory_h5``,
``write_langevin_h5`` and the bounded-memory
``write_synthetic_h5_streamed``) write the reference's schema, which both
packages' ``load_trajectory`` read; each imports h5py inside.

``langevin_trajectory`` is the second family: Langevin dynamics on a
double-well elastic network, with real per-frame motion that neither
copy-last nor constant-velocity extrapolation forecasts.
"""

from __future__ import annotations

from pathlib import Path

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


def langevin_trajectory(
    num_frames: int = 256,
    num_residues: int = 28,
    threshold: float = 8.0,
    seed: int = 0,
    dt: float = 0.05,
    friction: float = 0.5,
    kT: float = 0.15,
    eps_well: float = 2.0,
    well_width: float = 1.0,
    k_backbone: float = 5.0,
    k_center: float = 0.02,
    network_cutoff: float = 10.0,
    burn_in: int = 1000,
) -> TrajectoryData:
    """Langevin dynamics (BAOAB, mass 1) on an elastic network of the
    ``synthetic_trajectory`` fold: pairs closer than ``network_cutoff`` in
    the base fold interact through the double well
    ``V(r) = eps ((r - r0)^2 - w^2)^2 / w^4``, backbone bonds through stiff
    springs, and a weak tether ``k_center`` holds the chain near its fold.
    ``burn_in`` integrator steps equilibrate before the ``num_frames``
    recorded ones (one step a frame). The same draws and arithmetic as the
    JAX package's generator, so a seed gives the same bits in both."""
    rng = np.random.default_rng(seed)
    base, _, _, _, aa = _chain_params(num_residues, seed)
    base = base.astype(np.float64)

    d2 = np.sum((base[:, None] - base[None, :]) ** 2, axis=-1)
    iu, ju = np.triu_indices(num_residues, k=1)
    in_net = d2[iu, ju] < network_cutoff ** 2
    is_bb = (ju - iu) == 1
    keep = in_net | is_bb
    ei, ej = iu[keep], ju[keep]
    bb = is_bb[keep]
    r0 = np.sqrt(d2[ei, ej])
    inv_w4 = 1.0 / well_width ** 4

    def forces(x):
        dvec = x[ei] - x[ej]
        r = np.linalg.norm(dvec, axis=1)
        u = r - r0
        dv = np.where(
            bb, k_backbone * u,
            4.0 * eps_well * u * (u * u - well_width ** 2) * inv_w4,
        )
        fpair = (dv / np.maximum(r, 1e-9))[:, None] * dvec
        f = np.zeros_like(x)
        np.add.at(f, ei, -fpair)
        np.add.at(f, ej, fpair)
        return f - k_center * (x - base)

    x = base + rng.normal(scale=0.5 * well_width, size=base.shape)
    v = rng.normal(scale=np.sqrt(kT), size=base.shape)
    c1 = np.exp(-friction * dt)
    c2 = np.sqrt(kT * (1.0 - c1 * c1))
    half = 0.5 * dt

    positions = np.empty((num_frames, num_residues, 3), np.float32)
    f = forces(x)
    for step in range(burn_in + num_frames):
        v = v + half * f
        x = x + half * v
        v = c1 * v + c2 * rng.normal(size=v.shape)
        x = x + half * v
        f = forces(x)
        v = v + half * f
        if step >= burn_in:
            positions[step - burn_in] = x.astype(np.float32)

    flat, _ = _contact_edges(positions, threshold)
    rmsd = (np.linalg.norm(positions - positions[0], axis=(1, 2))
            / np.sqrt(num_residues)).astype(np.float32)
    return TrajectoryData(
        positions=positions,
        edge_indices=[e.reshape(2, -1) for e in flat],
        aminoacids=aa,
        rmsd=rmsd,
    )


def write_synthetic_h5(
    path,
    num_frames: int = 256,
    num_residues: int = 28,
    threshold: float = 8.0,
    seed: int = 0,
    dt: float | None = None,
) -> TrajectoryData:
    """Write a synthetic trajectory in the reference's HDF5 schema."""
    traj = synthetic_trajectory(num_frames, num_residues, threshold, seed,
                                dt=dt)
    write_trajectory_h5(path, traj)
    return traj


def write_trajectory_h5(path, traj: TrajectoryData) -> None:
    """Write any in-memory TrajectoryData in the reference's HDF5 schema."""
    import h5py

    path = Path(path)
    with h5py.File(path, "w") as f:
        # ragged COO flattened per frame ([rows; cols]), which the loader
        # reshapes with .reshape(2, -1); one slice assignment batches the
        # vlen writes
        vlen = h5py.vlen_dtype(np.int32)
        cm = f.create_dataset("contact_map", (traj.num_frames,), dtype=vlen)
        cm[:] = [e.reshape(-1) for e in traj.edge_indices]
        f.create_dataset(
            "point_cloud", data=np.transpose(traj.positions, (0, 2, 1))
        )
        f.create_dataset("amino_acids", data=traj.aminoacids)
        f.create_dataset("rmsd", data=traj.rmsd)


def write_langevin_h5(path, **kwargs) -> TrajectoryData:
    """Write a ``langevin_trajectory`` in the reference's HDF5 schema."""
    traj = langevin_trajectory(**kwargs)
    write_trajectory_h5(path, traj)
    return traj


def write_synthetic_h5_streamed(
    path,
    num_frames: int,
    num_residues: int = 28,
    threshold: float = 8.0,
    seed: int = 0,
    chunk_frames: int = 65536,
    progress: bool = False,
    dt: float | None = None,
) -> dict:
    """Reference-scale synthetic h5 writer: O(chunk_frames) host memory.

    Generates positions/contacts chunk-by-chunk (the full (N, R, R)
    distance tensor of the one-shot path would be terabytes at 1FME's
    1.1M frames) and batches each chunk's ragged vlen writes into a single
    h5py slice assignment. Output is bit-identical to
    ``write_synthetic_h5(path, num_frames, ...)`` for the same seed
    and ``dt``.

    Returns a summary dict (frames, total/max edge counts, bytes)."""
    import h5py

    base, modes, freqs, phases, aa = _chain_params(num_residues, seed)
    t_all = _time_grid(num_frames, dt)

    path = Path(path)
    total_edges = 0
    max_edges = 0
    with h5py.File(path, "w") as f:
        vlen = h5py.vlen_dtype(np.int32)
        cm = f.create_dataset(
            "contact_map", (num_frames,), dtype=vlen,
            chunks=(min(num_frames, 4096),),
        )
        pc = f.create_dataset(
            "point_cloud", (num_frames, 3, num_residues), dtype=np.float32,
            chunks=(min(num_frames, 4096), 3, num_residues),
        )
        rm = f.create_dataset("rmsd", (num_frames,), dtype=np.float32)
        f.create_dataset("amino_acids", data=aa)

        pos0 = None
        for i0 in range(0, num_frames, chunk_frames):
            i1 = min(i0 + chunk_frames, num_frames)
            pos = _positions_at(base, modes, freqs, phases, t_all[i0:i1])
            if pos0 is None:
                pos0 = pos[0]
            flat, counts = _contact_edges(pos, threshold)
            cm[i0:i1] = flat
            pc[i0:i1] = np.transpose(pos, (0, 2, 1))
            rm[i0:i1] = (
                np.linalg.norm(pos - pos0[None], axis=(1, 2))
                / np.sqrt(num_residues)
            ).astype(np.float32)
            total_edges += int(counts.sum())
            max_edges = max(max_edges, int(counts.max()))
            if progress:
                print(f"[write_synthetic_h5_streamed] {i1}/{num_frames} "
                      f"frames", flush=True)

    return {
        "path": str(path),
        "num_frames": num_frames,
        "num_residues": num_residues,
        "total_edges": total_edges,
        "max_edges_per_frame": max_edges,
        "file_bytes": path.stat().st_size,
    }
