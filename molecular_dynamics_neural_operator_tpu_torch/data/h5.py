"""In-memory trajectory container (``molecular_dynamics_neural_operator_tpu/data/h5.py``).

Only ``TrajectoryData`` is ported: the container the synthetic generator
fills and ``WindowDataset`` reads. Reading HDF5 files (``load_trajectory``)
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TrajectoryData:
    """positions (N, R, 3) f32, per-frame ragged COO edge lists, amino-acid
    labels (R,) int32, optional rmsd (N,).

    Edge lists live in one of two forms: ``edge_indices``, a list of
    (2, E_i) int arrays, or packed CSR, ``edges_flat`` (2, total) int32 with
    ``edge_offsets`` (N+1,) int64. ``packed_edges()`` converts list to
    packed and caches it; ``edge_index(i)`` gives frame ``i`` either way."""

    positions: np.ndarray
    edge_indices: Optional[list]
    aminoacids: np.ndarray
    rmsd: Optional[np.ndarray] = None
    edges_flat: Optional[np.ndarray] = None
    edge_offsets: Optional[np.ndarray] = None

    @property
    def num_frames(self) -> int:
        return self.positions.shape[0]

    @property
    def num_residues(self) -> int:
        return self.positions.shape[1]

    def packed_edges(self):
        """(edges_flat (2, total) int32, offsets (N+1,) int64), cached."""
        if self.edges_flat is None:
            counts = np.array([e.shape[1] for e in self.edge_indices],
                              np.int64)
            offsets = np.zeros(len(counts) + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            if len(self.edge_indices):
                flat = np.concatenate(self.edge_indices, axis=1).astype(
                    np.int32, copy=False)
            else:
                flat = np.zeros((2, 0), np.int32)
            self.edges_flat, self.edge_offsets = flat, offsets
        return self.edges_flat, self.edge_offsets

    def edge_index(self, i: int) -> np.ndarray:
        """(2, E_i) edge list of frame ``i`` (a view in packed form)."""
        if self.edge_indices is not None:
            return self.edge_indices[i]
        o = self.edge_offsets
        return self.edges_flat[:, o[i]:o[i + 1]]
