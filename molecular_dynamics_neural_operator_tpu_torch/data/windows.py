"""Sliding-window dataset and batch assembly (``molecular_dynamics_neural_operator_tpu/data/windows.py``).

Window and horizon indexing as in the JAX package:

- ``len = N - window_size - horizon + 1``,
- window = positions[idx : idx + window_size],
- graph = contact map of frame ``idx``, the first window frame,
- target y = positions[idx + window_size + horizon - 1].

A batch is a dict of numpy arrays: ``aa`` (R,), ``window`` (B, T, R, 3),
``y`` (B, R, 3) and, in sparse mode, ``edges`` (B, 2, E) int32 with
``mask`` (B, E) f32 in the CSR-packed order of the stored lists. Edge
features are built on the device from the window.

Ported: ``graph_mode`` "sparse" and "none" with ``edge_layout="csr"``,
stored or recomputed contact maps, and ``dense_adj``, one frame's
(R, R) map. The dense mode, the blocked layout and
the native C++ packer are not ported yet.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
    TrajectoryData,
)


class WindowDataset:
    def __init__(
        self,
        traj: TrajectoryData,
        window_size: int = 10,
        horizon: int = 1,
        threshold: float = 8.0,
        graph_mode: str = "dense",  # "sparse" | "none" are ported
        max_edges: int = 384,
        use_stored_contact_maps: bool = True,
        edge_layout: str = "csr",
    ):
        if traj.num_frames - window_size - horizon + 1 < 0:
            raise ValueError(
                "The sum of window_size and horizon is longer than the "
                "input data")
        if graph_mode not in ("sparse", "none"):
            raise NotImplementedError(
                f"graph_mode={graph_mode!r} is not ported yet; 'sparse' "
                "and 'none' are")
        if edge_layout != "csr":
            raise NotImplementedError(
                f"edge_layout={edge_layout!r} is not ported yet; only "
                "'csr' is")
        self.traj = traj
        self.window_size = window_size
        self.horizon = horizon
        self.threshold = threshold
        self.graph_mode = graph_mode
        self.max_edges = max_edges
        self.use_stored_contact_maps = use_stored_contact_maps
        self.num_residues = traj.num_residues
        self.edge_layout = edge_layout
        if use_stored_contact_maps:
            self._edges_flat, self._offsets = traj.packed_edges()
            counts = np.diff(self._offsets)
            self._max_stored = int(counts.max()) if len(counts) else 0
            if graph_mode == "sparse" and self._max_stored > max_edges:
                raise ValueError(
                    f"stored edge count {self._max_stored} exceeds "
                    f"max_edges {max_edges}")

    def __len__(self) -> int:
        return self.traj.num_frames - self.window_size - self.horizon + 1

    def _windows(self, idx: np.ndarray):
        t = self.window_size
        gather = idx[:, None] + np.arange(t)[None, :]
        window = self.traj.positions[gather]  # (B, T, R, 3)
        y = self.traj.positions[idx + t + self.horizon - 1]
        return window.astype(np.float32, copy=False), y.astype(np.float32)

    def _recomputed_adj(self, idx: np.ndarray) -> np.ndarray:
        """Contact maps of frames ``idx`` from the coordinates."""
        pos = self.traj.positions[idx]  # (B, R, 3)
        d2 = np.sum((pos[:, :, None, :] - pos[:, None, :, :]) ** 2, axis=-1)
        return (d2 < self.threshold**2).astype(np.float32)

    def _stored_adj(self, idx: np.ndarray) -> np.ndarray:
        """The stored contact maps of frames ``idx`` densified with one
        scatter: (B, R, R) f32."""
        b, r = len(idx), self.num_residues
        starts = self._offsets[idx]
        ends = self._offsets[idx + 1]
        edge_slots = np.concatenate(
            [np.arange(s, e) for s, e in zip(starts, ends)]
        ) if b else np.zeros(0, np.int64)
        owner = np.repeat(np.arange(b), ends - starts)
        adj = np.zeros((b, r, r), np.float32)
        adj[owner, self._edges_flat[0, edge_slots].astype(np.int64),
            self._edges_flat[1, edge_slots].astype(np.int64)] = 1.0
        return adj

    def dense_adj(self, frame_idx: int) -> np.ndarray:
        """The (R, R) contact map of one frame, stored or recomputed from
        the coordinates: the movie's "real" map."""
        idx = np.asarray([frame_idx], np.int64)
        if self.use_stored_contact_maps:
            return self._stored_adj(idx)[0]
        return self._recomputed_adj(idx)[0]

    def _sparse_edges(self, idx: np.ndarray):
        """Padded edge lists (B, 2, E) + mask (B, E)."""
        b = len(idx)
        e_max = self.max_edges
        edges = np.zeros((b, 2, e_max), np.int32)
        mask = np.zeros((b, e_max), np.float32)
        if self.use_stored_contact_maps:
            starts = self._offsets[idx]
            ends = self._offsets[idx + 1]
            for i, (s, e) in enumerate(zip(starts, ends)):
                n = e - s
                edges[i, :, :n] = self._edges_flat[:, s:e]
                mask[i, :n] = 1.0
        else:
            adj = self._recomputed_adj(idx)
            for i in range(b):
                s, d = np.nonzero(adj[i])
                n = len(s)
                if n > e_max:
                    raise ValueError(
                        f"edge count {n} exceeds max_edges {e_max}")
                edges[i, 0, :n] = s
                edges[i, 1, :n] = d
                mask[i, :n] = 1.0
        return edges, mask

    def get_batch(self, idx: Sequence[int], rollout_horizon: int = 0) -> dict:
        """Assemble a batch. ``rollout_horizon=K > 0`` also attaches
        ``y_seq`` (B, K, R, 3), the K true frames after each window;
        indices must satisfy idx + window_size + K <= num_frames."""
        idx = np.asarray(idx, np.int64)
        window, y = self._windows(idx)
        out = {"aa": self.traj.aminoacids, "window": window, "y": y}
        if rollout_horizon > 0:
            t = self.window_size
            gather = idx[:, None] + t + np.arange(rollout_horizon)[None, :]
            if gather.max() >= self.traj.num_frames:
                raise ValueError("rollout_horizon exceeds trajectory length "
                                 "for these indices")
            out["y_seq"] = self.traj.positions[gather].astype(np.float32)
        if self.graph_mode == "sparse":
            out["edges"], out["mask"] = self._sparse_edges(idx)
        return out


def batch_iterator(
    dataset: WindowDataset,
    indices: Sequence[int],
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    epoch: int = 0,
    rollout_horizon: int = 0,
    pad_last: bool = False,
) -> Iterator[dict]:
    """Deterministic shuffled batch stream; the permutation is drawn from
    ``SeedSequence([seed, epoch])``. With ``rollout_horizon=K``, indices
    whose K-step continuation would run past the trajectory are dropped and
    batches carry ``y_seq``.

    ``pad_last=True`` (with ``drop_last=False``) pads the remainder batch to
    ``batch_size`` by repeating its last index and attaches ``w`` (B,), 1
    for real rows and 0 for padding, so every batch has one shape."""
    indices = np.asarray(indices, np.int64)
    if rollout_horizon > 0:
        limit = (dataset.traj.num_frames - dataset.window_size
                 - rollout_horizon)
        indices = indices[indices <= limit]
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        indices = rng.permutation(indices)
    n = len(indices)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        idx = indices[i:i + batch_size]
        real = len(idx)
        if pad_last and 0 < real < batch_size:
            idx = np.concatenate(
                [idx, np.full(batch_size - real, idx[-1], np.int64)])
        batch = dataset.get_batch(idx, rollout_horizon=rollout_horizon)
        if pad_last:
            w = np.zeros((len(idx),), np.float32)
            w[:real] = 1.0
            batch["w"] = w
        yield batch
