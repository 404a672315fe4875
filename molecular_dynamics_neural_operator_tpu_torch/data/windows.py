"""Sliding-window dataset and batch assembly (``molecular_dynamics_neural_operator_tpu/data/windows.py``).

Window and horizon indexing as in the JAX package:

- ``len = N - window_size - horizon + 1``,
- window = positions[idx : idx + window_size],
- graph = contact map of frame ``idx``, the first window frame,
- target y = positions[idx + window_size + horizon - 1].

A batch is a dict of numpy arrays: ``aa`` (R,), ``window`` (B, T, R, 3),
``y`` (B, R, 3) and the graph of the window's first frame, from the stored
contact maps or recomputed from the coordinates:

- ``graph_mode="dense"``: ``adj`` (B, R, R) f32, [source, target];
- ``graph_mode="sparse"``: ``edges`` (B, 2, E) int32 with ``mask`` (B, E)
  f32, in the CSR-packed order of the stored lists
  (``edge_layout="csr"``) or in the block layout (``"blocked"``: node n
  owns slots [n*max_degree, (n+1)*max_degree), max_degree = E / R, its
  incoming edges front to back in stored order), which the
  ``scatter_mode="blocked"`` conv reduces by slot position;
- ``graph_mode="none"``: no graph.

Edge features are built on the device from the window. With
``use_native=True`` (the default, as in JAX) the window gather, the
stored contact maps and the CSR-packed edge lists come from the native
packer (``data/packing.py``), which gives the same arrays as the numpy
path; without its library the dataset takes the numpy path. Either way
it logs which, at INFO (a warning when the packer was asked for and is
missing). The blocked layout and recomputed graphs are numpy only, as in
JAX.
"""

from __future__ import annotations

import logging
from typing import Iterator, Sequence

import numpy as np

from molecular_dynamics_neural_operator_tpu_torch.data import packing
from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
    TrajectoryData,
)

log = logging.getLogger(__name__)


class WindowDataset:
    def __init__(
        self,
        traj: TrajectoryData,
        window_size: int = 10,
        horizon: int = 1,
        threshold: float = 8.0,
        graph_mode: str = "dense",  # "dense" | "sparse" | "none"
        max_edges: int = 384,
        use_stored_contact_maps: bool = True,
        use_native: bool = True,
        edge_layout: str = "csr",  # "csr" | "blocked"
    ):
        if traj.num_frames - window_size - horizon + 1 < 0:
            raise ValueError(
                "The sum of window_size and horizon is longer than the "
                "input data")
        if edge_layout not in ("csr", "blocked"):
            raise ValueError(f"unknown edge_layout: {edge_layout}")
        if edge_layout == "blocked":
            if graph_mode != "sparse":
                raise ValueError("edge_layout='blocked' requires sparse "
                                 "graph_mode")
            if max_edges % traj.num_residues:
                raise ValueError(
                    f"blocked layout needs max_edges divisible by "
                    f"num_residues; got {max_edges} % {traj.num_residues}")
            self.max_degree = max_edges // traj.num_residues
        self.traj = traj
        self.window_size = window_size
        self.horizon = horizon
        self.threshold = threshold
        self.graph_mode = graph_mode
        self.max_edges = max_edges
        self.use_stored_contact_maps = use_stored_contact_maps
        self.num_residues = traj.num_residues
        self.edge_layout = edge_layout
        self.use_native = use_native and packing.available()
        if self.use_native:
            # the packer reads f32 row-major frames: one copy, not one a batch
            self._positions32 = np.ascontiguousarray(traj.positions,
                                                     np.float32)
            log.info("WindowDataset: native packer (%s)", packing.SOURCE.name)
        elif use_native:
            log.warning("WindowDataset: numpy path, the native packer is not "
                        "available (%s)", packing.load_error())
        else:
            log.info("WindowDataset: numpy path (use_native=False)")
        if use_stored_contact_maps:
            self._edges_flat, self._offsets = traj.packed_edges()
            counts = np.diff(self._offsets)
            self._max_stored = int(counts.max()) if len(counts) else 0
            if graph_mode == "sparse" and self._max_stored > max_edges:
                raise ValueError(
                    f"stored edge count {self._max_stored} exceeds "
                    f"max_edges {max_edges}")
            if edge_layout == "blocked":
                # the per-node limit, checked once here rather than by a
                # batch deep into an epoch
                max_deg = self._max_stored_in_degree()
                if max_deg > self.max_degree:
                    raise ValueError(
                        f"stored max in-degree {max_deg} exceeds the "
                        f"blocked layout's max_degree {self.max_degree} "
                        f"(= max_edges {max_edges} / num_residues "
                        f"{traj.num_residues}); raise max_edges to at "
                        f"least {max_deg * traj.num_residues}")

    @staticmethod
    def _group_rank(key: np.ndarray):
        """(order, rank): a stable argsort of ``key`` and, for each sorted
        position, its rank among the equal keys before it."""
        order = np.argsort(key, kind="stable")
        sk = key[order]
        change = np.ones(len(sk), bool)
        change[1:] = sk[1:] != sk[:-1]
        group_start = np.flatnonzero(change)
        rank = np.arange(len(sk)) - group_start[np.cumsum(change) - 1]
        return order, rank

    def _max_stored_in_degree(self, chunk: int | None = None) -> int:
        """The largest in-degree of any (frame, target node) over the
        stored edge lists, in chunks of frames of bounded memory. Fills
        ``self._slot_flat``, each stored edge's block-layout slot (dst *
        max_degree + its rank among its node's edges), which a frame
        keeps for good, so a batch is a gather and a scatter."""
        r = self.num_residues
        if chunk is None:
            chunk = max(1, (1 << 27) // max(r, 1))
        nf = len(self._offsets) - 1
        self._slot_flat = np.zeros(int(self._offsets[-1]), np.int64)
        m = 0
        for i0 in range(0, nf, chunk):
            i1 = min(i0 + chunk, nf)
            s, e = int(self._offsets[i0]), int(self._offsets[i1])
            if e == s:
                continue
            dst = self._edges_flat[1, s:e].astype(np.int64)
            owner = np.repeat(np.arange(i1 - i0, dtype=np.int64),
                              np.diff(self._offsets[i0:i1 + 1]))
            order, rank = self._group_rank(owner * r + dst)
            m = max(m, int(rank.max()) + 1)
            slot = np.empty(len(order), np.int64)
            slot[order] = dst[order] * self.max_degree + rank
            self._slot_flat[s:e] = slot
        return m

    def __len__(self) -> int:
        return self.traj.num_frames - self.window_size - self.horizon + 1

    def _windows(self, idx: np.ndarray):
        t = self.window_size
        if self.use_native:
            window = packing.gather_windows(self._positions32, idx, t)
        else:
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
        if self.use_native:
            return packing.pack_dense_batch(self._edges_flat, self._offsets,
                                            idx, r)
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
        return self._batch_adj(np.asarray([frame_idx], np.int64))[0]

    def _batch_adj(self, idx: np.ndarray) -> np.ndarray:
        """(B, R, R) contact maps of frames ``idx``, stored or recomputed."""
        if self.use_stored_contact_maps:
            return self._stored_adj(idx)
        return self._recomputed_adj(idx)

    def _blocked_pack(self, owner, src, dst, b: int):
        """Batch COO (owner, src, dst) -> the block layout: node n owns
        slots [n*max_degree, (n+1)*max_degree), its incoming edges front
        to back."""
        r, max_deg = self.num_residues, self.max_degree
        order, rank = self._group_rank(owner * r + dst)
        if len(rank) and int(rank.max()) >= max_deg:
            raise ValueError(
                f"node in-degree {int(rank.max()) + 1} exceeds the blocked "
                f"layout's max_degree {max_deg} "
                f"(= max_edges {self.max_edges} / num_residues {r})")
        slot = dst[order] * max_deg + rank
        ow = owner[order]
        edges = np.zeros((b, 2, self.max_edges), np.int32)
        mask = np.zeros((b, self.max_edges), np.float32)
        edges[ow, 0, slot] = src[order]
        edges[ow, 1, slot] = dst[order]
        mask[ow, slot] = 1.0
        return edges, mask

    def _sparse_edges_blocked(self, idx: np.ndarray):
        """(B, 2, E) + mask in the block layout, from the stored lists
        (their precomputed slots) or from recomputed contact maps: both
        paths emit the block layout, which a "blocked" conv reduces by
        slot position."""
        b = len(idx)
        if not self.use_stored_contact_maps:
            ow, src, dst = np.nonzero(self._recomputed_adj(idx))
            return self._blocked_pack(ow, src.astype(np.int64),
                                      dst.astype(np.int64), b)
        starts = self._offsets[idx].astype(np.int64)
        ends = self._offsets[idx + 1].astype(np.int64)
        edge_slots = np.concatenate(
            [np.arange(s, e) for s, e in zip(starts, ends)]
        ) if b else np.zeros(0, np.int64)
        owner = np.repeat(np.arange(b), ends - starts)
        slot = self._slot_flat[edge_slots]
        edges = np.zeros((b, 2, self.max_edges), np.int32)
        mask = np.zeros((b, self.max_edges), np.float32)
        edges[owner, 0, slot] = self._edges_flat[0, edge_slots]
        edges[owner, 1, slot] = self._edges_flat[1, edge_slots]
        mask[owner, slot] = 1.0
        return edges, mask

    def _sparse_edges(self, idx: np.ndarray):
        """Padded edge lists (B, 2, E) + mask (B, E)."""
        if self.edge_layout == "blocked":
            return self._sparse_edges_blocked(idx)
        b = len(idx)
        e_max = self.max_edges
        edges = np.zeros((b, 2, e_max), np.int32)
        mask = np.zeros((b, e_max), np.float32)
        if self.use_stored_contact_maps:
            if self.use_native:
                return packing.pack_padded_batch(self._edges_flat,
                                                 self._offsets, idx, e_max)
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
        if self.graph_mode == "dense":
            out["adj"] = self._batch_adj(idx)
        elif self.graph_mode == "sparse":
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
