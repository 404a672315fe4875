"""HDF5 trajectory ingestion (``molecular_dynamics_neural_operator_tpu/data/h5.py``).

The port's own copy of the reference's file layout:

- ``contact_map``: ragged COO edge lists per frame, flattened [rows; cols];
- ``point_cloud``: (N, 3, R) coordinates, transposed to (N, R, 3) on load
  (files stored (N, R, 3) are detected and not transposed again);
- ``rmsd``: per-frame RMSD, optional;
- ``amino_acids``: integer labels, optionally from a separate file.

``load_trajectory`` reads one file or a directory of them (sorted
``*.h5``, concatenated) in bounded-memory chunks into the packed CSR form
of ``TrajectoryData``, with the repairs and refusals of ``schema.py``.
``h5py`` is imported inside the functions that read or write files: the
rest of the port runs without it.
"""

from __future__ import annotations

import glob
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np

from molecular_dynamics_neural_operator_tpu_torch.data.schema import (
    check_edge_ranges,
    detect_pointcloud_layout,
    normalize_amino_labels,
)

PathLike = Union[str, Path]


def aminoacid_int_to_onehot(labels: np.ndarray) -> np.ndarray:
    """One-hot over the 20 amino acids; labels are 1-indexed in [1, 20]
    (the reference's helper). Vectorized (no Python loop)."""
    labels = np.asarray(labels)
    onehot = np.zeros((len(labels), 20), np.float32)
    onehot[np.arange(len(labels)), labels - 1] = 1.0
    return onehot


def compute_node_features(
    labels: np.ndarray,
    node_feature: str = "amino_acid_onehot",
    num_nodes: Optional[int] = None,
    constant_num_node_features: int = 20,
) -> np.ndarray:
    """The reference's node-feature modes: "constant" (all-ones),
    "identity" (eye), "amino_acid_onehot". The training path feeds the raw
    integer labels to the embedding; these exist for models that consume
    feature vectors directly."""
    n = num_nodes if num_nodes is not None else len(labels)
    if node_feature == "constant":
        return np.ones((n, constant_num_node_features), np.float32)
    if node_feature == "identity":
        return np.eye(n, dtype=np.float32)
    if node_feature == "amino_acid_onehot":
        return aminoacid_int_to_onehot(labels)
    raise ValueError(f"node_feature: {node_feature} not supported.")


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


# Chunk sizes for bounded-memory reads: ~128k ragged edge lists / ~256k
# position frames in flight at once (a few hundred MB peak at BBA shapes)
# regardless of total file size.
_EDGE_CHUNK = 131072
_POS_CHUNK = 262144


def _read_edges_packed(dset, max_frames: int, chunk: Optional[int] = None):
    """Chunked vlen read -> (list of (2, total_chunk) int32 blocks,
    per-frame edge counts (n,) int64). Frames are flattened [rows; cols]
    per the reference schema (``dataset.py:189`` reshapes with (2, -1))."""
    chunk = _EDGE_CHUNK if chunk is None else chunk
    n = min(dset.shape[0], max_frames)
    blocks = []
    counts = np.empty(n, np.int64)
    for i0 in range(0, n, chunk):
        raw = dset[i0:min(i0 + chunk, n)]
        parts = []
        for j, b in enumerate(raw):
            b = np.asarray(b)
            if b.ndim == 1 and b.size % 2:
                raise ValueError(
                    f"contact_map frame {i0 + j} has odd length {b.size} "
                    "— cannot split into [rows; cols] (dataset.py:189 "
                    "reshape contract)"
                )
            parts.append(b.reshape(2, -1))
        counts[i0:i0 + len(parts)] = [p.shape[1] for p in parts]
        blocks.append(
            np.concatenate(parts, axis=1).astype(np.int32, copy=False)
            if parts else np.zeros((2, 0), np.int32)
        )
    return blocks, counts


def load_trajectory(
    path: PathLike,
    edge_index_dset_name: str = "contact_map",
    edge_attr_dset_name: str = "point_cloud",
    node_feature_dset_name: str = "amino_acids",
    node_feature_dset_path: Optional[PathLike] = None,
    max_frames: int = 100_000_000,
) -> TrajectoryData:
    """Load one ``.h5`` file or a directory of them (concatenated in sorted
    order). Positions are transposed from the on-disk (N, 3, R) to (N, R, 3).

    Edges come back in the packed CSR form (``TrajectoryData.edges_flat`` /
    ``edge_offsets``), read in bounded-memory chunks — unlike the
    reference's whole-ragged-file-into-python-objects load
    (``dataset.py:110-141``), this holds at most a chunk of vlen objects
    at a time and scales to the full 1FME 1.1M-frame trajectory. Per-frame
    ``(2, E_i)`` views are available via ``TrajectoryData.edge_index(i)``."""
    import h5py

    path = Path(path)
    if str(path).endswith(".h5"):
        files = [path]
    else:
        files = sorted(Path(p) for p in glob.glob(str(path) + "/*.h5"))
        if not files:
            raise FileNotFoundError(f"no .h5 files under {path}")

    # Pass 1: per-file frame counts + residue count + point-cloud layout
    # ((N, 3, R) reference vs already-row-major (N, R, 3), detected per
    # file — data/schema.py), so positions are allocated exactly once
    # (no transpose-then-concatenate double copy).
    sizes = []
    layouts = []
    num_residues = None
    for fp in files:
        with h5py.File(fp, "r", libver="latest", swmr=False) as f:
            shape = f[edge_attr_dset_name].shape
            hint = None
            if node_feature_dset_name in f:
                nf_shape = f[node_feature_dset_name].shape
                if len(nf_shape) >= 1:
                    hint = int(nf_shape[0])
            layout = detect_pointcloud_layout(shape, num_residues_hint=hint)
            layouts.append(layout)
            sizes.append(min(shape[0], max_frames))
            r = int(shape[2] if layout == "n3r" else shape[1])
            if num_residues is None:
                num_residues = r
            elif r != num_residues:
                raise ValueError(
                    f"residue-count mismatch across directory files: "
                    f"{files[0]} has {num_residues}, {fp} has {r} — "
                    "refusing to concatenate incompatible trajectories"
                )

    total = int(sum(sizes))
    positions = np.empty((total, num_residues, 3), np.float32)
    edge_blocks: list = []
    counts_list: list = []
    rmsd_chunks: list = []
    node_features = None

    base = 0
    for i, fp in enumerate(files):
        n = sizes[i]
        with h5py.File(fp, "r", libver="latest", swmr=False) as f:
            dset = f[edge_attr_dset_name]
            for i0 in range(0, n, _POS_CHUNK):
                i1 = min(i0 + _POS_CHUNK, n)
                blk = np.asarray(dset[i0:i1])
                # Reference on-disk layout is (N, 3, R); reorder to
                # (N, R, 3) (dataset.py:159) contiguously in place. Files
                # already saved (N, R, 3) are detected in pass 1 and NOT
                # double-transposed.
                if layouts[i] == "n3r":
                    blk = np.transpose(blk, (0, 2, 1))
                positions[base + i0:base + i1] = blk
            blocks, counts = _read_edges_packed(
                f[edge_index_dset_name], n
            )
            check_edge_ranges(blocks, num_residues, file_label=str(fp))
            edge_blocks.extend(blocks)
            counts_list.append(counts)
            if "rmsd" in f:
                try:
                    rmsd_chunks.append(np.asarray(f["rmsd"][:n]))
                except Exception:
                    pass
            if i == 0 and node_feature_dset_path is None:
                if node_feature_dset_name in f:
                    node_features = np.asarray(f[node_feature_dset_name][...])
        base += n

    if node_feature_dset_path is not None:
        with h5py.File(node_feature_dset_path, "r") as nf:
            node_features = np.asarray(nf[node_feature_dset_name][...])

    if node_features is None:
        raise ValueError(
            f"node features dataset '{node_feature_dset_name}' not found"
        )

    edges_flat = (
        np.concatenate(edge_blocks, axis=1)
        if edge_blocks else np.zeros((2, 0), np.int32)
    )
    counts = (
        np.concatenate(counts_list) if counts_list else np.zeros(0, np.int64)
    )
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    rmsd = np.concatenate(rmsd_chunks) if rmsd_chunks else None

    return TrajectoryData(
        positions=positions,
        edge_indices=None,
        aminoacids=normalize_amino_labels(node_features),
        rmsd=None if rmsd is None else np.asarray(rmsd, np.float32),
        edges_flat=edges_flat,
        edge_offsets=offsets,
    )
