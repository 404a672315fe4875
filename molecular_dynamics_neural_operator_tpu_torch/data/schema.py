"""HDF5 schema detection, repair and rejection
(``molecular_dynamics_neural_operator_tpu/data/schema.py``).

The port's own copy, with the same rules, warnings and error messages, so
a file is accepted, repaired or refused alike by both packages'
``load_trajectory``:

- point clouds stored (N, R, 3) are detected per file and not transposed
  again (repair + warn);
- 1-based amino-acid labels in [1, 20] are shifted to 0-based (repair +
  warn); one-hot (R, 20) matrices are argmax'd back to labels (repair +
  warn); integral float labels are cast;
- a missing ``rmsd`` is accepted; float64 datasets are cast;
- odd-length ``contact_map`` rows, edge indices out of range and
  directories whose files disagree on the residue count are refused with
  ``ValueError``.
"""

from __future__ import annotations

import warnings

import numpy as np


class SchemaWarning(UserWarning):
    """A repairable deviation from the reference h5 schema was fixed."""


def detect_pointcloud_layout(shape, num_residues_hint=None) -> str:
    """Classify a ``point_cloud`` dataset shape as the reference's
    on-disk ``"n3r"`` (N, 3, R) or the already-row-major ``"nr3"``
    (N, R, 3).

    The reference loader unconditionally transposes; a file
    saved (N, R, 3) would come back as a 3-residue system with R-dim
    "coordinates". Disambiguation: exactly one of axes 1/2 equal to 3
    decides; if neither is 3, an ``num_residues_hint`` (e.g. from the
    amino-acids dataset length) can still identify the residue axis.
    A genuine 3-residue system (both axes 3) is UNDECIDABLE from shape
    alone — and the hint is 3 as well, matching both axes — so the
    reference layout is assumed with a SchemaWarning; a 3-residue
    (N, R, 3) file must be transposed by the caller.
    """
    if len(shape) != 3:
        raise ValueError(
            f"point_cloud must be 3-D (N, 3, R) or (N, R, 3); got {shape}"
        )
    _, a, b = shape
    if a == 3 and b == 3:
        warnings.warn(
            "point_cloud shape (N, 3, 3) is ambiguous — a 3-residue "
            "system cannot be told apart from the reference's (N, 3, R) "
            "layout by shape (the residue-count hint is 3 too); assuming "
            "the reference layout. A 3-residue file saved (N, R, 3) "
            "must be transposed before ingestion.",
            SchemaWarning, stacklevel=2,
        )
        return "n3r"
    if a == 3:
        return "n3r"
    if b == 3:
        warnings.warn(
            f"point_cloud shape {tuple(shape)} is (N, R, 3) — already "
            "row-major; skipping the reference's (N, 3, R) transpose "
            "(dataset.py:159)",
            SchemaWarning, stacklevel=2,
        )
        return "nr3"
    if num_residues_hint is not None:
        if a == num_residues_hint:
            return "nr3"
        if b == num_residues_hint:
            return "n3r"
    raise ValueError(
        f"point_cloud shape {tuple(shape)} has no axis of size 3 — not a "
        "coordinate trajectory in either (N, 3, R) or (N, R, 3) layout"
    )


def normalize_amino_labels(
    raw: np.ndarray, num_embeddings: int = 20
) -> np.ndarray:
    """Amino-acid labels -> 0-based int32 for the embedding table.

    Accepts: 0-based integer labels in [0, num_embeddings).
    Repairs (+ warn): 1-based labels in [1, num_embeddings] (the
    convention the reference's own one-hot helper assumes,
    ``dataset.py:12-18`` does ``labels - 1``, while its embedding path
    feeds the raw values, ``:162-164`` — with 1-based data that indexes
    out of the Embedding(20) table); float-dtype labels with integral
    values; one-hot (R, num_embeddings) matrices (argmax).
    Rejects: anything out of range or non-integral.
    """
    arr = np.asarray(raw)
    if arr.ndim == 2:
        if arr.shape[1] != num_embeddings:
            raise ValueError(
                f"2-D amino_acids must be one-hot (R, {num_embeddings}); "
                f"got {arr.shape}"
            )
        rows = arr.sum(axis=1)
        if not np.allclose(rows, 1.0):
            raise ValueError(
                "2-D amino_acids is not one-hot (row sums != 1); refusing "
                "to guess labels"
            )
        warnings.warn(
            f"amino_acids stored as one-hot {arr.shape}; recovering "
            "integer labels by argmax",
            SchemaWarning, stacklevel=2,
        )
        return arr.argmax(axis=1).astype(np.int32)
    if arr.ndim != 1:
        raise ValueError(f"amino_acids must be 1-D or one-hot; got {arr.shape}")
    if arr.dtype.kind == "f":
        if not np.all(arr == np.round(arr)):
            raise ValueError("amino_acids has non-integral float labels")
        arr = arr.astype(np.int64)
    lo, hi = (int(arr.min()), int(arr.max())) if arr.size else (0, 0)
    if lo >= 1 and hi == num_embeddings:
        warnings.warn(
            f"amino_acids labels span [{lo}, {hi}] — 1-based "
            "(dataset.py:12-18 convention); shifting to the 0-based "
            "embedding range",
            SchemaWarning, stacklevel=2,
        )
        arr = arr - 1
    elif arr.size and lo >= 1 and hi <= num_embeddings - 1:
        # Labels fit BOTH conventions (e.g. [1, 19]): a 1-based file that
        # happens to lack the last residue type would be read 0-based,
        # shifting every embedding index by one. Accept as 0-based (the
        # reference's embedding path feeds raw values, dataset.py:162-164)
        # but say so — silence here is an off-by-one nobody can see.
        warnings.warn(
            f"amino_acids labels span [{lo}, {hi}] — consistent with both "
            "the 0-based and 1-based conventions; assuming 0-based "
            "(reference embedding semantics). If this file is 1-based, "
            "pre-shift the labels by -1.",
            SchemaWarning, stacklevel=2,
        )
    elif lo < 0 or hi >= num_embeddings:
        raise ValueError(
            f"amino_acids labels span [{lo}, {hi}] — outside both the "
            f"0-based [0, {num_embeddings - 1}] and 1-based "
            f"[1, {num_embeddings}] conventions"
        )
    return arr.astype(np.int32)


def check_edge_ranges(
    blocks, num_residues: int, file_label: str = ""
) -> None:
    """Reject edge indices outside [0, num_residues) — on device these
    would silently clip-gather garbage rather than fault. ``blocks`` are
    the packed (2, total) int32 chunks from the reader."""
    for blk in blocks:
        if blk.size == 0:
            continue
        mx, mn = int(blk.max()), int(blk.min())
        if mn < 0 or mx >= num_residues:
            where = f" in {file_label}" if file_label else ""
            raise ValueError(
                f"contact_map edge indices span [{mn}, {mx}]{where} but "
                f"the trajectory has {num_residues} residues — corrupt "
                "edges or a mis-detected point_cloud layout"
            )


def contact_maps_have_self_loops(traj, probe_frames: int = 8) -> bool:
    """True when every probed frame's edge list contains all R self-loop
    edges (the reference's contact maps do: diagonal distance 0 < 8 Å,
    ``graph_kernel.py:363``). Files thresholded with ``i != j`` load fine
    (mean aggregation divides by real in-degree, floor 1) — this is a
    diagnostic so ingest can surface the difference, not a gate."""
    n = traj.num_frames
    if n == 0:
        return True
    idx = np.unique(np.linspace(0, n - 1, min(probe_frames, n)).astype(int))
    r = traj.num_residues
    for i in idx:
        e = traj.edge_index(int(i))
        if len(set(e[0][e[0] == e[1]].tolist())) < r:
            return False
    return True
