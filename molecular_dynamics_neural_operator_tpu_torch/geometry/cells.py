"""Cell-list neighbour search for large systems
(``molecular_dynamics_neural_operator_tpu/geometry/cells.py``).

The contact map of ``geometry/contact.py`` ranks a dense (R, R) adjacency:
exact and quick for proteins, quadratic past about a thousand nodes. This
is the O(N) rebuild of the ~10k-atom configuration, with static shapes:

1. hash each atom's cell, floor(pos / cutoff), into a power-of-two table
   (xor of prime products; a collision only adds candidates);
2. build the (num_cells, cell_capacity) atom table with one stable sort
   and one scatter;
3. per atom, gather the candidates of the 27 neighbouring cells, keep
   those under the cutoff, and take the first ``max_degree`` of them;
4. emit a padded edge list (2, N * max_degree) and its mask, the block
   layout: slot n*max_degree + d is the d-th edge into atom n (src = the
   neighbour, dst = n).

Overflow is data, not an exception: ``cell_overflow`` (a cell held more
atoms than its capacity, so candidates were dropped) and
``degree_overflow`` (an atom had more neighbours than ``max_degree``).
Self-loops are kept, as in the contact map.

Every function takes leading batch axes on ``pos`` (..., N, 3), which the
JAX package gets from ``vmap``: one sort over the keys b * num_cells + h
builds every example's table at once, and the flags come back per
example, shape (...). The sort is stable, as ``jnp.argsort`` is, so the
order inside a cell's run, and with it which atoms a full cell drops and
which first ``max_degree`` hits are kept, is the JAX package's. The hash
is computed in int64 and masked to the table: its low bits are those of
the int32 products that wrap in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import span

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # spatial-hash primes


class CellListEdges(NamedTuple):
    edges: torch.Tensor            # (..., 2, N * max_degree) int32 [src; dst]
    mask: torch.Tensor             # (..., N * max_degree) f32
    cell_overflow: torch.Tensor    # (...) bool
    degree_overflow: torch.Tensor  # (...) bool


def _hash_cells(cid: torch.Tensor, num_cells: int) -> torch.Tensor:
    """cid (..., 3) integer cell coordinates -> (...,) int64 table index."""
    c = cid.long()
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return h & (num_cells - 1)


def _neighbor_offsets(device=None) -> torch.Tensor:
    """The 27 cell offsets (27, 3) int64, x major, as ``meshgrid(ij)``."""
    g = torch.arange(-1, 2, device=device)
    ox, oy, oz = torch.meshgrid(g, g, g, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1), oz.reshape(-1)],
                       dim=-1)


def build_cell_table(pos: torch.Tensor, cutoff: float, cell_capacity: int,
                     num_cells: int):
    """Phase 1 of the rebuild, the atom table. pos (..., N, 3) ->
    (cid (..., N, 3) int64, table (..., num_cells * cell_capacity) int64
    holding atom indices or -1, cell_overflow (...) bool)."""
    if num_cells <= 0 or num_cells & (num_cells - 1):
        raise ValueError(f"num_cells must be a power of 2, got {num_cells}")
    lead, n = pos.shape[:-2], pos.shape[-2]
    b = math.prod(lead)
    cid = torch.floor(pos / cutoff).to(torch.int32).long()   # (..., N, 3)
    h = _hash_cells(cid, num_cells).reshape(b, n)
    example = torch.arange(b, device=pos.device)[:, None]
    key = (example * num_cells + h).reshape(-1)               # (B*N,)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    first = torch.searchsorted(key_sorted, key_sorted, side="left")
    rank = torch.arange(b * n, device=pos.device) - first     # in the run
    in_cap = rank < cell_capacity
    # example-major keys: sorted position p belongs to example p // N
    cell_overflow = (~in_cap).reshape(b, n).any(dim=1).reshape(lead)
    # atoms past a full cell go to one extra slot that is cut off after
    # the scatter (the JAX package's mode="drop"): no host read of a mask
    size = b * num_cells * cell_capacity
    slots = torch.where(in_cap, key_sorted * cell_capacity + rank, size)
    table = torch.full((size + 1,), -1, dtype=torch.int64, device=pos.device)
    table[slots] = order % n
    return cid, table[:size].reshape(lead + (num_cells * cell_capacity,)), \
        cell_overflow


def cell_list_edges(pos: torch.Tensor, cutoff: float = 8.0,
                    max_degree: int = 32, cell_capacity: int = 16,
                    num_cells: int = 4096,
                    atom_slice: Optional[tuple[int, int]] = None,
                    ) -> CellListEdges:
    """Padded neighbour-list edges of N atoms in O(N): pos (..., N, 3) ->
    ``CellListEdges`` with E = N * max_degree slots in the block layout.

    ``atom_slice=(lo, n_local)`` runs the per-atom phase for atoms
    [lo, lo + n_local) only: the result is slots [lo * max_degree,
    (lo + n_local) * max_degree) of the full edge list (dst indices stay
    global), and ``degree_overflow`` covers those atoms alone. The span
    ``geometry.cell_list``."""
    with span("geometry.cell_list"):
        return _cell_list_edges(pos, cutoff, max_degree, cell_capacity,
                                num_cells, atom_slice)


def _cell_list_edges(pos, cutoff, max_degree, cell_capacity, num_cells,
                     atom_slice) -> CellListEdges:
    lead, n = pos.shape[:-2], pos.shape[-2]
    b = math.prod(lead)
    cap = cell_capacity
    c_total = 27 * cap
    if max_degree > c_total:
        raise ValueError(f"max_degree {max_degree} exceeds the "
                         f"{c_total} candidates of 27 cells of capacity "
                         f"{cap}")
    cid, table, cell_overflow = build_cell_table(pos, cutoff, cap,
                                                 num_cells)
    flat = pos.reshape(b, n, 3)
    cid = cid.reshape(b, n, 3)
    lo = 0
    if atom_slice is not None:
        lo, n_local = atom_slice
        cid = cid[:, lo:lo + n_local]
        n = n_local
    own = flat[:, lo:lo + n]

    # candidates: 27 cells x capacity per atom, gathered a whole table row
    # (a bucket) at a time
    nbr_hash = _hash_cells(cid[:, :, None, :]
                           + _neighbor_offsets(pos.device), num_cells)
    # two offsets that hash to one bucket would repeat its atoms: keep the
    # first offset of each bucket
    later = torch.ones(27, 27, dtype=torch.bool,
                       device=pos.device).tril(diagonal=-1)
    bucket_dup = ((nbr_hash[..., :, None] == nbr_hash[..., None, :])
                  & later).any(dim=-1)                        # (B, n, 27)
    table2 = table.reshape(b, num_cells, cap)
    ex = torch.arange(b, device=pos.device)[:, None, None]
    table_pos = flat[ex, table2.clamp(min=0)]           # (B, cells, C, 3)
    cand = table2[ex, nbr_hash].reshape(b, n, c_total)
    cand_pos = table_pos[ex, nbr_hash].reshape(b, n, c_total, 3)
    bucket_ok = (~bucket_dup).repeat_interleave(cap, dim=2)

    # distances summed in a fixed order, so the card and the CPU agree
    d = cand_pos - own[:, :, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    valid = (cand >= 0) & bucket_ok & (d2 < cutoff * cutoff)
    degree_overflow = (valid.sum(dim=2) > max_degree).any(dim=1)

    # the first max_degree hits of each row, by a positional score
    score = torch.where(valid, c_total - torch.arange(c_total,
                                                      device=pos.device), 0)
    top_idx = torch.topk(score, max_degree, dim=2).indices    # (B, n, D)
    top_valid = torch.gather(valid, 2, top_idx)
    top_cand = torch.gather(cand, 2, top_idx)
    src = torch.where(top_valid, top_cand, 0)
    rows = lo + torch.arange(n, device=pos.device)[None, :, None]
    dst = torch.where(top_valid, rows, 0)
    e = n * max_degree
    edges = torch.stack([src.reshape(b, e), dst.reshape(b, e)],
                        dim=1).to(torch.int32)
    return CellListEdges(
        edges=edges.reshape(lead + (2, e)),
        mask=top_valid.float().reshape(lead + (e,)),
        cell_overflow=cell_overflow,
        degree_overflow=degree_overflow.reshape(lead),
    )
