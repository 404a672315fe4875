"""On-device contact graphs (``molecular_dynamics_neural_operator_tpu/geometry/contact.py``).

Edge convention: ``edges[..., 0, :]`` is the source j, ``edges[..., 1, :]``
the target i, and edge features are ``[pos_src ; pos_dst]``. Contact maps
keep self-loops (distance 0 passes the strict ``<`` test). Two graph
forms: a dense (R, R) adjacency with [source, target] axes and (R, R, 6)
all-pairs edge features, or a padded edge list. Every device function
takes any leading batch axes and none reads a value back to the host, so
a rollout loop over them never waits on the device;
``dense_to_padded_edges`` is the host-side (numpy) conversion.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def pairwise_sq_distances(pos: torch.Tensor) -> torch.Tensor:
    """pos (..., R, 3) -> (..., R, R), summed as (dx*dx + dy*dy) + dz*dz.

    The order is fixed (not a reduction whose order the backend picks) so
    the CUDA graph kernel, which computes the same three products and two
    sums with round-to-nearest intrinsics, gives the same bits."""
    d = pos[..., :, None, :] - pos[..., None, :, :]
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def pairwise_distances(pos: torch.Tensor) -> torch.Tensor:
    """Euclidean distances (..., R, R), the square root of the squared
    distances clamped at 0."""
    return torch.sqrt(torch.clamp(pairwise_sq_distances(pos), min=0.0))


def contact_map(pos: torch.Tensor, threshold: float = 8.0) -> torch.Tensor:
    """d(i, j) < threshold as f32 0/1, (..., R, R), self-loops kept."""
    return (pairwise_sq_distances(pos) < threshold * threshold).float()


def degree_from_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """In-degree of each target i, the sum over the source axis (-2) of a
    [source, target] adjacency, clamped to at least 1: (..., R)."""
    return torch.clamp(torch.sum(adj, dim=-2), min=1.0)


def dense_edge_features(pos: torch.Tensor) -> torch.Tensor:
    """All-pairs edge features E[j, i] = [pos_j ; pos_i]: pos (..., R, 3) ->
    (..., R, R, 6), the source axis first."""
    r = pos.shape[-2]
    shape = pos.shape[:-2] + (r, r, 3)
    src = pos[..., :, None, :].expand(shape)
    dst = pos[..., None, :, :].expand(shape)
    return torch.cat([src, dst], dim=-1)


def contact_map_from_edges(edges: torch.Tensor, mask: torch.Tensor,
                           num_nodes: int) -> torch.Tensor:
    """Padded edge list -> 0/1 adjacency (..., R, R) f32 [source, target]:
    edges (..., 2, E) int, mask (..., E). Padded slots (mask 0) add
    nothing; a repeated edge still reads 1."""
    lead = edges.shape[:-2]
    e = edges.shape[-1]
    n = math.prod(lead)
    src = edges[..., 0, :].reshape(n, e).long()
    dst = edges[..., 1, :].reshape(n, e).long()
    owner = torch.arange(n, device=edges.device)[:, None].expand(n, e)
    adj = torch.zeros(n, num_nodes, num_nodes, device=edges.device)
    adj.index_put_((owner, src, dst), mask.reshape(n, e).float(),
                   accumulate=True)
    return torch.clamp(adj, max=1.0).reshape(lead + (num_nodes, num_nodes))


def dense_to_padded_edges(adj, max_edges: int):
    """Host-side (numpy): adjacency (R, R) -> (edges (2, max_edges) int32,
    mask (max_edges,) f32) in row-major (source, target) order, padded
    with src = dst = 0 and mask 0. Raises ``ValueError`` past
    ``max_edges`` real edges."""
    adj = np.asarray(adj)
    src, dst = np.nonzero(adj)
    e = src.shape[0]
    if e > max_edges:
        raise ValueError(f"edge count {e} exceeds max_edges {max_edges}")
    edges = np.zeros((2, max_edges), np.int32)
    mask = np.zeros((max_edges,), np.float32)
    edges[0, :e] = src
    edges[1, :e] = dst
    mask[:e] = 1.0
    return edges, mask


def padded_edges_device(adj: torch.Tensor, max_edges: int,
                        return_count: bool = False):
    """Padded edge list from a dense adjacency, in row-major order.

    Returns edges (..., 2, max_edges) int32, mask (..., max_edges) f32 and,
    with ``return_count``, the true edge count (..., ) int64. Slots past
    the count hold src = dst = 0 with mask 0; edges past ``max_edges`` are
    dropped and the count says so. All index work is integer: the e-th set
    bit is the first position whose inclusive running count reaches e.
    """
    r = adj.shape[-1]
    lead = adj.shape[:-2]
    flat = (adj.reshape(lead + (r * r,)) > 0).to(torch.int64)
    rank = torch.cumsum(flat, dim=-1)
    count = rank[..., -1]
    slots = torch.arange(1, max_edges + 1, device=adj.device)
    slots = slots.expand(lead + (max_edges,)).contiguous()
    pair = torch.searchsorted(rank, slots)
    valid = slots <= count[..., None]
    pair = torch.where(valid, pair, torch.zeros_like(pair))
    edges = torch.stack([pair // r, pair % r], dim=-2).to(torch.int32)
    mask = valid.float()
    if return_count:
        return edges, mask, count
    return edges, mask


def edge_features_from_edges(pos: torch.Tensor,
                             edges: torch.Tensor) -> torch.Tensor:
    """[pos_src ; pos_dst] per edge: pos (..., R, 3), edges (..., 2, E) ->
    (..., E, 6)."""
    def gather(idx):
        return torch.take_along_dim(pos, idx.long()[..., None], dim=-2)

    return torch.cat([gather(edges[..., 0, :]), gather(edges[..., 1, :])],
                     dim=-1)
