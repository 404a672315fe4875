"""Edge-sharded rollout: one stream too large for one card
(``molecular_dynamics_neural_operator_tpu/parallel/rollout_edge_sharded.py``).

``parallel/rollout_sharded.py`` spreads independent streams over "data";
this spreads ONE large-system stream over "model". Every step:

1. the rebuild. On the ``cell_list`` path only the cell table (one sort
   and one scatter) is built whole on every rank; the per-atom phase
   (candidate gather, distance test, the first ``max_degree`` hits) runs
   for the rank's own atom slice (``geometry/cells.py``'s
   ``atom_slice``), whose edge slots are exactly the rank's edge shard
   under the block layout, so the rebuild needs no traffic. Otherwise
   (the ranked rebuild, or atoms that do not divide over the axis) the
   whole graph is rebuilt on every rank and each takes its edge slice.
2. the edge MLP and the conv messages on local edges only, the partial
   aggregates and the degrees all-reduced over "model"
   (``edge_sharded.py``);
3. the predicted frame is the same on every rank; the window slides
   there with no further traffic.

The overflow flags are reduced by MAX over "model" at the end.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.geometry.cells import (
    cell_list_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    edge_features_from_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel import comm
from molecular_dynamics_neural_operator_tpu_torch.parallel.edge_sharded import (  # noqa: E501
    _forward_edge_shard,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    mesh_device,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    _build_graph,
)


def make_edge_sharded_rollout_fn(
    cfg: ModelConfig,
    mesh,
    num_steps: int,
    threshold: float = 8.0,
    clip: float | None = None,
    model_axis: str = "model",
):
    """``fn(params, aa, window0)`` rolling one stream, window0 (T, N, 3),
    with the edge axis of every rebuilt graph over ``model_axis``.
    Returns (coords (num_steps, N, 3), final window, {"edge_overflow": 0-d
    bool}), the same on every rank."""
    n_shards = axis_size(mesh, model_axis)
    if cfg.graph_mode != "sparse":
        raise ValueError(
            "edge-sharded rollout requires graph_mode='sparse' "
            f"(got {cfg.graph_mode!r})")
    if cfg.max_edges % n_shards:
        raise ValueError(
            f"max_edges {cfg.max_edges} must divide by the '{model_axis}' "
            f"axis size {n_shards}")
    local_e = cfg.max_edges // n_shards
    shard = axis_index(mesh, model_axis)
    group = mesh.get_group(model_axis)
    dev = mesh_device(mesh)

    @torch.no_grad()
    def fn(params, aa, window0):
        window = torch.as_tensor(window0, dtype=torch.float32, device=dev)
        aa = torch.as_tensor(aa, device=dev)
        n_atoms = window.shape[1]
        cell_list = cfg.neighbor_impl == "cell_list"
        if cell_list and cfg.max_edges != n_atoms * cfg.max_degree:
            # the cell list emits n_atoms * max_degree slots: shards cut
            # by max_edges would overlap or drop some
            raise ValueError(
                f"edge-sharded cell-list rollout requires max_edges == "
                f"num_atoms * max_degree (got {cfg.max_edges} != "
                f"{n_atoms} * {cfg.max_degree})")
        shard_rebuild = cell_list and n_atoms % n_shards == 0
        n_local = n_atoms // n_shards
        lo = shard * local_e
        overflowed = torch.zeros((), dtype=torch.bool, device=dev)
        coords = []
        for _ in range(num_steps):
            frame = window[-1]
            if shard_rebuild:
                out_cl = cell_list_edges(
                    frame, threshold, cfg.max_degree, cfg.cell_capacity,
                    cfg.num_cells, atom_slice=(shard * n_local, n_local))
                edges, mask = out_cl.edges, out_cl.mask
                ef = edge_features_from_edges(frame, edges)
                overflow = out_cl.cell_overflow | out_cl.degree_overflow
                blocked_offset = shard * n_local
            else:
                graph, overflow = _build_graph(cfg, frame, threshold)
                edges = graph.edges[:, lo:lo + local_e]
                mask = graph.mask[lo:lo + local_e]
                ef = graph.edge_feats[lo:lo + local_e]
                blocked_offset = None
            out = _forward_edge_shard(params, cfg, aa, window, edges, mask,
                                      ef, group,
                                      blocked_offset=blocked_offset)
            if clip is not None:
                out = torch.clamp(out, -clip, clip)
            window = torch.cat([window[1:], out[None]], dim=0)
            overflowed = overflowed | overflow
            coords.append(out)
        ov = comm.all_reduce(overflowed.to(torch.int32), group,
                             dist.ReduceOp.MAX) > 0
        return torch.stack(coords), window, {"edge_overflow": ov}

    return fn
