"""Stream-sharded autoregressive rollout
(``molecular_dynamics_neural_operator_tpu/parallel/rollout_sharded.py``).

Independent rollout streams shard over the mesh's "data" axis: each rank
runs ``rollout_scan`` (forward and graph rebuild from its own
predictions) on its own streams, with no traffic between ranks until the
one reduction of the overflow flag at the end. With
``conv_impl="pallas"`` every rank's streams run the fused kernel
(``ops/cuda/fused_gkn.py``). ``stream_chunk`` runs a rank's streams in
sequential chunks, as ``make_rollout_fn`` does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.parallel import comm
from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    mesh_device,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    rollout_scan_chunked,
)


def make_sharded_rollout_fn(
    cfg: ModelConfig,
    mesh,
    num_steps: int,
    threshold: float = 8.0,
    graph_frame: str = "last",
    collect: str = "coords",
    clip: float | None = None,
    stream_chunk: int | None = None,
    data_axis: str = "data",
):
    """``fn(params, aa, window0)`` with the GLOBAL window0 (S, T, R, 3),
    S divisible by the "data" axis size, and aa (R,). Returns this rank's
    part, as the JAX package's outputs stay sharded: (collected
    (S / n, num_steps, ...), final windows (S / n, T, R, 3), {"edge_overflow":
    a 0-d bool, True where any stream of any rank overflowed}).
    ``gather_streams`` assembles the global arrays for a caller that wants
    them."""
    n = axis_size(mesh, data_axis)
    index = axis_index(mesh, data_axis)
    group = mesh.get_group(data_axis)
    dev = mesh_device(mesh)

    def fn(params, aa, window0):
        window0 = torch.as_tensor(window0, dtype=torch.float32)
        s = window0.shape[0]
        if s % n:
            raise ValueError(f"stream count {s} not divisible by the "
                             f"'{data_axis}' axis size {n}")
        local = s // n
        if stream_chunk is not None and local % stream_chunk:
            raise ValueError(f"local stream count {local} not divisible by "
                             f"stream_chunk {stream_chunk}")
        collected, final_w, diags = rollout_scan_chunked(
            params, cfg, torch.as_tensor(aa, device=dev),
            window0[index * local:(index + 1) * local].to(dev), num_steps,
            stream_chunk, threshold, graph_frame, collect, clip)
        overflow = comm.all_reduce(
            diags["edge_overflow"].any().to(torch.int32), group,
            dist.ReduceOp.MAX) > 0
        return collected, final_w, {"edge_overflow": overflow}

    return fn


def gather_streams(mesh, local, data_axis: str = "data"):
    """The global arrays of a stream-sharded result: a tensor, or a tuple
    of them (``collect="both"``), whose first axis is this rank's
    streams, concatenated over the "data" axis in stream order."""
    group = mesh.get_group(data_axis)
    if isinstance(local, tuple):
        return tuple(comm.all_gather(t, group) for t in local)
    return comm.all_gather(local, group)
