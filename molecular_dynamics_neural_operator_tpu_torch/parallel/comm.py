"""The collectives of the parallel modules, on ``torch.distributed``.

Each function takes a process group (a mesh axis: ``mesh.get_group(
"data")``) and returns new tensors; none changes its argument. On a group
of one rank nothing is sent. Gloo reduces host memory, so a CUDA tensor
on a gloo group is copied to the host, reduced there and copied back: two
ranks that share one card run gloo (NCCL refuses two ranks on one GPU),
and that traffic through the host is the cost of sharing it. NCCL takes
device tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return dist.get_world_size(group)


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _buffer(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` where the backend reads it."""
    if _via_host(t, group):
        return t.detach().to("cpu", copy=True).contiguous()
    return t.detach().clone().contiguous()


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced by ``op`` over ``group``, on ``t``'s device."""
    if size(group) == 1:
        return t
    buf = _buffer(t, group)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along dim 0 in the
    group's rank order."""
    if size(group) == 1:
        return t
    buf = _buffer(t, group)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(t.device)


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Global rank ``src``'s ``t``; the other ranks pass a tensor of the
    same shape and dtype to receive into."""
    if size(group) == 1:
        return t
    buf = _buffer(t, group)
    dist.broadcast(buf, src=src, group=group)
    return buf.to(t.device)
