"""Host -> device batch staging (``molecular_dynamics_neural_operator_tpu/data/prefetch.py``).

Each host batch (a dict of numpy arrays) is copied into pinned host memory
and sent to the device with a non-blocking copy, so the transfer of batch
n+1 overlaps the compute of batch n. ``size`` batches are staged ahead. A
plain generator: no producer thread yet.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import torch


def to_device(batch: dict, device) -> dict:
    """Every array of ``batch`` as a tensor on ``device``."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(batches: Iterable[dict], size: int = 2,
                       put: Optional[Callable] = None,
                       device="cuda") -> Iterator[dict]:
    """Iterate ``batches`` with up to ``size`` (at least 1) of them staged
    on the device ahead of the consumer. ``put`` maps a host batch to
    device tensors; the default is ``to_device(batch, device)``."""
    put = put or (lambda b: to_device(b, device))
    staged: collections.deque = collections.deque()
    for batch in batches:
        staged.append(put(batch))
        if len(staged) > max(1, size):
            yield staged.popleft()
    while staged:
        yield staged.popleft()
