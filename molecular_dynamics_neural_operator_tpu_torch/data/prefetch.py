"""Host -> device batch staging with a producer thread
(``molecular_dynamics_neural_operator_tpu/data/prefetch.py``).

A background thread assembles the next host batches (the dataset's numpy
path or its native packer, which runs without the GIL) and copies them
into page-locked host memory, up to ``size`` batches ahead. The consumer
takes each staged batch and sends it to the device with a non-blocking
copy on the consumer's own current stream, just before handing it out.

Why the copy stays on the consumer's stream: the batch's device memory
is then allocated and first used on one stream, so stream order alone
puts the copy before every kernel that reads it, with no event to wait
on and no ``record_stream`` for the caching allocator. The pinned source
buffer is safe as well: PyTorch records the copy's stream on it and does
not hand it out again before the copy is done. A batch is about a
megabyte at the flagship's shapes, so what the thread takes off the
consumer is the host work (assembly and pinning), not the transfer.

Spans (``utils/profiling.py``): ``train.produce`` on the producer thread,
a batch assembled and pinned; ``train.wait_batch``, the consumer's wait
for a staged batch (not for the end of the batches); ``train.put``, its
copy to the device.

The producer's exception is re-raised at the consumer. A consumer that
stops early (``break``, an exception, closing the generator) stops the
producer and joins it: the producer finishes the batch it is assembling
and no thread is left behind. ``producer_thread=False`` is the plain
generator of the same staging, for comparison.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import torch

from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import span

_DONE = object()
_POLL_S = 0.05


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def pin(batch: dict, device) -> dict:
    """Every array of ``batch`` as a host tensor, page-locked when it is
    bound for a CUDA device."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if on_card and t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        out[k] = t
    return out


def to_device(batch: dict, device) -> dict:
    """Every array of ``batch`` as a tensor on ``device`` (a non-blocking
    copy from page-locked memory on the current stream for a card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {k: torch.as_tensor(v) for k, v in batch.items()}
    return {k: t.to(dev, non_blocking=True)
            for k, t in pin(batch, dev).items()}


def prefetch_to_device(batches: Iterable[dict], size: int = 2,
                       put: Optional[Callable] = None, device="cuda",
                       producer_thread: bool = True) -> Iterator[dict]:
    """Iterate ``batches`` with up to ``size`` (at least 1) of them staged
    ahead of the consumer. ``put`` maps a staged batch to device tensors
    in the consumer's thread; the default is ``to_device(batch,
    device)``."""
    put = put or (lambda b: to_device(b, device))
    size = max(1, size)
    if not producer_thread:
        staged: collections.deque = collections.deque()
        for batch in batches:
            with span("train.put"):
                staged.append(put(batch))
            if len(staged) > size:
                yield staged.popleft()
        while staged:
            yield staged.popleft()
        return

    # queue.Queue(maxsize=0) would be unbounded: hence the floor of 1
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        source = iter(batches)
        try:
            while True:
                with span("train.produce"):
                    batch = next(source, _DONE)
                    staged = batch if batch is _DONE else pin(batch, device)
                if staged is _DONE:
                    break
                if not offer(staged):
                    return
        except BaseException as exc:  # noqa: BLE001: re-raised by the consumer
            offer(_Failure(exc))
            return
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()
        offer(_DONE)

    thread = threading.Thread(target=producer, name="prefetch_to_device",
                              daemon=True)
    thread.start()
    try:
        while True:
            with span("train.wait_batch") as waiting:
                item = q.get()
                if item is _DONE:
                    waiting.discard()
            if item is _DONE:
                break
            if isinstance(item, _Failure):
                raise item.exc
            with span("train.put"):
                batch = put(item)
            yield batch
    finally:
        stop.set()
        thread.join()
