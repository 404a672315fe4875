"""Tracing and throughput metering (``molecular_dynamics_neural_operator_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` capture of the block (host and,
  on the card, CUDA activity), written into ``logdir`` as a Chrome trace
  (``trace.json``, viewable in Perfetto or ``chrome://tracing``).
- ``annotate(name)``: a named region in that trace
  (``torch.profiler.record_function``).
- ``StepTimer``: streaming steps/s and examples/s with warm-up discard.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Streaming throughput meter.

    >>> timer = StepTimer(warmup=2)
    >>> for batch in loader:
    ...     step(...)
    ...     timer.tick(examples=batch_size)
    >>> timer.steps_per_sec, timer.examples_per_sec
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.reset()

    def reset(self):
        self._count = 0
        self._examples = 0
        self._t0: Optional[float] = None
        self._last = None

    def tick(self, examples: int = 0) -> None:
        now = time.perf_counter()
        self._count += 1
        self._last = now
        if self._count == self.warmup:
            self._t0 = now
            self._examples = 0
        elif self._count > self.warmup:
            self._examples += examples

    def stop(self) -> None:
        """Mark the true end of the measured region. Call AFTER forcing
        device completion (a value read) — ticks fire at dispatch time,
        so without this the meter reports async dispatch rate, not
        throughput."""
        self._last = time.perf_counter()

    @property
    def measured_steps(self) -> int:
        return max(0, self._count - self.warmup)

    @property
    def elapsed(self) -> float:
        if self._t0 is None or self._last is None:
            return 0.0
        return self._last - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.measured_steps / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def examples_per_sec(self) -> float:
        return self._examples / self.elapsed if self.elapsed > 0 else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.measured_steps,
            "seconds": self.elapsed,
            "steps_per_sec": self.steps_per_sec,
            "examples_per_sec": self.examples_per_sec,
        }
