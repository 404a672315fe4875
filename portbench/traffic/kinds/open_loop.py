"""``rate_per_s`` requests a second for the run's seconds: gaps at the
quantiles of the exponential distribution (Poisson arrivals), lengths at
the quantiles of the log-uniform distribution on [``length_min``,
``length_max``], both permuted by the seed; a start window each."""

from __future__ import annotations

import math

import numpy as np


def make(mix: dict, model: dict, starts, rng, seconds: float) -> dict:
    n = max(1, int(round(mix["rate_per_s"] * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / mix["rate_per_s"]
    lo, hi = math.log(mix["length_min"]), math.log(mix["length_max"])
    lengths = np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)
    return {"due": np.cumsum(rng.permutation(gaps)),
            "lengths": rng.permutation(lengths),
            "windows": np.stack([starts.draw() for _ in range(n)])}
