"""Back-to-back calls of ``steps_per_call`` steps, each from a start
window of ``streams`` streams; ``pool`` windows are drawn and used in
turn."""

from __future__ import annotations

import numpy as np


def make(mix: dict, model: dict, starts, rng, seconds: float) -> dict:
    s = mix.get("streams", 1)
    return {"windows": np.stack([np.stack([starts.draw() for _ in range(s)])
                                 for _ in range(mix["pool"])]),
            "steps_per_call": mix["steps_per_call"]}
