"""Training on the start source's whole trajectory: every window of
``window_size`` frames with its next frame, the rows in an order drawn
from the seed; the first ``check.steps`` batches are the steps the
reference follows."""

from __future__ import annotations

from portbench.traffic import sources


def make(mix: dict, model: dict, starts, rng, seconds: float) -> dict:
    frames = starts.frames
    return {"positions": frames,
            "contacts": sources.chain_contacts(frames, model["threshold"]),
            "rows": rng.permutation(frames.shape[0] - model["window_size"])}
