"""T consecutive frames of the breathing chain
(``sources.chain_trajectory``, its own fixed seed ``chain_seed``, of
``num_frames`` frames; the sequence is the chain's), at a frame drawn
from the seed."""

from __future__ import annotations

from portbench.traffic import sources


class Source:
    def __init__(self, spec: dict, model: dict, rng):
        self.rng, self.t = rng, model["window_size"]
        self.frames, self.aa = sources.chain_trajectory(
            spec["num_frames"], model["num_residues"], spec["chain_seed"])

    def draw(self):
        i = int(self.rng.integers(0, self.frames.shape[0] - self.t + 1))
        return self.frames[i:i + self.t]
