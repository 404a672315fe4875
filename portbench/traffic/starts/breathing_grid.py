"""A fresh breathing of the serpentine grid (``spacing`` apart;
``amplitude``, ``dt``) for each window, from a seed drawn from the run's;
amino acids drawn from the seed."""

from __future__ import annotations

import numpy as np

from portbench.traffic import sources


class Source:
    def __init__(self, spec: dict, model: dict, rng):
        self.spec, self.rng, self.t = spec, rng, model["window_size"]
        self.base = sources.serpentine_grid(model["num_residues"],
                                            spec["spacing"])
        self.aa = rng.integers(0, 20, model["num_residues"]).astype(np.int32)

    def draw(self):
        return sources.breathing_trajectory(
            self.base, self.t, int(self.rng.integers(0, 2 ** 31)),
            self.spec.get("amplitude", 0.35), self.spec.get("dt", 0.02))
