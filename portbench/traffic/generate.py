"""The one traffic generator: a mix file's parameters and a seed in, the
inputs of a run out. Every seed gets the same sizes and, for an open
loop, the same set of gaps and lengths in another order, so the seed
changes which frames start each call and in what order the work comes,
not how much work there is.

A mix names its kind (``kind``) and its start windows' source
(``start.source``); each is a file of its own, found by that name:

- ``kinds/<kind>.py`` has ``make(mix, model, starts, rng, seconds)``,
  which returns the run's inputs of that kind (``calls``, ``epochs``,
  ``open_loop``);
- ``starts/<source>.py`` has a class ``Source(spec, model, rng)`` with
  the amino acids ``aa`` (R,), ``draw()``, a start window (T, R, 3), and,
  where the source is one trajectory, its ``frames`` (``chain``,
  ``breathing_grid``).

A new kind or source is a new file beside these; no file here changes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def seeds(seed: int, n: int = 4) -> list:
    """n independent 63-bit seeds from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s) & (2 ** 63 - 1) for s in state]


def load(folder: str, name: str):
    """The module ``<folder>/<name>.py`` beside this file."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise ValueError(f"no traffic {folder} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.traffic.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make(mix: dict, model: dict, seed: int, seconds: float) -> dict:
    rng = np.random.default_rng(seeds(seed)[1])
    starts = load("starts", mix["start"]["source"]).Source(
        mix["start"], model, rng)
    out = {"aa": starts.aa}
    out.update(load("kinds", mix["kind"]).make(mix, model, starts, rng,
                                               seconds))
    return out
