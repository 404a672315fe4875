"""Random-walk input noise for rollout robustness
(``molecular_dynamics_neural_operator_tpu/train/noise.py``).

The training inputs are corrupted with accumulated coordinate noise while
the targets stay clean, so the model learns to pull slightly
off-distribution states, which its own rollout produces, back. The
increments are i.i.d. N(0, (noise_std / sqrt(T))^2) and summed over the
frame axis, so the last frame carries std ``noise_std`` and earlier frames
proportionally less.

The noise is a pure function of ``(seed, step)``: the generator is seeded
anew from both for every step, nothing in the train state advances, and a
step is reproducible. The values differ from the JAX package's (another
generator); the structure does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, step)``."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(mixed[0]) << 31 ^ int(mixed[1]))
    return gen


def noise_increments(seed: int, step: int, shape, device,
                     dtype=torch.float32,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """The walk's N(0, 1) increments of train step ``step``: ``shape``
    draws from the generator of ``(seed, step)``, written into ``out``
    when given. One launch on the card; a step that replays a CUDA graph
    draws them into the graph's input buffer before the replay."""
    gen = step_generator(seed, step, device)
    if out is None:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
    return out.normal_(generator=gen)


def random_walk(eps: torch.Tensor, noise_std: float) -> torch.Tensor:
    """Accumulated noise from the increments eps (..., T, R, 3): the walk
    runs over axis -3, the frame axis."""
    t = eps.shape[-3]
    return torch.cumsum(eps * (noise_std / math.sqrt(t)), dim=-3)


def window_random_walk_noise(gen: torch.Generator, shape, noise_std: float,
                             dtype=None, device=None):
    """Accumulated coordinate noise of ``shape`` (..., T, R, 3): the walk
    runs over axis -3, the frame axis."""
    eps = torch.randn(tuple(shape), generator=gen,
                      dtype=dtype or torch.float32,
                      device=device if device is not None else gen.device)
    return random_walk(eps, noise_std)


def noised_window(window: torch.Tensor, seed: int, step: int,
                  noise_std: float):
    """Corrupt a window batch deterministically for train step ``step``.
    ``noise_std <= 0`` returns the window untouched."""
    if noise_std <= 0.0:
        return window
    return window + random_walk(
        noise_increments(seed, step, window.shape, window.device,
                         window.dtype), noise_std)
