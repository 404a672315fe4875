"""Seeded FNO-3d weights, made on the device in two large draws.

The tree has the program's keys and shapes (``models/fno3d.py::
fno3d_init``): the lift (window_size + 3 -> width), ``depth`` spectral
layers (``w_real``, ``w_imag``, each (4, width, width, modes1, modes2,
modes3), one block a (k1, k2) corner) and pointwise layers (width ->
width), and the projection width -> projection -> 1. As
``fourier_3d.py`` draws them: each linear layer's weight and bias
uniform in +-1/sqrt(fan in), from one uniform draw on the card; the
spectral weights' real and imaginary parts 1/width^2 * U[0, 1), from a
second.
"""

from __future__ import annotations

import math

import torch

CORNERS = 4
GRID_CHANNELS = 3


def shapes(model: dict) -> dict:
    """{leaf path: (shape, bound)}; a bound of None is a spectral weight,
    U[0, 1) / width^2."""
    w = model["width"]
    out = {}

    def linear(name, i, o):
        b = 1.0 / math.sqrt(i)
        out[(name, "w")] = ((i, o), b)
        out[(name, "b")] = ((o,), b)

    linear("lift", model["window_size"] + GRID_CHANNELS, w)
    for d in range(model["depth"]):
        for part in ("w_real", "w_imag"):
            out[(f"spectral_{d}", part)] = (
                (CORNERS, w, w, model["modes1"], model["modes2"],
                 model["modes3"]), None)
        linear(f"pointwise_{d}", w, w)
    linear("proj1", w, model["projection"])
    linear("proj2", model["projection"], 1)
    return out


def make(model: dict, seed: int, device) -> dict:
    """The weight tree of ``model`` from ``seed``, f32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = shapes(model)
    sizes = {k: math.prod(s) for k, (s, _) in leaves.items()}
    flat = torch.rand(sum(n for k, n in sizes.items()
                          if leaves[k][1] is not None),
                      generator=gen, device=device) * 2.0 - 1.0
    spectral = torch.rand(sum(n for k, n in sizes.items()
                              if leaves[k][1] is None),
                          generator=gen, device=device)
    scale = 1.0 / (model["width"] ** 2)
    tree: dict = {}
    at = nat = 0
    for path, (shape, bound) in leaves.items():
        n = sizes[path]
        if bound is None:
            leaf = spectral[nat:nat + n].reshape(shape) * scale
            nat += n
        else:
            leaf = flat[at:at + n].reshape(shape) * bound
            at += n
        tree.setdefault(path[0], {})[path[1]] = leaf
    return tree
