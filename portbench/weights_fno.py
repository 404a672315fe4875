"""Seeded FNO-2d weights, made on the device in two large draws.

The tree has the program's keys and shapes (``models/fno.py::fno_init``):
the lift (in_channels -> width), ``depth`` spectral layers (``w_real``,
``w_imag``, each (width, width, modes1, modes2)) and pointwise layers
(width -> width), and the projection width -> 128 -> out_channels. Each
linear layer's weight and bias are uniform in +-1/sqrt(fan in), from one
uniform draw on the card; the spectral weights' real and imaginary parts
are (1/width^2) N(0, 1), as ``fno_init`` draws them, from one normal
draw. The head is scaled by the model's ``head_scale``, not here.
"""

from __future__ import annotations

import math

import torch

PROJECTION = 128      # the projection's hidden width (``fno_init``)


def shapes(model: dict) -> dict:
    """{leaf path: (shape, bound)}; a bound of None is the spectral
    weights' normal draw, scaled by 1/width^2."""
    w = model["width"]
    out = {}

    def linear(name, i, o):
        b = 1.0 / math.sqrt(i)
        out[(name, "w")] = ((i, o), b)
        out[(name, "b")] = ((o,), b)

    linear("lift", model["in_channels"], w)
    linear("proj1", w, PROJECTION)
    linear("proj2", PROJECTION, model["out_channels"])
    for d in range(model["depth"]):
        for part in ("w_real", "w_imag"):
            out[(f"spectral_{d}", part)] = (
                (w, w, model["modes1"], model["modes2"]), None)
        linear(f"pointwise_{d}", w, w)
    return out


def make(model: dict, seed: int, device) -> dict:
    """The weight tree of ``model`` from ``seed``, f32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = shapes(model)
    sizes = {k: math.prod(s) for k, (s, _) in leaves.items()}
    flat = torch.rand(sum(n for k, n in sizes.items()
                          if leaves[k][1] is not None),
                      generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(sum(n for k, n in sizes.items()
                             if leaves[k][1] is None),
                         generator=gen, device=device)
    scale = 1.0 / (model["width"] ** 2)
    tree: dict = {}
    at = nat = 0
    for path, (shape, bound) in leaves.items():
        n = sizes[path]
        if bound is None:
            leaf = normal[nat:nat + n].reshape(shape) * scale
            nat += n
        else:
            leaf = flat[at:at + n].reshape(shape) * bound
            at += n
        tree.setdefault(path[0], {})[path[1]] = leaf
    return tree
