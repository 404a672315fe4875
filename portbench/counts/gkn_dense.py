"""Operations and bytes of one GKN model step on the dense all-pairs
graph, and of the curriculum's steps built from it.

The dense step does the model's work over every one of its B * R^2
ordered pairs, contact or not: the edge MLP 6 -> ker -> ker -> width^2
on each pair, and each of the 2*depth convs contracts a row of R*width
node features with the (R*width, R*width) masked kernel matrix of each
example, 2 * R^2 * width^2 a conv an example, plus the root product. So
its arithmetic is the sparse step's (``counts/gkn.py::step_flops``) with
every pair counted as an edge; a change that skips the masked pairs reads
as a faster step of the same work, not as less work.

The bytes are the least traffic of that step: the MLP's weights read
once, each pair's features in and its width^2 kernel out in the compute
type, and each conv reading the kernel tensor whole, with the node rows
and degrees in and out in f32.
"""

from __future__ import annotations

from portbench.counts import gkn


def step_flops(model: dict, pairs: float, b: int) -> float:
    """A forward model step over b examples and ``pairs`` pairs in all
    (b * R^2 on the dense graph)."""
    return gkn.step_flops(model, pairs, b)


def step_bytes(model: dict, pairs: float, b: int) -> float:
    """The least bytes a forward model step over b examples and ``pairs``
    pairs moves: the edge MLP's weights and its pairs in and kernels out,
    the 2*depth convs' passes over the kernel tensor and their node rows,
    the encoder's window in and the head's frame out."""
    r, t, w, _, depth, cdb = gkn._dims(model)
    weights = sum(a * c * cdb + 4 * c for a, c in gkn.mlp_widths(model))
    mlp = weights + pairs * (model.get("edge_features", 6) * cdb + w * w * cdb)
    conv = pairs * w * w * cdb + 2 * 4 * b * r * w + 4 * b * r \
        + w * w * cdb + 4 * w
    frames = 4 * b * t * r * 3 + 4 * b * r * 3
    return float(mlp + 2 * depth * conv + frames)


def curriculum_flops(model: dict, pairs: float, b: int, unrolled: int,
                     supervised: int) -> float:
    """``unrolled`` forward model steps at ``pairs`` pairs each, and a
    backward of twice the forward's arithmetic for each of the
    ``supervised`` ones: 3x the forward for a supervised step."""
    one = step_flops(model, pairs, b)
    return float(unrolled * one + 2 * supervised * one)


def curriculum_bytes(model: dict, pairs: float, b: int, unrolled: int,
                     supervised: int) -> float:
    """The same steps' least bytes, a supervised step 3x its forward's."""
    one = step_bytes(model, pairs, b)
    return float(unrolled * one + 2 * supervised * one)
