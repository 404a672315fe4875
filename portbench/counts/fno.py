"""Operations and bytes of one FNO-2d model step on an R x R grid of B
examples, and of the curriculum's steps built from it, from the model's
shape alone.

The spectral convolution counts as its truncated-DFT form, whichever
form runs: the row transform at the 2 * modes1 kept row frequencies of
each of the R columns, the column transform at the modes2 kept column
frequencies, the (width, width) complex mixing of each kept mode, and
the two inverse transforms back to the grid, each a complex
multiply-add (8 real FLOPs) a term. So the FFT form, or a hand kernel,
reads as a faster step of the same work, not as other work. The
pointwise bypass, the lift and the projection count 2 FLOPs a
multiply-add. The GELUs, the bias adds and the casts are not counted.

The bytes are the least traffic of that step: the weights read once,
each example's input channels in and its output matrix out in f32.
"""

from __future__ import annotations

PROJECTION = 128       # the projection's hidden width
COMPLEX_MAC = 8        # real FLOPs of a complex multiply-add


def spectral_macs(model: dict, r: int) -> float:
    """Complex multiply-adds of one spectral convolution of one example:
    rows forward, columns forward, the mixing, rows back, columns back."""
    w, m1, m2 = model["width"], model["modes1"], model["modes2"]
    return float(2 * m1 * r * r * w + m2 * r * 2 * m1 * w
                 + 2 * m1 * m2 * w * w + r * 2 * m1 * m2 * w
                 + r * m2 * r * w)


def step_parts(model: dict, b: int, r: int) -> dict:
    """A forward model step's FLOPs over b examples, by part."""
    w, c = model["width"], model["in_channels"]
    points = b * r * r
    return {
        "spectral": COMPLEX_MAC * model["depth"] * b
        * spectral_macs(model, r),
        "pointwise": 2.0 * model["depth"] * points * w * w,
        "lift_projection": 2.0 * points * (c * w + w * PROJECTION
                                           + PROJECTION
                                           * model["out_channels"]),
    }


def step_flops(model: dict, b: int, r: int) -> float:
    """A forward model step over b examples of an r x r grid."""
    return float(sum(step_parts(model, b, r).values()))


def parameters(model: dict) -> int:
    w, c, o = model["width"], model["in_channels"], model["out_channels"]
    spectral = 2 * w * w * model["modes1"] * model["modes2"]
    return (c * w + w + model["depth"] * (spectral + w * w + w)
            + w * PROJECTION + PROJECTION + PROJECTION * o + o)


def step_bytes(model: dict, b: int, r: int) -> float:
    """The least bytes a forward model step moves: the weights, the input
    channels in and the output matrix out, in f32."""
    return float(4 * (parameters(model) + b * r * r
                      * (model["in_channels"] + model["out_channels"])))


def curriculum_flops(model: dict, b: int, r: int, unrolled: int,
                     supervised: int) -> float:
    """``unrolled`` forward model steps, and a backward of twice the
    forward's arithmetic for each of the ``supervised`` ones: 3x the
    forward for a supervised step."""
    one = step_flops(model, b, r)
    return float(unrolled * one + 2 * supervised * one)
