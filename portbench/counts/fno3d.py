"""Operations and bytes of one FNO-3d model call on an R x R grid of B
examples and of its block train step, from the model's shape alone.

The spectral convolution counts as the program's truncated-DFT form
computes it, whichever form runs, on the padded grid (R, R, Z), Z =
out_frames + time_pad: the time transform at the m3 kept bins as a real
product (2 real multiply-adds a bin's real and imaginary parts, 4 FLOPs
a term), the residue axes' transforms at the 2 * m kept frequencies and
the (width, width) complex mixing of each kept mode as complex
multiply-adds (8 FLOPs a term), and back the other way, the time
inverse again a real product. So the FFT form, or a hand kernel, reads
as a faster step of the same work, not as other work. The pointwise
layers, the lift's frames part (at each (i, j)) and the projection
count 2 FLOPs a multiply-add; the lift's grid part (at each (i, j, t))
is counted once a call, as it is computed. The GELUs, the bias adds and
the padding are not counted.

The bytes are the least traffic of a call: the weights read once, each
example's input frames in and its output block out in f32.
"""

from __future__ import annotations

COMPLEX_MAC = 8        # real FLOPs of a complex multiply-add
REAL_PAIR = 4          # real FLOPs of a real number times a complex one
GRID_CHANNELS = 3


def padded_time(model: dict) -> int:
    return model["out_frames"] + model["time_pad"]


def spectral_flops(model: dict, r: int) -> float:
    """One spectral convolution of one example: time forward, residue
    axes forward, the mixing, residue axes back, time back."""
    c = model["width"]
    m1, m2, m3 = model["modes1"], model["modes2"], model["modes3"]
    z = padded_time(model)
    time = REAL_PAIR * r * r * c * z * m3
    second = COMPLEX_MAC * c * r * 2 * m2 * r * m3
    first = COMPLEX_MAC * c * 2 * m1 * r * 2 * m2 * m3
    mix = COMPLEX_MAC * 2 * m1 * 2 * m2 * m3 * c * c
    return float(2 * (time + second + first) + mix)


def call_parts(model: dict, b: float, r: int) -> dict:
    """A forward call's FLOPs over b examples, by part."""
    c, t, p = model["width"], model["out_frames"], model["projection"]
    z = padded_time(model)
    return {
        "spectral": model["depth"] * b * spectral_flops(model, r),
        "pointwise": 2.0 * model["depth"] * b * r * r * z * c * c,
        "lift": 2.0 * (b * r * r * model["window_size"] * c
                       + r * r * t * GRID_CHANNELS * c),
        "projection": 2.0 * b * r * r * t * (c * p + p),
    }


def call_flops(model: dict, b: float, r: int) -> float:
    return float(sum(call_parts(model, b, r).values()))


def block_step_flops(model: dict, b: float, r: int) -> float:
    """One train step: the forward call and a backward of twice its
    arithmetic."""
    return 3.0 * call_flops(model, b, r)


def parameters(model: dict) -> int:
    c, p = model["width"], model["projection"]
    spectral = 2 * 4 * c * c * model["modes1"] * model["modes2"] \
        * model["modes3"]
    return ((model["window_size"] + GRID_CHANNELS) * c + c
            + model["depth"] * (spectral + c * c + c)
            + c * p + p + p + 1)


def call_bytes(model: dict, b: float, r: int) -> float:
    """The least bytes a forward call moves: the weights, the input
    frames in and the output block out, in f32."""
    return float(4 * (parameters(model) + b * r * r
                      * (model["window_size"] + model["out_frames"])))
