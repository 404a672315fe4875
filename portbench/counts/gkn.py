"""Operations and bytes of the GKN step and of the rollout kernels.

The kernel counts are the ones the port's kernel table uses: each input
read once, each output written once, per-edge work for the real edges
only (padded slots carry nothing). ``real`` is the number of real edges
of the step summed over its streams; ``s`` is the stream count.
"""

from __future__ import annotations

from portbench.counts.peaks import FLOPS, bound_s


def _dims(model: dict):
    return (model["num_residues"], model["window_size"], model["width"],
            model["ker_width"], model["depth"],
            2 if model["compute_dtype"] == "bfloat16" else 4)


def mlp_widths(model: dict):
    w, kw = model["width"], model["ker_width"]
    return ((model.get("edge_features", 6), kw), (kw, kw), (kw, w * w))


def step_flops(model: dict, real: float, s: int = 1) -> float:
    """The model's arithmetic in one step of s streams with ``real`` real
    edges in all: encoder (LSTM, lstm_fc, fc1), the Debye-Hueckel sum
    under ``electrostatics="dh"``, the edge MLP, 2*depth convs, the head."""
    r, t, w, _, depth, _ = _dims(model)
    x = model.get("x_position_dim", 3)
    nf = model.get("node_features", 7) + (
        1 if model.get("electrostatics", "none") == "dh" else 0)
    enc = s * r * (t * 2 * (2 * x * 4 * x) + 2 * x * x + 2 * nf * w)
    dh = s * 14 * r * r if model.get("electrostatics") == "dh" else 0
    mlp = 2 * real * sum(a * b for a, b in mlp_widths(model))
    convs = 2 * depth * (2 * real * w * w + 2 * s * r * w * w)
    head = s * r * 2 * w * model.get("out_width", 3)
    return float(enc + dh + mlp + convs + head)


def graph_encode(model: dict, real: float, s: int = 1):
    """(bytes, ops, peak) of one ``graph_encode`` launch: window, encoder
    weights, degrees, x0 and counts, and per real edge its indices, mask
    and features; the contact test, LSTM and fc1 in f32."""
    r, t, w, _, _, cdb = _dims(model)
    d = model.get("embedding_dim", 4)
    nf = d + 3 + (1 if model.get("electrostatics", "none") == "dh" else 0)
    weights = 4 * (r * d + 3 * 12 * 2 + 24 + 9 + 3 + nf * w + w)
    nbytes = (4 * s * t * r * 3 + weights + 4 * s * r + 4 * s * r * w
              + 4 * s + real * (2 * 4 + 4 + 6 * cdb))
    ops = s * (r * r * 8 + r * t * 12 * 13 + r * 7 * w * 2)
    return nbytes, ops, FLOPS["float32"]


def edge_mlp(model: dict, real: float, s: int = 1):
    """(bytes, ops, peak) of the three ``edge_mlp`` launches of a step,
    counted as the one function 6 -> kw -> kw -> w^2: weights and biases,
    each real edge's features and mask in, its kernel out."""
    w, cdb = model["width"], _dims(model)[5]
    widths = mlp_widths(model)
    nbytes = (sum(a * b * cdb + 4 * b for a, b in widths)
              + real * (6 * cdb + 4 + w * w * cdb))
    ops = 2 * real * sum(a * b for a, b in widths)
    return nbytes, ops, FLOPS[model["compute_dtype"]]


def conv_head(model: dict, real: float, s: int = 1):
    """(bytes, ops, peak) of one ``conv_head`` launch: x0, degrees, the two
    convs' roots and biases, fc2, the window read and written, the step's
    coordinates, and per real edge its kernel, indices and mask."""
    r, t, w, _, depth, cdb = _dims(model)
    nbytes = (4 * s * r * w + 4 * s * r + 2 * (w * w * cdb + 4 * w)
              + 4 * (w * 3 + 3) + 2 * 4 * s * t * r * 3 + 4 * s * r * 3
              + real * (w * w * cdb + 2 * 4 + 4))
    ops = (2 * depth * (2 * real * w * w + 2 * s * r * w * w)
           + s * r * 3 * 2 * w)
    return nbytes, ops, FLOPS[model["compute_dtype"]]


KERNELS = {"graph_encode": graph_encode, "edge_mlp": edge_mlp,
           "conv_head": conv_head}


def kernel_bound_s(kernel: str, model: dict, reals, s: int = 1) -> float:
    """Least time of one launch of ``kernel`` per step, summed over the
    steps whose real edge counts are ``reals``."""
    fn = KERNELS[kernel]
    return sum(bound_s(*fn(model, float(e), s)) for e in reals)


def train_step_flops(model: dict, real: float, b: int) -> float:
    """A teacher-forced train step of b examples with ``real`` real edges
    in all: the forward and a backward of twice its arithmetic."""
    return 3.0 * step_flops(model, real, b)


def _train_conv_common(model: dict, b: int):
    r, _, w, _, depth, cdb = _dims(model)
    e = model["max_edges"]
    small = (4 * b * r * w + 4 * b * 2 * e + 4 * b * r + 2 * 4 * w
             + 2 * w * w * cdb)
    stack = 4 * b * (2 * depth + 1) * r * w
    return r, w, depth, cdb, e, small, stack


def train_conv_fwd(model: dict, real: float, b: int):
    """(bytes, ops, peak) of one ``train_conv_fwd`` launch: x0, edge
    indices, degrees, biases and roots, each real edge's kernel, and the
    output and the kept activation stack written; each K element meets
    one operand, so the f32 peak."""
    r, w, depth, cdb, _, small, stack = _train_conv_common(model, b)
    nbytes = small + real * w * w * cdb + 4 * b * r * w + stack
    ops = 2 * depth * (2 * real * w * w + 2 * b * r * w * w)
    return nbytes, ops, FLOPS["float32"]


def train_conv_bwd(model: dict, real: float, b: int):
    """(bytes, ops, peak) of one ``train_conv_bwd`` launch: the output's
    gradient, the stack, edge indices, degrees and roots, each real
    edge's kernel in; dx0, dK for every slot, and the roots' and biases'
    gradients out."""
    r, w, depth, cdb, e, _, stack = _train_conv_common(model, b)
    nbytes = (4 * b * r * w + stack + 4 * b * 2 * e + 4 * b * r
              + 2 * w * w * cdb + real * w * w * cdb
              + 4 * b * r * w + b * e * w * w * cdb
              + 2 * (4 * b * w * w + 4 * b * w))
    ops = 2 * depth * (4 * real * w * w + 4 * b * r * w * w)
    return nbytes, ops, FLOPS["float32"]
