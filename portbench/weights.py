"""Seeded GKN weights, made on the device in a few large calls.

The tree has the program's keys and shapes (emb, lstm, lstm_fc, fc1, the
edge-kernel MLP, conv1, conv2, fc2). Each linear layer, LSTM and conv is
uniform in +-1/sqrt(fan in) (the LSTM's in +-1/sqrt(hidden)), the
embedding standard normal: all uniform leaves come from one draw on the
card and the embedding from a second. The configuration's ``weights``
block scales the edge kernel's last layer (``kernel_init_scale``) and may
zero the head's bias (``head_bias: "zero"``), so that every frame's step
comes from the conv stack and not from a constant drift.
"""

from __future__ import annotations

import math

import torch


def shapes(model: dict) -> dict:
    """{leaf path: (shape, bound)}; a bound of None is the normal draw."""
    w, kw = model["width"], model["ker_width"]
    x = model.get("x_position_dim", 3)
    nf = model.get("node_features", 7) + (
        1 if model.get("electrostatics", "none") == "dh" else 0)
    e = model.get("edge_features", 6)
    out = {("emb",): ((model.get("num_embeddings", 20),
                       model.get("embedding_dim", 4)), None)}
    hb = 1.0 / math.sqrt(x)
    for k, s in (("w_ih", (x, 4 * x)), ("w_hh", (x, 4 * x)),
                 ("b_ih", (4 * x,)), ("b_hh", (4 * x,))):
        out[("lstm", k)] = (s, hb)

    def linear(name, i, o):
        b = 1.0 / math.sqrt(i)
        out[name + ("w",)] = ((i, o), b)
        out[name + ("b",)] = ((o,), b)

    linear(("lstm_fc",), x, x)
    linear(("fc1",), nf, w)
    for i, (a, b) in enumerate(((e, kw), (kw, kw), (kw, w * w))):
        linear(("edge_kernel", f"layer_{i}"), a, b)
    for conv in ("conv1", "conv2"):
        b = 1.0 / math.sqrt(w)
        out[(conv, "root")] = ((w, w), b)
        out[(conv, "bias")] = ((w,), b)
    linear(("fc2",), w, model.get("out_width", 3))
    return out


def make(model: dict, spec: dict, seed: int, device) -> dict:
    """The weight tree of ``model`` from ``seed``, f32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = shapes(model)
    uniform = {k: v for k, v in leaves.items() if v[1] is not None}
    total = sum(math.prod(s) for s, _ in uniform.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(sum(math.prod(s) for s, b in leaves.values()
                             if b is None), generator=gen, device=device)
    tree: dict = {}
    at = nat = 0
    for path, (shape, bound) in leaves.items():
        n = math.prod(shape)
        if bound is None:
            leaf = normal[nat:nat + n].reshape(shape)
            nat += n
        else:
            leaf = flat[at:at + n].reshape(shape) * bound
            at += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    last = tree["edge_kernel"]["layer_2"]
    scale = float(spec.get("kernel_init_scale", 1.0))
    last["w"] = last["w"] * scale
    last["b"] = last["b"] * scale
    if spec.get("head_bias") == "zero":
        tree["fc2"]["b"] = torch.zeros_like(tree["fc2"]["b"])
    return tree
