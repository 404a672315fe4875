"""The GKN's K-step rollout curriculum on the dense all-pairs graph, in
plain PyTorch: the benchmark's frozen reference for training cells whose
mix trains the curriculum (``entries/train_curriculum.py``).

One train step of a batch of windows (B, T, R, 3) with their true
continuations y (B, K, R, 3):

1. step 1 on the stored contact graph of the window's first frame (every
   ordered pair under the threshold, self-loops kept), edge features
   [p_src ; p_dst] from that first frame;
2. steps 2..K on the contact graph REBUILT from the last frame of the
   window the previous steps made from the model's own predictions (the
   squared distance summed as (dx*dx + dy*dy) + dz*dz, strict ``<``), edge
   features from that last frame; each prediction is clipped to
   [-clip, clip] before it enters the window (step 1's loss takes it
   unclipped, the later steps' clipped, as the program does);
3. a model step: the LSTM window encoder, lstm_fc and fc1 (f32), the edge
   MLP 6 -> ker -> ker -> width^2 over the contacts, 2*depth tied convs
   x_i' = relu(x_i @ root + mean_{j -> i} x_j @ K(e_ji) + bias) (conv1's
   root and bias for the first depth, conv2's after), and the head
   prior + head_scale * fc2(x), the prior being the window's last frame;
4. the loss in delta space: the sum over the batch of the steps' mean of
   ||out_t - y_t|| / d_t, d_t = ||y_t - y_{t-1}|| (y_0's predecessor the
   window's last frame), detached, floored at a tenth of its mean over
   the batch and at 1e-6;
5. Adam: the global gradient norm clipped to ``clip_norm``, L2 decay added
   to the gradient, b1 0.9, b2 0.999, eps 1e-8 outside the root, bias
   corrections in f32 of the step count, a constant learning rate.

The aggregation runs over the contact pairs themselves (a gather, a
product per contact and an ``index_add_``), not over all R^2 pairs with
an adjacency mask: it is the program's dense conv computed another way.

Departures from ``KernelNN`` (``graph_kernel.py:245-309`` of the
reference code), each the model the port trains: the per-residue LSTM
window encoder in place of a frame's coordinates as node input; the two
stacks of depth tied convs sharing one edge kernel; the ``predict_delta``
head (prior plus a scaled correction); the curriculum's unroll and its
delta-space loss, where ``KernelNN`` trains one teacher-forced step on an
absolute relative L2; the gradient clip.

Precision: every sum and product is f32 with TF32 off. The operands of
the edge MLP's products, the kernels, the node rows entering the
aggregation and the roots are rounded to ``rounding`` (the
configuration's compute type unless given; "float32" leaves them), the
cast points of the program's dense conv, whose messages are summed
unrounded. The control passes "fp8". Examples run ``chunk`` at a time;
the loss is a sum over the batch, so the chunks' gradients add.
"""

from __future__ import annotations

import torch

from portbench.reference import gkn
from portbench.reference.train import B1, B2, EPS, leaves, rebuild_tree


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def rounding_fn(model: dict, rounding=None):
    name = rounding or model["compute_dtype"]
    return _identity if name == "float32" else gkn.ROUNDINGS[name]


def model_step(w, model: dict, aa, window: torch.Tensor, pairs,
               feat_frame: int, rnd) -> torch.Tensor:
    """The next frame (B, R, 3) of each window (B, T, R, 3) over the
    contact ``pairs`` (b, src, dst), edge features from window frame
    ``feat_frame``."""
    b, t, r, _ = window.shape
    width = model["width"]
    bi, si, di = pairs
    src, dst = bi * r + si, bi * r + di

    h = gkn.lstm_last(w["lstm"], window.permute(1, 0, 2, 3).reshape(
        t, b * r, 3))
    h = h @ w["lstm_fc"]["w"] + w["lstm_fc"]["b"]
    emb = w["emb"][aa.long()].expand(b, r, -1).reshape(b * r, -1)
    x = torch.relu(torch.cat([emb, h], dim=-1) @ w["fc1"]["w"]
                   + w["fc1"]["b"])

    flat = window[:, feat_frame].reshape(b * r, 3)
    hk = torch.cat([flat[src], flat[dst]], dim=-1)
    for i in range(3):
        layer = w["edge_kernel"][f"layer_{i}"]
        hk = rnd(hk) @ rnd(layer["w"]) + layer["b"]
        if i < 2:
            hk = torch.relu(hk)
    kern = rnd(hk).reshape(-1, width, width)
    del hk

    deg = torch.bincount(dst, minlength=b * r).clamp(min=1).float()
    inv_deg = (1.0 / deg)[:, None]
    for layer in range(2 * model["depth"]):
        conv = w["conv1"] if layer < model["depth"] else w["conv2"]
        xr = rnd(x)
        msg = torch.bmm(xr[src][:, None, :], kern)[:, 0, :]
        agg = torch.zeros_like(x).index_add(0, dst, msg) * inv_deg
        x = torch.relu(agg + xr @ rnd(conv["root"]) + conv["bias"])
    out = (x @ w["fc2"]["w"] + w["fc2"]["b"]).reshape(b, r, 3)
    return model.get("head_scale", 1.0) * out + window[:, -1]


def denominators(window: torch.Tensor, y_seq: torch.Tensor) -> torch.Tensor:
    """(B, K) true displacements of each step, floored at a tenth of each
    step's mean over the whole batch and at 1e-6."""
    prev = torch.cat([window[:, -1:], y_seq[:, :-1]], dim=1)
    d = torch.sqrt(((y_seq - prev) ** 2).sum(dim=(2, 3)))
    d = torch.maximum(d, 0.1 * d.mean(dim=0, keepdim=True))
    return torch.clamp(d, min=1e-6)


def unroll_loss(w, model: dict, aa, window, pairs0, y_seq, denom,
                threshold: float, clip, rnd) -> torch.Tensor:
    """The K-step loss of the windows (B, T, R, 3), summed over them."""
    k = y_seq.shape[1]
    out = model_step(w, model, aa, window, pairs0, 0, rnd)
    loss = (torch.sqrt(((out - y_seq[:, 0]) ** 2).sum(dim=(1, 2)))
            / denom[:, 0]).sum() / k
    for t in range(1, k):
        if clip is not None:
            out = torch.clamp(out, -clip, clip)
        window = torch.cat([window[:, 1:], out[:, None]], dim=1)
        pairs = gkn.contact_pairs(window[:, -1].detach(), threshold)
        out = model_step(w, model, aa, window, pairs, -1, rnd)
        if clip is not None:
            out = torch.clamp(out, -clip, clip)
        loss = loss + (torch.sqrt(((out - y_seq[:, t]) ** 2).sum(dim=(1, 2)))
                       / denom[:, t]).sum() / k
    return loss


def _chunk_pairs(contacts: list, lo: int, hi: int, device):
    """(b, src, dst) of the stored contact lists ``contacts[lo:hi]``, each
    a (2, n) array [src; dst]."""
    bi, si, di = [], [], []
    for i, c in enumerate(contacts[lo:hi]):
        c = torch.as_tensor(c, device=device).long()
        bi.append(torch.full((c.shape[1],), i, dtype=torch.long,
                             device=device))
        si.append(c[0])
        di.append(c[1])
    return torch.cat(bi), torch.cat(si), torch.cat(di)


def loss_and_grads(w, model: dict, aa, batch: dict, threshold: float,
                   clip=None, rounding=None, chunk: int = 32):
    """(loss, {leaf path: gradient}) of one batch at the weights ``w``:
    batch["window"] (B, T, R, 3), batch["y_seq"] (B, K, R, 3) and
    batch["contacts"], the stored contact list of each window's first
    frame."""
    gkn.no_tf32()
    rnd = rounding_fn(model, rounding)
    window, y_seq = batch["window"], batch["y_seq"]
    denom = denominators(window, y_seq)
    leaf = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(w)}
    tree = rebuild_tree(w, leaf)
    total = 0.0
    for lo in range(0, window.shape[0], chunk):
        hi = min(window.shape[0], lo + chunk)
        pairs0 = _chunk_pairs(batch["contacts"], lo, hi, window.device)
        loss = unroll_loss(tree, model, aa, window[lo:hi], pairs0,
                           y_seq[lo:hi], denom[lo:hi], threshold, clip, rnd)
        loss.backward()
        total += float(loss.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaf.items()}


def train(w0, model: dict, aa, batches: list, lr: float, weight_decay: float,
          threshold: float, clip=None, clip_norm: float = 1.0,
          rounding=None, chunk: int = 32) -> dict:
    """Follow ``len(batches)`` curriculum steps from w0: {"losses": [...],
    "grad1": the first step's gradient as Adam took it (clipped, before
    the decay), "params": the weights after the last step}, both as
    {leaf path: tensor}."""
    p = {k: v.detach().clone() for k, v in leaves(w0)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    for t, batch in enumerate(batches, start=1):
        loss, g = loss_and_grads(rebuild_tree(w0, p), model, aa, batch,
                                 threshold, clip, rounding, chunk)
        losses.append(loss)
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(v) for v in g.values()]))
        if clip_norm and float(norm) >= clip_norm:
            g = {k: v * (clip_norm / norm) for k, v in g.items()}
        grad1 = grad1 if grad1 is not None else g
        c1 = 1 - torch.pow(torch.tensor(B1, dtype=torch.float32), float(t))
        c2 = 1 - torch.pow(torch.tensor(B2, dtype=torch.float32), float(t))
        for k in p:
            gk = g[k] + weight_decay * p[k]
            mu[k] = B1 * mu[k] + (1 - B1) * gk
            nu[k] = B2 * nu[k] + (1 - B2) * gk * gk
            upd = (mu[k] / c1.to(gk.device)) / (
                torch.sqrt(nu[k] / c2.to(gk.device)) + EPS)
            p[k] = p[k] - lr * upd
    return {"losses": losses, "grad1": grad1, "params": p}
