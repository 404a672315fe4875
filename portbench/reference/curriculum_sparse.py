"""The GKN's K-step rollout curriculum on the sparse padded edge list, in
plain PyTorch: the benchmark's frozen reference for curriculum cells on
the sparse graph (``entries/train_curriculum_sparse.py``), where the
training kernels carry the conv stack.

One train step of a batch of windows (B, T, R, 3) with their true
continuations y (B, K, R, 3), as ``reference/curriculum.py`` has it,
with the sparse graph's capacity and cast points:

1. step 1 on the stored contact list of the window's first frame (the
   batch's padded slots, the real ones only), edge features from that
   first frame;
2. steps 2..K on the contact graph rebuilt from the last frame of the
   window the previous steps made from the model's own predictions,
   each frame keeping its first ``max_edges`` pairs in row-major order
   and flagging an overflow past them (``gkn.rebuild``), edge features
   from that last frame; each prediction is clipped to [-clip, clip]
   before it enters the window (step 1's loss takes it unclipped, the
   later steps' clipped, as the program does);
3. a model step as ``gkn.step`` computes it: the operands of the edge
   MLP's products, the kernels, the node rows entering the aggregation
   and the roots rounded to the configuration's compute type, and each
   message rounded again before its sum, as the training kernels round
   it (``ops/cuda/train_conv.py``);
4. the loss in delta space (``curriculum.denominators``) and Adam as
   ``reference/curriculum.py`` has them.

Departures from ``KernelNN`` are those of ``reference/curriculum.py``.
Every sum and product is f32 with TF32 off; ``rounding`` takes another
rounding of the operands (the control passes "fp8"). Examples run
``chunk`` at a time; the loss is a sum over the batch, so the chunks'
gradients add.
"""

from __future__ import annotations

import torch

from portbench.reference import gkn
from portbench.reference.curriculum import denominators
from portbench.reference.train import (
    B1,
    B2,
    EPS,
    batch_graph,
    leaves,
    rebuild_tree,
)


def unroll_loss(w, model: dict, aa, window, graph0, y_seq, denom,
                threshold: float, clip, rounding):
    """(the K-step loss of the windows (B, T, R, 3), summed over them; a
    (B,) flag of a rebuilt graph over its slots)."""
    k = y_seq.shape[1]
    out, _, overflow = gkn.step(w, model, aa, window, None, rounding,
                                graph0, feat_frame=0)
    loss = (torch.sqrt(((out - y_seq[:, 0]) ** 2).sum(dim=(1, 2)))
            / denom[:, 0]).sum() / k
    for t in range(1, k):
        if clip is not None:
            out = torch.clamp(out, -clip, clip)
        window = torch.cat([window[:, 1:], out[:, None]], dim=1)
        graph = gkn.rebuild(window[:, -1].detach(), threshold,
                            model["max_edges"])
        out, _, over = gkn.step(w, model, aa, window, clip, rounding, graph,
                                feat_frame=-1)
        overflow = overflow | over
        loss = loss + (torch.sqrt(((out - y_seq[:, t]) ** 2).sum(dim=(1, 2)))
                       / denom[:, t]).sum() / k
    return loss, overflow


def loss_and_grads(w, model: dict, aa, batch: dict, threshold: float,
                   clip=None, rounding=None, chunk: int = 32):
    """(loss, {leaf path: gradient}, any overflow) of one batch at the
    weights ``w``: batch["window"] (B, T, R, 3), batch["y_seq"]
    (B, K, R, 3), and the stored graph of each window's first frame as
    padded slots batch["edges"] (B, 2, E) and batch["mask"] (B, E)."""
    gkn.no_tf32()
    window, y_seq = batch["window"], batch["y_seq"]
    denom = denominators(window, y_seq)
    leaf = {k: v.detach().clone().requires_grad_(True) for k, v in leaves(w)}
    tree = rebuild_tree(w, leaf)
    total, overflow = 0.0, False
    for lo in range(0, window.shape[0], chunk):
        hi = min(window.shape[0], lo + chunk)
        graph0 = batch_graph(batch["edges"][lo:hi], batch["mask"][lo:hi])
        loss, over = unroll_loss(tree, model, aa, window[lo:hi], graph0,
                                 y_seq[lo:hi], denom[lo:hi], threshold, clip,
                                 rounding)
        loss.backward()
        total += float(loss.detach())
        overflow = overflow or bool(over.any())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaf.items()}, overflow


def train(w0, model: dict, aa, batches: list, lr: float, weight_decay: float,
          threshold: float, clip=None, clip_norm: float = 1.0,
          rounding=None, chunk: int = 32) -> dict:
    """Follow ``len(batches)`` curriculum steps from w0: {"losses": [...],
    "overflows": [...] (any rebuilt graph of the step over its slots),
    "grad1": the first step's gradient as Adam took it (clipped, before
    the decay), "params": the weights after the last step}, both as
    {leaf path: tensor}."""
    p = {k: v.detach().clone() for k, v in leaves(w0)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, overflows, grad1 = [], [], None
    for t, batch in enumerate(batches, start=1):
        loss, g, over = loss_and_grads(rebuild_tree(w0, p), model, aa, batch,
                                       threshold, clip, rounding, chunk)
        losses.append(loss)
        overflows.append(over)
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
    return {"losses": losses, "overflows": overflows, "grad1": grad1,
            "params": p}
