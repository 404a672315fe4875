"""The GKN's teacher-forced training step in plain PyTorch: the loss, its
gradients and Adam, from the benchmark's own batches and weights.

- loss: the sum over the batch of ||out_b - y_b|| / ||y_b|| over the
  (R*3)-flattened frames, out from ``gkn.step`` on the batch's stored
  graph (edge features from the window's first frame), no clip;
- gradients by autograd through the f32 reference, whose rounding of each
  product's operands rounds the gradients flowing back through it;
- Adam with L2 decay added to the gradient before the moments (b1 0.9,
  b2 0.999, eps 1e-8 outside the root, bias corrections in f32 of the
  step count), at a constant learning rate over the steps followed.
"""

from __future__ import annotations

import torch

from portbench.reference import gkn

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def rebuild_tree(like, values: dict, prefix=""):
    if isinstance(like, dict):
        return {k: rebuild_tree(v, values, f"{prefix}{k}/")
                for k, v in like.items()}
    return values[prefix[:-1]]


def batch_graph(edges: torch.Tensor, mask: torch.Tensor):
    """(b, src, dst, count, overflow) of padded lists edges (B, 2, E),
    mask (B, E): the real slots only."""
    bi, slot = torch.nonzero(mask > 0, as_tuple=True)
    count = torch.bincount(bi, minlength=mask.shape[0])
    return (bi, edges[bi, 0, slot].long(), edges[bi, 1, slot].long(), count,
            torch.zeros(mask.shape[0], dtype=torch.bool, device=mask.device))


def loss_and_grads(w, model: dict, aa, batch: dict, rounding=None):
    """(loss, {leaf path: gradient}) of one batch dict (window, y, edges,
    mask) at the weights ``w``."""
    no = {k: v.detach().clone().requires_grad_(True)
          for k, v in leaves(w)}
    tree = rebuild_tree(w, no)
    out, _, _ = gkn.step(tree, model, aa, batch["window"], None, rounding,
                         batch_graph(batch["edges"], batch["mask"]),
                         feat_frame=0)
    b = out.shape[0]
    diff = (out - batch["y"]).reshape(b, -1)
    loss = (torch.linalg.vector_norm(diff, dim=1)
            / torch.linalg.vector_norm(batch["y"].reshape(b, -1), dim=1)
            ).sum()
    loss.backward()
    return loss.detach(), {k: (v.grad if v.grad is not None
                               else torch.zeros_like(v))
                           for k, v in no.items()}


def train(w0, model: dict, aa, batches: list, lr: float,
          weight_decay: float, rounding=None) -> dict:
    """Follow ``len(batches)`` steps from w0: {"losses": [...], "grad1":
    the first step's gradients, "params": the weights after the last
    step}, both as {leaf path: tensor}."""
    gkn.no_tf32()
    p = {k: v.detach().clone() for k, v in leaves(w0)}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], None
    for t, batch in enumerate(batches, start=1):
        loss, g = loss_and_grads(rebuild_tree(w0, p), model, aa, batch,
                                 rounding)
        losses.append(float(loss))
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


def leaf_gaps(got: dict, want: dict, counted) -> float:
    """The worst leaf's gap between two norms: max over ``counted`` leaves
    of | |got| - |want| | over the larger of |want| and the median leaf's
    |want|."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double()))
             for k in counted}
    median = sorted(norms.values())[len(norms) // 2]
    worst = 0.0
    for k in counted:
        g = float(torch.linalg.vector_norm(got[k].double()))
        worst = max(worst, abs(g - norms[k]) / max(norms[k], median, 1e-30))
    return worst


def moving_leaves(grad1: dict) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm."""
    norms = {k: float(torch.linalg.vector_norm(v.double()))
             for k, v in grad1.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return sorted(k for k, n in norms.items() if n >= 1e-3 * median)
