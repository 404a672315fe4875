"""The Graph Kernel Network step in plain PyTorch, the benchmark's frozen
reference (the GKN of Zhu et al.'s BBA study: ``graph_kernel.py:245-309``
of the reference code, with the per-residue LSTM window encoder).

One step maps a window of T frames (..., T, R, 3) to the next frame:

1. the contact graph of the window's last frame: every ordered pair
   (j, i) with |p_j - p_i|^2 < threshold^2, self-loops kept, the squared
   distance summed as (dx*dx + dy*dy) + dz*dz;
2. node features: an LSTM over the window (torch gate order i, f, g, o),
   a 3 -> 3 linear layer, then fc1 over [embedding(aa) ; h (; phi)] and a
   ReLU, where phi is the Debye-Hueckel potential of the last frame under
   ``electrostatics="dh"``;
3. 2*depth edge-conditioned convolutions, the first depth with conv1's
   root and bias, the rest with conv2's, all sharing one edge kernel
   K(e) = MLP([p_src ; p_dst]) of widths 6 -> ker -> ker -> width^2:
   x_i' = relu(x_i @ root + mean_{j -> i} x_j @ K(e_ji) + bias);
4. out = prior + head_scale * fc2(x), the prior being the last frame
   under ``predict_delta``, clipped to [-clip, clip].

Precision is that of the configuration: the operands of every product of
steps 2-3 (edge features, hidden rows, kernels, node rows, roots) are
rounded to the compute type and the products summed in f32; under 512
nodes each message is rounded again before its sum, as the configuration's
one-hot aggregation does. The encoder and the head stay f32. ``rounding``
takes another rounding function, which is how the control computes in a
lower precision. Products run in f32 with TF32 off.

A step over many windows at once is one batch: the edges of all windows
are listed together, so every frame of a checked call is judged in a few
large calls.
"""

from __future__ import annotations

import math

import torch

BJERRUM_A_K = 16712.2       # e^2 / (4 pi eps0 k_B), in A K
AVOGADRO = 6.02214076e23
DH_MIN_DIST = 1.0           # A, the distance clamp of the potential
# net side-chain charge at pH 7 by amino-acid index, alphabetical order
# (ALA ARG ASN ASP CYS GLN GLU GLY HIS ILE LEU LYS MET PHE PRO SER THR
# TRP TYR VAL): ARG/LYS +1, ASP/GLU -1, HIS +0.1
AA_CHARGES = (0.0, 1.0, 0.0, -1.0, 0.0, 0.0, -1.0, 0.0, 0.1, 0.0,
              0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
ROUNDED_MESSAGES_MAX_NODES = 512


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale for the tensor (its largest magnitude onto
    448), the usual form of an fp8 operand."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS = {"bfloat16": to_bf16, "fp8": to_fp8}


def contact_pairs(pos: torch.Tensor, threshold: float, block: int = 2048):
    """Every ordered pair under the threshold in pos (B, R, 3): (b, src,
    dst) int64, sorted by (b, src, dst), the row-major order of a
    [source, target] adjacency. Rows are taken ``block`` at a time."""
    b, r, _ = pos.shape
    t2 = threshold * threshold
    parts = []
    for lo in range(0, r, block):
        d = pos[:, lo:lo + block, None, :] - pos[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        bi, si, di = torch.nonzero(d2 < t2, as_tuple=True)
        parts.append((bi, si + lo, di))
    bi = torch.cat([p[0] for p in parts])
    si = torch.cat([p[1] for p in parts])
    di = torch.cat([p[2] for p in parts])
    order = torch.argsort((bi * r + si) * r + di)
    return bi[order], si[order], di[order]


def rebuild(pos: torch.Tensor, threshold: float, max_edges=None,
            max_degree=None):
    """The graph of each frame of pos (B, R, 3) with its capacity: (b,
    src, dst, count (B,), overflow (B,) bool). Under ``max_edges`` a frame
    keeps its first max_edges edges in row-major order and overflows past
    them; under ``max_degree`` it overflows where a node has more incoming
    edges than that (the block layout keeps each node's own slots)."""
    b, r, _ = pos.shape
    bi, si, di = contact_pairs(pos, threshold)
    count = torch.bincount(bi, minlength=b)
    overflow = torch.zeros(b, dtype=torch.bool, device=pos.device)
    if max_edges is not None:
        start = torch.cumsum(count, 0) - count
        rank = torch.arange(bi.numel(), device=pos.device) - start[bi]
        keep = rank < max_edges
        bi, si, di = bi[keep], si[keep], di[keep]
        overflow = count > max_edges
    if max_degree is not None:
        deg = torch.bincount(bi * r + di, minlength=b * r).reshape(b, r)
        overflow = overflow | (deg.amax(dim=1) > max_degree)
    return bi, si, di, count, overflow


def lstm_last(p, xs: torch.Tensor) -> torch.Tensor:
    """xs (T, N, 3) -> the last hidden state (N, hidden), f32."""
    hidden = p["w_hh"].shape[0]
    h = xs.new_zeros(xs.shape[1], hidden)
    c = torch.zeros_like(h)
    for t in range(xs.shape[0]):
        g = xs[t] @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
        i, f, gg, o = g.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h


def debye_huckel(pos: torch.Tensor, charges: torch.Tensor, eps_s: float,
                 temperature: float, ionic_strength: float,
                 block: int = 2048) -> torch.Tensor:
    """Screened Coulomb potential (kT/e) at each site of pos (B, R, 3) from
    the other sites' charges (R,): lb * sum_{j != i} q_j exp(-kappa d)/d,
    d clamped at DH_MIN_DIST."""
    lb = BJERRUM_A_K / (eps_s * temperature)
    n_ions = AVOGADRO * ionic_strength * 1e-27
    kappa = math.sqrt(8.0 * math.pi * lb * n_ions)
    b, r, _ = pos.shape
    out = []
    for lo in range(0, r, block):
        d2 = ((pos[:, lo:lo + block, None, :] - pos[:, None, :, :]) ** 2
              ).sum(-1)
        d = torch.sqrt(torch.clamp(d2, min=DH_MIN_DIST * DH_MIN_DIST))
        g = torch.exp(-kappa * d) / d
        rows = torch.arange(lo, min(lo + block, r), device=pos.device)
        g[:, rows - lo, rows] = 0.0
        out.append(lb * (g * charges).sum(-1))
    return torch.cat(out, dim=1)


def step(w, model: dict, aa: torch.Tensor, windows: torch.Tensor,
         clip=None, rounding: str | None = None, graph=None,
         feat_frame: int = -1):
    """The next frame of each window (B, T, R, 3): (frames (B, R, 3),
    count (B,), overflow (B,)). ``w`` is the weight tree, ``model`` the
    configuration's ``model`` block, ``aa`` (R,) the sequence. ``graph``
    passes a graph (b, src, dst, count, overflow) made for these windows,
    as training's stored contact maps are; ``feat_frame`` is the window
    frame the edge features come from (training takes the first)."""
    no_tf32()
    rnd = ROUNDINGS[rounding or model["compute_dtype"]]
    b, t, r, _ = windows.shape
    width = model["width"]
    last = windows[:, -1]
    if graph is None:
        graph = rebuild(last, model["threshold"], model.get("max_edges")
                        if model.get("neighbor_impl") != "cell_list"
                        else None,
                        model.get("max_degree")
                        if model.get("neighbor_impl") == "cell_list"
                        else None)
    bi, si, di, count, overflow = graph
    src, dst = bi * r + si, bi * r + di                  # global node ids

    # node features, f32
    h = lstm_last(w["lstm"], windows.permute(1, 0, 2, 3).reshape(t, b * r, 3))
    h = h @ w["lstm_fc"]["w"] + w["lstm_fc"]["b"]
    feats = [w["emb"][aa.long()].expand(b, r, -1).reshape(b * r, -1), h]
    if model.get("electrostatics", "none") == "dh":
        q = torch.as_tensor(AA_CHARGES, device=aa.device)[aa.long() % 20]
        phi = debye_huckel(last, q, model["eps_solvent"],
                           model["temperature"], model["ionic_strength"])
        feats.append(phi.reshape(b * r, 1))
    x = torch.relu(torch.cat(feats, dim=-1) @ w["fc1"]["w"] + w["fc1"]["b"])

    # the shared edge kernel over the real edges
    flat = windows[:, feat_frame].reshape(b * r, 3)
    ef = torch.cat([flat[src], flat[dst]], dim=-1)
    mlp = w["edge_kernel"]
    hk = ef
    for i in range(3):
        layer = mlp[f"layer_{i}"]
        hk = rnd(hk) @ rnd(layer["w"]) + layer["b"]
        if i < 2:
            hk = torch.relu(hk)
    kern = rnd(hk).reshape(-1, width, width)
    del hk

    deg = torch.bincount(dst, minlength=b * r).clamp(min=1).float()
    inv_deg = (1.0 / deg)[:, None]
    rounded = r <= ROUNDED_MESSAGES_MAX_NODES
    for layer in range(2 * model["depth"]):
        conv = w["conv1"] if layer < model["depth"] else w["conv2"]
        xr = rnd(x)
        msg = torch.bmm(xr[src][:, None, :], kern)[:, 0, :]
        if rounded:
            msg = rnd(msg)
        agg = torch.zeros_like(x).index_add_(0, dst, msg) * inv_deg
        x = torch.relu(agg + xr @ rnd(conv["root"]) + conv["bias"])
    out = (x @ w["fc2"]["w"] + w["fc2"]["b"]).reshape(b, r, 3)
    if model.get("predict_delta"):
        out = model.get("head_scale", 1.0) * out + last
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    return out, count, overflow


def free_rollout(w, model: dict, aa, window0: torch.Tensor, num_steps: int,
                 clip=None, rounding: str | None = None):
    """num_steps frames from window0 (S, T, R, 3), each step's window the
    last T frames: (frames (S, num_steps, R, 3), overflow (S,)). The
    control runs this in the program's place."""
    window = window0.clone()
    frames = []
    overflow = torch.zeros(window0.shape[0], dtype=torch.bool,
                           device=window0.device)
    for _ in range(num_steps):
        out, _, over = step(w, model, aa, window, clip, rounding)
        overflow |= over
        frames.append(out)
        window = torch.cat([window[:, 1:], out[:, None]], dim=1)
    return torch.stack(frames, dim=1), overflow


def contact_counts(pos: torch.Tensor, threshold: float,
                   block: int = 2048) -> torch.Tensor:
    """The number of ordered pairs under the threshold (self-loops kept)
    in each frame of pos (B, R, 3): (B,) int64."""
    b, r, _ = pos.shape
    t2 = threshold * threshold
    count = torch.zeros(b, dtype=torch.int64, device=pos.device)
    for lo in range(0, r, block):
        d = pos[:, lo:lo + block, None, :] - pos[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        count += (d2 < t2).sum(dim=(1, 2))
    return count


def judge_call(w, model: dict, aa, window0: torch.Tensor,
               frames: torch.Tensor, clip=None,
               rounding: str | None = None) -> dict:
    """Every frame of one stream's call against the reference's step from
    the window the program's own frames make: window0 (T, R, 3), frames
    (n, R, 3). Returns {"gap": the largest coordinate difference over the
    largest step the reference takes in the call (the frame minus its
    window's last frame), "rms_gap": the root of the summed squared
    differences over the summed squared steps, "err", "scale",
    "overflow": any reference rebuild over its capacity}. Windows are
    stepped together in blocks of 8,192 residues."""
    t = window0.shape[0]
    block = max(1, 8192 // window0.shape[1])
    n = frames.shape[0]
    full = torch.cat([window0, frames], dim=0)
    err = scale = sq_err = sq_step = 0.0
    overflow = False
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        idx = torch.arange(lo, hi, device=full.device)[:, None] \
            + torch.arange(t, device=full.device)
        windows = full[idx]                                  # (b, T, R, 3)
        pred, _, over = step(w, model, aa, windows, clip, rounding)
        diff = frames[lo:hi] - pred
        moved = pred - windows[:, -1]
        err = max(err, float(diff.abs().max()))
        scale = max(scale, float(moved.abs().max()))
        sq_err += float((diff.double() ** 2).sum())
        sq_step += float((moved.double() ** 2).sum())
        overflow = overflow or bool(over.any())
    return {"gap": err / max(scale, 1e-30),
            "rms_gap": math.sqrt(sq_err / max(sq_step, 1e-300)),
            "err": err, "scale": scale, "overflow": overflow}
