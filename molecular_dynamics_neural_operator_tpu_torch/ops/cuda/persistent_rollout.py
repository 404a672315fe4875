"""The rollout on hand-written Hopper kernels.

Port of the TPU kernel
``molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py``
(``persistent_rollout``, ``make_persistent_rollout_fn``). The TPU runs the
whole rollout as one launch over a sequential grid with every weight in
VMEM; an H100 has neither, so each step is five launches on the current
stream, with no host sync inside the loop:

1. ``graph_encode`` (``csrc/graph_encode.cu``): contact test, padded edge
   list, overflow flag, inverse degrees, edge features, LSTM + fc1.
2. ``edge_mlp_stack`` (``csrc/edge_mlp.cu``, wrapped in
   ``ops/cuda/edge_mlp.py``): the edge-kernel MLP over the S*E edge rows,
   three launches enqueued by one call; the last writes K with padded
   rows zeroed.
3. ``conv_head`` (``csrc/conv_head.cu``): 2*depth tied convs, fc2 head,
   prior, clip, window slide, this step's coordinates. A stream is one
   cluster of 8 blocks, or of 16 (the wide plan, bf16 at width 64) while
   the card holds every stream's 16-block cluster at once
   (``conv_head_plan``); the counter ``conv_head_wide`` counts the wide
   launches.

Each wrapper has a plain PyTorch version of the same function beside it
(``*_plain``), built from the port's XLA-path modules. A wrapper runs the
plain version for CPU tensors only; for CUDA tensors it launches its
kernel or raises. Each counts its launches under its name in the
program counters (``utils/profiling.py::count``); ``launch_counts()``
reads them.
Where the plain versions serve as the oracle on the card, the caller turns
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``) so their f32 products are
full f32.

With ``electrostatics="dh"`` ``graph_encode`` also forms the Debye-Hückel
potential at each residue from the squared distances of its contact test
and feeds it to fc1 as the eighth input.

``PreparedRollout`` splits preparation from the step loop: the weights
are cast once and the step buffers are kept per stream count, so a server
that runs segment after segment allocates nothing but the coordinates.
On the card its loop is the counterpart of the TPU kernel's single launch:
a block of steps captured once as a CUDA graph over a static window and a
static block of coordinates (``ops/cuda/graphs.py``), replayed block after
block with no Python between the launches. ``PreparedRollout.eager`` is
the step loop issued from Python, the graph's oracle and the CPU's path.
``rollout_kernels`` is a one-shot call of it; ``make_persistent_rollout_fn``
keeps its prepared rollout, graphs included, across calls with the same
parameters and sequence, as ``jax.jit`` keeps its program.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import (
    compute_dtype,
    resolve_device,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    contact_map,
    edge_features_from_edges,
    padded_edges_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    dh_potential,
    encode_nodes,
    residual_prior,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._launch import (
    check_operand as _check,
    cd_flag as _cd_flag,
    current_stream as _stream,
    kernel_fn as _kernel,
    on_cpu as _on_cpu,
    raise_on as _raise_on,
    register_kernel,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    GRAPH_BLOCK,
    BlockLoop,
    KeepLast,
    tree_identity,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._plain import (
    conv_stack_plain,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.edge_mlp import (
    edge_mlp_stack,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    sparse_inv_degree,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import linear_apply
from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
    DH_MIN_DIST,
    bjerrum_length,
    debye_kappa,
    residue_charges,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
register_kernel("graph_encode", "mdno_graph_encode",
                [_P] * 11 + [_I] * 6 + [_F, _I, _I, _F, _F, _F] + [_P] * 8)
register_kernel("graph_encode_plan", "mdno_graph_encode_plan",
                [_I] * 5 + [ctypes.POINTER(ctypes.c_int)] * 5,
                source="graph_encode")
register_kernel("conv_head", "mdno_conv_head",
                [_P] * 13 + [_I] * 7 + [_F, _I, _F, _I, _F, _I, _I, _P])
register_kernel("conv_head_clusters", "mdno_conv_head_clusters",
                [_I] * 5 + [ctypes.POINTER(ctypes.c_int)], source="conv_head")


class StepBuffers(NamedTuple):
    """Device buffers one rollout step writes; allocated once per rollout.

    edges (S, 2, E) int32, mask (S, E) f32, count (S,) int32, overflow (1,)
    int32 (OR-ed over steps), inv_deg (S, R) f32, ef (S, E, 6) cd, x0
    (S, R, w) f32, h1/h2 (S*E, ker_width) cd, kmat (S*E, w*w) cd."""

    edges: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor
    inv_deg: torch.Tensor
    ef: torch.Tensor
    x0: torch.Tensor
    h1: torch.Tensor
    h2: torch.Tensor
    kmat: torch.Tensor


def alloc_buffers(cfg: ModelConfig, streams: int, num_nodes: int,
                  device) -> StepBuffers:
    cd = compute_dtype(cfg)
    s, r, e = streams, num_nodes, cfg.max_edges
    w, kw = cfg.width, cfg.ker_width

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    return StepBuffers(
        edges=empty(s, 2, e, dtype=torch.int32), mask=empty(s, e),
        count=empty(s, dtype=torch.int32),
        overflow=torch.zeros(1, dtype=torch.int32, device=device),
        inv_deg=empty(s, r), ef=empty(s, e, 6, dtype=cd), x0=empty(s, r, w),
        h1=empty(s * e, kw, dtype=cd), h2=empty(s * e, kw, dtype=cd),
        kmat=empty(s * e, w * w, dtype=cd))


def rollout_weights(params, cfg: ModelConfig, aa, device):
    """The parameters as the kernels take them: encoder, fc2 and biases in
    f32, the edge-MLP weights and conv roots in the compute dtype, the
    embedding rows of ``aa`` gathered once. Under ``electrostatics="dh"``
    fc1 keeps its eighth row (the potential's) and ``charges`` holds the
    residues' charges; ``cfg`` rides along for the solvent's constants."""
    cd = compute_dtype(cfg)

    def f32(t):
        return t.to(device=device, dtype=torch.float32).contiguous()

    def lin(p):
        return {"w": f32(p["w"]), "b": f32(p["b"])}

    mlp = params["edge_kernel"]
    if len(mlp) != 3 or mlp["layer_0"]["w"].shape[0] != 6:
        raise ValueError("the edge-kernel MLP must be 6 -> kw -> kw -> w^2")
    aa = torch.as_tensor(aa, device=device).long()
    return {
        "cfg": cfg,
        "charges": (f32(residue_charges(aa))
                    if cfg.electrostatics == "dh" else None),
        "emb_aa": f32(params["emb"].to(device)[aa]),
        "lstm": {k: f32(v) for k, v in params["lstm"].items()},
        "lstm_fc": lin(params["lstm_fc"]),
        "fc1": lin(params["fc1"]),
        "mlp": [{"w": mlp[f"layer_{i}"]["w"].to(device=device, dtype=cd)
                 .contiguous(), "b": f32(mlp[f"layer_{i}"]["b"])}
                for i in range(3)],
        "conv1": {"root": params["conv1"]["root"].to(device=device, dtype=cd)
                  .contiguous(), "bias": f32(params["conv1"]["bias"])},
        "conv2": {"root": params["conv2"]["root"].to(device=device, dtype=cd)
                  .contiguous(), "bias": f32(params["conv2"]["bias"])},
        "fc2": lin(params["fc2"]),
    }


# ---- graph_encode -------------------------------------------------------

def graph_encode_plain(window, weights, threshold: float, max_edges: int,
                       cd):
    """Plain version: (edges, mask, count, overflow, inv_deg, ef, x0) of
    window (S, T, R, 3)."""
    pos = window[:, -1]
    adj = contact_map(pos, threshold)
    edges, mask, count = padded_edges_device(adj, max_edges,
                                             return_count=True)
    ef = edge_features_from_edges(pos, edges).to(cd)
    inv_deg = sparse_inv_degree(edges, mask, window.shape[2])
    phi = None
    if weights["charges"] is not None:
        phi = dh_potential(weights["cfg"], weights["charges"], pos)
    x0 = encode_nodes(weights, weights["emb_aa"], window, phi)
    return edges, mask, count, count > max_edges, inv_deg, ef, x0


_plans: dict = {}


def graph_encode_plan(frames: int, num_nodes: int, emb_dim: int, width: int,
                      dh: bool) -> dict:
    """The launch shape of ``graph_encode`` at these shapes on the current
    card: ``smem``, the dynamic shared memory a block needs (12 T R + R^2 /
    8 bytes and a few KB of weights), ``threads`` a block, ``max_smem``,
    the card's per-block opt-in maximum, and ``max_nodes`` and
    ``max_features``, the most residues and fc1 inputs the kernel takes.
    Read once per shape and card; a shape past the last two raises
    ``ValueError``."""
    key = (frames, num_nodes, emb_dim, width, bool(dh),
           torch.cuda.current_device())
    if key not in _plans:
        out = [ctypes.c_int(0) for _ in range(5)]
        rc = _kernel("graph_encode_plan")(
            *key[:4], int(dh), *(ctypes.byref(v) for v in out))
        plan = dict(zip(("smem", "threads", "max_smem", "max_nodes",
                         "max_features"), (v.value for v in out)))
        if rc == 1:  # cudaErrorInvalidValue: the kernel's shape limits
            raise ValueError(
                f"graph_encode takes at most {plan['max_nodes']} residues "
                f"and {plan['max_features']} fc1 inputs, got {num_nodes} "
                f"and {emb_dim + 3 + int(dh)}")
        _raise_on(rc, "graph_encode_plan")
        _plans[key] = plan
    return _plans[key]


def graph_encode(window: torch.Tensor, weights, threshold: float,
                 out: StepBuffers) -> None:
    """Rebuild the graph and encode the nodes of window (S, T, R, 3) into
    ``out``; OR this step's overflow into ``out.overflow``.

    On the card one block a stream holds the window, the weights and a
    bit-packed contact matrix in shared memory. Its shape limits: that
    memory, the card's per-block opt-in maximum (227 KB on an H100, at
    width 64 and 4 embedding dimensions: windows of up to 28 frames at
    R = 512, up to R = 844 at T = 10, 832 with dh); at most 1,024 residues
    (32 contact words a row); at most 16 fc1 inputs. A shape past any of
    them raises ``ValueError`` before any launch."""
    s, t, r, _ = window.shape
    e = out.mask.shape[1]
    if _on_cpu(window):
        edges, mask, count, over, inv_deg, ef, x0 = graph_encode_plain(
            window, weights, threshold, e, out.ef.dtype)
        for dst, src in ((out.edges, edges), (out.mask, mask),
                         (out.count, count), (out.inv_deg, inv_deg),
                         (out.ef, ef), (out.x0, x0)):
            dst.copy_(src)
        out.overflow.copy_(out.overflow | over.any().to(torch.int32))
        return
    dev = window.device
    w = out.x0.shape[-1]
    emb = weights["emb_aa"]
    d = emb.shape[-1]
    lstm, lfc, fc1 = weights["lstm"], weights["lstm_fc"], weights["fc1"]
    f32, i32, cd = torch.float32, torch.int32, out.ef.dtype
    charges, cfg = weights["charges"], weights["cfg"]
    dh = charges is not None
    nf = d + 3 + int(dh)            # fc1 inputs: [emb ; lstm ; phi]
    plan = graph_encode_plan(t, r, d, w, dh)
    if plan["smem"] > plan["max_smem"]:
        raise ValueError(
            f"graph_encode needs {plan['smem']} bytes of shared memory for a "
            f"window of {t} frames of {r} residues, more than the "
            f"{plan['max_smem']} a block of this card can hold: shorten the "
            f"window or use the plain rollout (rollout/scan.py)")
    args = [
        _check(window, "window", f32, (s, t, r, 3), dev),
        _check(emb, "emb_aa", f32, (r, d), dev),
        _check(lstm["w_ih"], "w_ih", f32, (3, 12), dev),
        _check(lstm["w_hh"], "w_hh", f32, (3, 12), dev),
        _check(lstm["b_ih"], "b_ih", f32, (12,), dev),
        _check(lstm["b_hh"], "b_hh", f32, (12,), dev),
        _check(lfc["w"], "lstm_fc.w", f32, (3, 3), dev),
        _check(lfc["b"], "lstm_fc.b", f32, (3,), dev),
        _check(fc1["w"], "fc1.w", f32, (nf, w), dev),
        _check(fc1["b"], "fc1.b", f32, (w,), dev),
        _check(charges, "charges", f32, (r,), dev) if dh else None,
        s, t, r, d, w, e, float(threshold) * float(threshold), _cd_flag(cd),
        int(dh),
        debye_kappa(cfg.ionic_strength, cfg.eps_solvent,
                    cfg.temperature) if dh else 0.0,
        bjerrum_length(cfg.eps_solvent, cfg.temperature) if dh else 0.0,
        DH_MIN_DIST,
        _check(out.edges, "edges", i32, (s, 2, e), dev),
        _check(out.mask, "mask", f32, (s, e), dev),
        _check(out.count, "count", i32, (s,), dev),
        _check(out.overflow, "overflow", i32, (1,), dev),
        _check(out.inv_deg, "inv_deg", f32, (s, r), dev),
        _check(out.ef, "ef", cd, (s, e, 6), dev),
        _check(out.x0, "x0", f32, (s, r, w), dev),
        _stream(),
    ]
    _raise_on(_kernel("graph_encode")(*args), "graph_encode")
    profiling.count("graph_encode")


# ---- conv_head ----------------------------------------------------------

def conv_head_plain(x0, kmat, edges, mask, inv_deg, weights,
                    cfg: ModelConfig, clip, window):
    """Plain version: tied conv stack, fc2 head, prior and clip; slides
    window (S, T, R, 3) in place and returns this step's (S, R, 3)."""
    x = conv_stack_plain(x0, kmat, edges, mask, inv_deg, weights["conv1"],
                         weights["conv2"], cfg.depth)
    out = linear_apply(weights["fc2"], x)
    if cfg.predict_delta:
        out = cfg.head_scale * out + residual_prior(cfg, window)
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    window.copy_(torch.cat([window[:, 1:], out[:, None]], dim=1))
    return out


_wide_clusters: dict = {}


def wide_clusters(num_nodes: int, width: int, max_edges: int, cd,
                  device) -> int:
    """How many of ``conv_head``'s wide clusters (16 blocks a stream) the
    card ``device`` holds at once at these shapes (0 where the shapes run
    the CUDA-core body, which has no wide plan), asked of that card once
    per shape and then kept, so that choosing a plan costs a launch
    nothing."""
    device = torch.device(device)
    key = (num_nodes, width, max_edges, cd, device)
    if key not in _wide_clusters:
        with torch.cuda.device(device):
            _wide_clusters[key] = conv_head_clusters(
                num_nodes, width, max_edges, cd, wide=True)
    return _wide_clusters[key]


def conv_head_plan(streams: int, wide: int) -> str:
    """``"wide"`` (a 16-block cluster a stream: half the K slice a block,
    four warps a node) when the card holds all ``streams`` of the wide
    plan's clusters at once (``wide``, from ``wide_clusters``), else
    ``"narrow"`` (8 blocks a stream): more streams than that would wait
    for a second wave, while 8-block clusters run in one."""
    return "wide" if streams <= wide else "narrow"


def conv_head(bufs: StepBuffers, weights, cfg: ModelConfig, clip,
              window: torch.Tensor, coords: torch.Tensor) -> None:
    """Conv stack and head of one step from ``bufs``: writes coords
    (S, R, 3) and slides window (S, T, R, 3) in place, on the plan that
    ``conv_head_plan`` picks (the two plans give the same bits)."""
    s, t, r, _ = window.shape
    e = bufs.mask.shape[1]
    w = bufs.x0.shape[-1]
    if _on_cpu(window):
        coords.copy_(conv_head_plain(
            bufs.x0, bufs.kmat, bufs.edges, bufs.mask, bufs.inv_deg,
            weights, cfg, clip, window))
        return
    dev, f32, cd = window.device, torch.float32, bufs.kmat.dtype
    c1, c2, fc2 = weights["conv1"], weights["conv2"], weights["fc2"]
    extrapolate = cfg.predict_prior == "extrapolate"
    if cfg.predict_prior not in ("last", "extrapolate"):
        raise ValueError(f"unknown predict_prior: {cfg.predict_prior!r}")
    if cfg.predict_delta and extrapolate and t < 2:
        raise ValueError("predict_prior='extrapolate' needs window_size >= 2")
    plan = conv_head_plan(s, wide_clusters(r, w, e, cd, dev))
    args = [
        _check(bufs.x0, "x0", f32, (s, r, w), dev),
        _check(bufs.kmat, "kmat", cd, (s * e, w * w), dev),
        _check(bufs.edges, "edges", torch.int32, (s, 2, e), dev),
        _check(bufs.mask, "mask", f32, (s, e), dev),
        _check(bufs.inv_deg, "inv_deg", f32, (s, r), dev),
        _check(c1["root"], "conv1.root", cd, (w, w), dev),
        _check(c1["bias"], "conv1.bias", f32, (w,), dev),
        _check(c2["root"], "conv2.root", cd, (w, w), dev),
        _check(c2["bias"], "conv2.bias", f32, (w,), dev),
        _check(fc2["w"], "fc2.w", f32, (w, 3), dev),
        _check(fc2["b"], "fc2.b", f32, (3,), dev),
        _check(window, "window", f32, (s, t, r, 3), dev),
        _check(coords, "coords", f32, (s, r, 3), dev),
        s, r, w, e, t, cfg.depth, int(cfg.predict_delta),
        float(cfg.head_scale), int(extrapolate), float(cfg.prior_damping),
        int(clip is not None), float(clip or 0.0), _cd_flag(cd),
        int(plan == "wide"), _stream(),
    ]
    _raise_on(_kernel("conv_head")(*args), "conv_head")
    profiling.count("conv_head")
    if plan == "wide":
        profiling.count("conv_head_wide")


def conv_head_clusters(num_nodes: int, width: int, max_edges: int,
                       cd, wide: bool = False) -> int:
    """How many of ``conv_head``'s clusters (one a stream) the card holds at
    once at these shapes, of the narrow plan (8 blocks) or the wide one (16
    blocks; 0 where the shapes have none): streams beyond that wait for a
    second wave."""
    out = ctypes.c_int(0)
    _raise_on(_kernel("conv_head_clusters")(
        num_nodes, width, max_edges, _cd_flag(cd), int(wide),
        ctypes.byref(out)), "conv_head_clusters")
    return out.value


_LAUNCHES = ("graph_encode", "edge_mlp", "conv_head", "conv_head_wide")


def launch_counts() -> dict:
    """Each kernel's launches, and ``conv_head_wide``: those of
    ``conv_head`` that took the wide plan."""
    now = profiling.counters()
    return {name: now.get(name, 0) for name in _LAUNCHES}


def reset_launch_counts() -> None:
    for name, n in launch_counts().items():
        profiling.count(name, -n)


# ---- the rollout --------------------------------------------------------

def _guard(cfg: ModelConfig) -> None:
    """The JAX kernel's refusals."""
    if not cfg.tie_edge_kernel:
        raise ValueError("persistent rollout requires tie_edge_kernel=True")
    if cfg.legacy_no_lstm:
        raise ValueError("persistent rollout does not implement the legacy "
                         "no-LSTM variant; use the rollout scan")
    if cfg.window_diff:
        raise ValueError("persistent rollout does not implement "
                         "window_diff=True; use the rollout scan")
    if cfg.kernel_quant != "none":
        raise ValueError("kernel_quant is not supported by the persistent "
                         "rollout kernels")
    if cfg.electrostatics not in ("none", "dh"):
        raise ValueError(f"unknown electrostatics: {cfg.electrostatics!r}")


def step(bufs: StepBuffers, weights, cfg: ModelConfig, threshold: float,
         clip, window: torch.Tensor, coords: torch.Tensor) -> None:
    """One rollout step: five launches on the current stream."""
    s, e = bufs.mask.shape
    graph_encode(window, weights, threshold, bufs)
    edge_mlp_stack(bufs.ef.view(s * e, 6), weights["mlp"],
                   bufs.mask.view(-1), bufs.h1, bufs.h2, bufs.kmat)
    conv_head(bufs, weights, cfg, clip, window, coords)


class _Graphed(NamedTuple):
    """The static window and coordinate block of one stream count's
    graphs, and their loop."""

    window: torch.Tensor
    coords: torch.Tensor
    loop: BlockLoop


class PreparedRollout:
    """A rollout with its preparation done once: the configuration is
    checked and the weights are cast when the object is made, and the step
    buffers are kept per stream count for its lifetime. On the card a call
    replays the captured block graphs of its stream count (captured on
    first use, one graph memory pool per object) and allocates only the
    coordinates and the final window. Not re-entrant: two calls at one
    stream count share their buffers, so a caller with several threads
    serialises its calls and keeps them on one stream."""

    def __init__(self, params, cfg: ModelConfig, aa, threshold: float = 8.0,
                 clip: float | None = None, device=None):
        _guard(cfg)
        self.cfg, self.threshold, self.clip = cfg, float(threshold), clip
        self.device = resolve_device(device)
        self.weights = rollout_weights(params, cfg, aa, self.device)
        self._buffers: dict = {}
        self._graphed: dict = {}
        self._pool = None

    def buffers(self, streams: int, num_nodes: int) -> StepBuffers:
        key = (streams, num_nodes)
        if key not in self._buffers:
            self._buffers[key] = alloc_buffers(self.cfg, streams, num_nodes,
                                               self.device)
        return self._buffers[key]

    def _window(self, window0):
        """(window0 as an (S, T, R, 3) f32 tensor on the device, batched)."""
        window = torch.as_tensor(window0, dtype=torch.float32,
                                 device=self.device)
        if window.dim() not in (3, 4):
            raise ValueError(f"window0 must be (T, R, 3) or (S, T, R, 3), "
                             f"got {tuple(window.shape)}")
        batched = window.dim() == 4
        return (window if batched else window[None]), batched

    def _result(self, coords, window, overflow, batched):
        diags = {"edge_overflow": overflow[0] > 0}
        if batched:
            return coords.transpose(0, 1).contiguous(), window, diags
        return coords[:, 0], window[0], diags

    def graphs(self, streams: int, frames: int, num_nodes: int) -> _Graphed:
        """The static buffers and block graphs of this stream count."""
        key = (streams, frames, num_nodes)
        if key not in self._graphed:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            bufs = self.buffers(streams, num_nodes)
            window = torch.zeros(streams, frames, num_nodes, 3,
                                 device=self.device)
            coords = torch.empty(GRAPH_BLOCK, streams, num_nodes, 3,
                                 device=self.device)

            # the closures hold no reference to self: the graphs are freed
            # with the object, not by a later garbage collection
            weights, cfg, threshold, clip = (self.weights, self.cfg,
                                             self.threshold, self.clip)

            def one_step(i):
                step(bufs, weights, cfg, threshold, clip, window, coords[i])

            def capture_block(n):
                return lambda: [one_step(i) for i in range(n)]

            self._graphed[key] = _Graphed(window, coords, BlockLoop(
                capture_block, lambda: one_step(0),
                f"rollout kernels, {streams} streams of {num_nodes} "
                f"residues", self._pool))
        return self._graphed[key]

    def __call__(self, window0, num_steps: int):
        """(coords, final_window, diags) of a ``num_steps`` rollout from
        window0 (T, R, 3) or (S, T, R, 3); coords is stream-major. The
        final window is the last T frames of [window0 ; coords], also when
        num_steps < T. On the card the step loop replays CUDA graphs; on
        the CPU it is ``eager``. The span ``rollout.call``."""
        with profiling.span("rollout.call"):
            return self._call(window0, num_steps)

    def _call(self, window0, num_steps: int):
        if self.device.type != "cuda":
            return self.eager(window0, num_steps)
        window, batched = self._window(window0)
        s, t, r, _ = window.shape
        g = self.graphs(s, t, r)
        g.loop.prepare(num_steps)
        bufs = self.buffers(s, r)
        g.window.copy_(window)
        bufs.overflow.zero_()
        coords = torch.empty(num_steps, s, r, 3, device=self.device)
        g.loop.run(num_steps, [(g.coords, coords)])
        return self._result(coords, g.window.clone(), bufs.overflow, batched)

    def eager(self, window0, num_steps: int):
        """The same rollout as ``__call__`` with the step loop issued from
        Python, five launches a step: the graphs' oracle."""
        window, batched = self._window(window0)
        window = window.clone().contiguous()
        s, _, r, _ = window.shape
        bufs = self.buffers(s, r)
        bufs.overflow.zero_()
        coords = torch.empty(num_steps, s, r, 3, device=self.device)
        for i in range(num_steps):
            step(bufs, self.weights, self.cfg, self.threshold, self.clip,
                 window, coords[i])
        return self._result(coords, window, bufs.overflow, batched)


def rollout_kernels(params, cfg: ModelConfig, aa, window0, num_steps: int,
                    threshold: float = 8.0, clip: float | None = None,
                    device=None):
    """(coords, final_window, diags) of a ``num_steps`` rollout from
    window0 (T, R, 3) or (S, T, R, 3)."""
    return PreparedRollout(params, cfg, aa, threshold, clip, device)(
        window0, num_steps)


def persistent_rollout(params, cfg: ModelConfig, aa, window0,
                       num_steps: int, threshold: float = 8.0,
                       clip: float | None = None, device=None):
    """The JAX kernel's call shape: (coords, diags). coords is
    (num_steps, R, 3) for one stream, (S, num_steps, R, 3) for S."""
    coords, _, diags = rollout_kernels(params, cfg, aa, window0, num_steps,
                                       threshold, clip, device)
    return coords, diags


def make_persistent_rollout_fn(cfg: ModelConfig, num_steps: int,
                               threshold: float = 8.0,
                               clip: float | None = None, device=None):
    """fn(params, aa, window0) -> (coords, final_window, diags), as
    ``make_rollout_fn``. The final window is the kernels' own window
    buffer: the last T frames of [window0 ; coords], also when
    num_steps < T.

    ``fn`` keeps the prepared rollout of its last parameters and
    sequence, with its buffers and CUDA graphs, so that repeated calls
    capture nothing again. ``fn.prepare(params, aa)`` returns
    ``run(window0)`` with the same result over a ``PreparedRollout`` of
    its own: the form for a caller that runs many rollouts of one model,
    such as the server."""
    _guard(cfg)
    dev = resolve_device(device)
    kept = KeepLast()

    def prepared_for(params, aa) -> PreparedRollout:
        key = tree_identity(params) + tree_identity(aa)
        if isinstance(aa, np.ndarray):
            key += (aa.tobytes(),)
        return kept.get(key, (params, aa), lambda: PreparedRollout(
            params, cfg, aa, threshold, clip, dev))

    def prepare(params, aa):
        prepared = PreparedRollout(params, cfg, aa, threshold, clip, dev)
        return lambda window0: prepared(window0, num_steps)

    def fn(params, aa, window0):
        return prepared_for(params, aa)(window0, num_steps)

    fn.prepare = prepare
    return fn
