"""Graph Kernel Network forward (``molecular_dynamics_neural_operator_tpu/models/gkn.py``).

``gkn_apply_single``: per-residue LSTM over the window (over
``[last frame ; scaled successive differences]`` under ``window_diff``,
none under ``legacy_no_lstm``, whose node features take the last frame
as it is), amino-acid embedding, fc1, 2*depth weight-tied edge convs
sharing one edge-kernel MLP (one stack of depth under
``legacy_no_lstm``), fc2 head with the optional residual prior. Any
leading axes of ``window`` and the graph are batch axes (the JAX
package's ``vmap`` written out). The graph is a ``DenseGraph`` (an
all-pairs adjacency: the masked kernel tensor is built once a forward,
``ops/edge_conv.py::masked_dense_kernels``) or a ``SparseGraph`` (a
padded edge list, aggregated by the ``scatter_mode`` that ``scatter_hint``,
``cfg.scatter_mode`` or the node count picks; with ``kernel_quant="int8"``
the kernel tensor is int8 and the per-edge scale rides on the message
mask). With ``fused_conv_vjp`` the tied one-hot stack runs through
``ops/conv_stack.tied_conv_stack`` and its hand-written backward, and
the tied dense stack, where its products run on bf16 tensor cores
(``ops/edge_conv.py::_bf16_product``), through
``ops/conv_stack.dense_tied_stack``.

``gkn_apply`` is the batched training and evaluation forward over a
``GKNBatch``. With ``train_conv_impl="pallas"`` (the JAX package's name
for its hand-written training kernel, kept so that one configuration
describes one model in both packages) the conv stack of a sparse batch
runs as the hand-written kernel of ``ops/cuda/train_conv.py``, forward and
backward: CUDA for CUDA tensors, its plain version for CPU tensors
(``takes_train_kernel`` has the rule). Everything else takes the
per-layer path through ``gkn_apply_single``.

With ``electrostatics="dh"`` the Debye-Hückel potential at each residue,
from the window's last frame, is the eighth fc1 input
(``preprocess/grid.py``). With ``conv_impl="pallas"`` (again the JAX
package's name) the edge MLP and both conv stacks of a sparse graph run as
the fused hand-written kernel of ``ops/cuda/fused_gkn.py``, forward only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import compute_dtype
from molecular_dynamics_neural_operator_tpu_torch.ops.conv_stack import (
    dense_tied_stack,
    tied_conv_stack,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.fused_gkn import (
    fused_conv_stack_from_graph,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.train_conv import (
    train_conv,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    degree_from_adjacency,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    SCATTER_ONEHOT_MAX_NODES,
    _bf16_product,
    edge_conv_dense,
    edge_conv_init,
    edge_conv_sparse,
    edge_kernel_matrices,
    masked_dense_kernels,
    quantize_kernels_int8,
    sparse_inv_degree,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.lstm import (
    lstm_apply,
    lstm_init,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import (
    linear_apply,
    linear_init,
    mlp_apply,
    mlp_init,
)
from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
    debye_huckel_at_atoms,
    residue_charges,
)


class DenseGraph(NamedTuple):
    """adj (..., R, R) 0/1 with [source, target] axes; edge_feats
    (..., R, R, 6) = [pos_src ; pos_dst]."""

    adj: torch.Tensor
    edge_feats: torch.Tensor


class SparseGraph(NamedTuple):
    """edges (..., 2, E) int32 [src; dst]; mask (..., E) f32;
    edge_feats (..., E, 6)."""

    edges: torch.Tensor
    mask: torch.Tensor
    edge_feats: torch.Tensor


Graph = Union[DenseGraph, SparseGraph]


class GKNBatch(NamedTuple):
    """One training or evaluation batch: aa (R,) int amino-acid labels
    (one protein for the whole batch), window (B, T, R, 3), graph with a
    leading batch axis B, y (B, R, 3) targets."""

    aa: torch.Tensor
    window: torch.Tensor
    graph: Graph
    y: torch.Tensor


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError``, as the JAX package does, for an unknown
    ``train_conv_impl``, ``conv_impl``, ``electrostatics`` or
    ``kernel_quant`` and for ``legacy_no_lstm`` with the fused kernel."""
    if cfg.train_conv_impl not in ("xla", "pallas"):
        raise ValueError(
            f"unknown train_conv_impl: {cfg.train_conv_impl!r}")
    if cfg.conv_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown conv_impl: {cfg.conv_impl!r}")
    if cfg.electrostatics not in ("none", "dh"):
        raise ValueError(f"unknown electrostatics: {cfg.electrostatics!r}")
    if cfg.kernel_quant not in ("none", "int8"):
        raise ValueError(f"unknown kernel_quant: {cfg.kernel_quant!r}")
    if cfg.legacy_no_lstm and cfg.conv_impl == "pallas":
        raise ValueError(
            "legacy_no_lstm (single conv stack) supports conv_impl='xla' "
            "only: the fused kernel bakes in both stacks")


def _node_in_features(cfg: ModelConfig) -> int:
    """fc1 input width: the 7 base features plus the electrostatic
    potential under ``electrostatics="dh"``."""
    return cfg.node_features + (1 if cfg.electrostatics == "dh" else 0)


def gkn_init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random parameters with the JAX package's structure and shapes (the
    values differ: a torch generator is not JAX's PRNG)."""
    gen = torch.Generator().manual_seed(seed)
    w = cfg.width
    emb = torch.randn(cfg.num_embeddings, cfg.embedding_dim, generator=gen)
    params = {
        "emb": emb.to(device),
        "lstm": lstm_init(gen, cfg.x_position_dim, cfg.x_position_dim, device),
        "lstm_fc": linear_init(gen, cfg.x_position_dim, cfg.x_position_dim,
                               device),
        "fc1": linear_init(gen, _node_in_features(cfg), w, device),
        "edge_kernel": mlp_init(
            gen, [cfg.edge_features, cfg.ker_width, cfg.ker_width, w * w],
            device),
        "conv1": edge_conv_init(gen, w, device),
        "conv2": edge_conv_init(gen, w, device),
        "fc2": linear_init(gen, w, cfg.out_width, device),
    }
    if cfg.legacy_no_lstm:
        # no window encoder and one conv stack
        for name in ("lstm", "lstm_fc", "conv2"):
            del params[name]
    if not cfg.tie_edge_kernel:
        params["edge_kernel2"] = mlp_init(
            gen, [cfg.edge_features, cfg.ker_width, cfg.ker_width, w * w],
            device)
    if cfg.head_init == "zero":
        params["fc2"] = {k: torch.zeros_like(v)
                         for k, v in params["fc2"].items()}
    elif cfg.head_init != "default":
        raise ValueError(f"unknown head_init: {cfg.head_init!r}")
    if cfg.kernel_init_scale != 1.0:
        for name in ("edge_kernel", "edge_kernel2"):
            if name in params:
                last = params[name][f"layer_{len(params[name]) - 1}"]
                for k in last:
                    last[k] = last[k] * cfg.kernel_init_scale
    return params


def lift_nodes(params, emb_aa, h, phi=None):
    """[embedding rows emb_aa (R, D) or (..., R, D) ; h (..., R, 3)
    [; the potential phi (..., R)]] -> fc1 -> ReLU: (..., R, width)."""
    feats = [emb_aa.expand(h.shape[:-1] + (-1,)), h]
    if phi is not None:
        feats.append(phi[..., None])
    return torch.relu(linear_apply(params["fc1"], torch.cat(feats, dim=-1)))


def encode_nodes(params, emb_aa, window, phi=None):
    """window (..., T, R, 3) -> node features (..., R, width): LSTM over
    time, lstm_fc, then ``lift_nodes``. All f32."""
    h = lstm_apply(params["lstm"], window.movedim(-3, 0))       # (..., R, 3)
    return lift_nodes(params, emb_aa, linear_apply(params["lstm_fc"], h),
                      phi)


def dh_potential(cfg: ModelConfig, charges, frame):
    """The Debye-Hückel node feature of ``frame`` (..., R, 3) with the
    configuration's solvent; charges (R,) or (..., R)."""
    return debye_huckel_at_atoms(
        frame, charges, eps_s=cfg.eps_solvent, temperature=cfg.temperature,
        ionic_strength_M=cfg.ionic_strength)


def _encode_nodes(params, cfg: ModelConfig, aa, window):
    """aa (R,) or, one sequence per leading index of window, (..., R)."""
    phi = None
    if cfg.electrostatics == "dh":
        # from the window's last frame: recomputed from the predicted
        # coordinates at every rollout step
        phi = dh_potential(cfg, residue_charges(aa), window[..., -1, :, :])
    emb = params["emb"][aa.long()]
    if cfg.legacy_no_lstm:
        return lift_nodes(params, emb, window[..., -1, :, :], phi)
    if cfg.window_diff:
        # [last frame ; scaled successive differences]: the same (T, R, 3)
        diffs = (window[..., 1:, :, :] - window[..., :-1, :, :]) \
            * cfg.window_diff_scale
        window = torch.cat([window[..., -1:, :, :], diffs], dim=-3)
    return encode_nodes(params, emb, window, phi)


def residual_prior(cfg: ModelConfig, window):
    """Base forecast the predict_delta head corrects; window (..., T, R, 3).
    "last" is copy-last, "extrapolate" is x_t + gamma (x_t - x_{t-1})."""
    last = window[..., -1, :, :]
    if cfg.predict_prior == "last":
        return last
    if cfg.predict_prior == "extrapolate":
        if window.shape[-3] < 2:
            raise ValueError(
                "predict_prior='extrapolate' needs a window of >= 2 "
                f"frames, got window_size={window.shape[-3]}")
        return last + cfg.prior_damping * (last - window[..., -2, :, :])
    raise ValueError(f"unknown predict_prior: {cfg.predict_prior!r}")


def _scatter_mode(cfg: ModelConfig, num_nodes: int,
                  scatter_hint: Optional[str]) -> str:
    """The JAX rule: the hint, else a ``cfg.scatter_mode`` other than
    "auto", else "onehot" up to 512 nodes and "segment" above."""
    if cfg.scatter_mode != "auto" and scatter_hint is None:
        scatter_hint = cfg.scatter_mode
    return scatter_hint or ("onehot" if num_nodes <= SCATTER_ONEHOT_MAX_NODES
                            else "segment")


def _tied_stack(cfg: ModelConfig) -> bool:
    """Whether the conv stack may run as one function with a hand-written
    backward: ``fused_conv_vjp`` on two stacks of one tied kernel."""
    return (cfg.fused_conv_vjp and cfg.tie_edge_kernel and cfg.depth > 0
            and not cfg.legacy_no_lstm)


def gkn_apply_single(params, cfg: ModelConfig, aa, window, graph: Graph,
                     return_latent: bool = False,
                     scatter_hint: Optional[str] = None):
    """Forward one example (or a batch along leading axes).
    window (..., T, R, 3) -> (..., R, out_width). ``scatter_hint``
    overrides the sparse aggregation choice (``_scatter_mode``); pass
    "blocked" only for graphs in the cell-list block layout."""
    check_supported(cfg)
    dense = isinstance(graph, DenseGraph)
    if cfg.kernel_quant != "none" and (dense or cfg.conv_impl == "pallas"):
        raise ValueError(
            "kernel_quant='int8' requires the sparse XLA conv path "
            "(graph_mode='sparse', conv_impl='xla'): the dense and "
            "fused paths keep the kernel tensor in the compute dtype")
    cd = compute_dtype(cfg)
    x = _encode_nodes(params, cfg, aa, window)
    stacks = (("conv1", "edge_kernel"),) if cfg.legacy_no_lstm else (
        ("conv1", "edge_kernel"),
        ("conv2", "edge_kernel" if cfg.tie_edge_kernel else "edge_kernel2"))
    if dense:
        inv_deg = 1.0 / degree_from_adjacency(graph.adj)
        masked = {}
        for _, mlp in stacks:
            if mlp not in masked:
                k = edge_kernel_matrices(params[mlp], graph.edge_feats,
                                         cfg.width, cd)
                masked[mlp] = masked_dense_kernels(k, graph.adj, cd)
        if _tied_stack(cfg) and _bf16_product(masked["edge_kernel"]):
            # hand-written backward over the whole tied stack: dK is one
            # product over the layer axis (ops/conv_stack.py)
            x = dense_tied_stack(
                cfg.depth, x, masked["edge_kernel"], inv_deg,
                params["conv1"]["root"], params["conv1"]["bias"],
                params["conv2"]["root"], params["conv2"]["bias"])
        else:
            for conv, mlp in stacks:
                for _ in range(cfg.depth):
                    x = torch.relu(edge_conv_dense(
                        params[conv], x, masked[mlp], inv_deg, cd))
        return _head(params, cfg, window, x, return_latent)
    if cfg.conv_impl == "pallas":
        # edge MLP and both conv stacks as one hand-written kernel
        x = fused_conv_stack_from_graph(params, cfg, x, graph.edges,
                                        graph.mask, graph.edge_feats)
        return _head(params, cfg, window, x, return_latent)
    scatter = _scatter_mode(cfg, window.shape[-2], scatter_hint)
    inv_deg = sparse_inv_degree(graph.edges, graph.mask, window.shape[-2],
                                scatter)
    kernels, msg_mask = {}, {}
    for _, mlp in stacks:
        if mlp in kernels:
            continue
        k = edge_kernel_matrices(params[mlp], graph.edge_feats, cfg.width,
                                 cd)
        msg_mask[mlp] = graph.mask
        if cfg.kernel_quant == "int8":
            # the degree stays the unscaled mask's; the messages carry
            # the per-edge scale
            k, kscale = quantize_kernels_int8(k)
            msg_mask[mlp] = graph.mask * kscale
        kernels[mlp] = k
    if (_tied_stack(cfg) and scatter == "onehot"
            and cfg.kernel_quant == "none"):
        # hand-written backward over the whole tied stack: one-pass
        # kernel-tensor gradient (ops/conv_stack.py)
        x = tied_conv_stack(
            cfg.depth, cd, x, kernels["edge_kernel"], graph.edges,
            graph.mask, inv_deg,
            params["conv1"]["root"], params["conv1"]["bias"],
            params["conv2"]["root"], params["conv2"]["bias"])
    else:
        for conv, mlp in stacks:
            for _ in range(cfg.depth):
                x = torch.relu(edge_conv_sparse(
                    params[conv], x, kernels[mlp], graph.edges,
                    msg_mask[mlp], inv_deg, scatter, cd))
    return _head(params, cfg, window, x, return_latent)


def _head(params, cfg: ModelConfig, window, x, return_latent: bool):
    """fc2 on the conv stack's output x, plus the prior under
    ``predict_delta``; x is the latent."""
    out = linear_apply(params["fc2"], x)
    if cfg.predict_delta:
        out = cfg.head_scale * out + residual_prior(cfg, window)
    if return_latent:
        return out, x
    return out


def takes_train_kernel(cfg: ModelConfig, batch: GKNBatch) -> bool:
    """The JAX package's dispatch rule for ``train_conv_impl="pallas"``:
    a sparse graph (in any edge layout: the kernel reads the edge indices,
    not the slot positions), a tied edge kernel, depth > 0, no
    quantization, the LSTM encoder (``window_diff`` included) and at most
    512 nodes. Anything else takes the per-layer path.

    Every width takes the kernel, as the JAX package's every width takes
    its Pallas kernel: CPU tensors its plain version, CUDA tensors the
    training kernels, which pad a width that is not a multiple of 8 to one
    (``ops/cuda/train_conv.py``). A shape past the kernels' plan (a width
    over 128 in f32 or 256 in bf16, or buffers past a block's shared
    memory) raises ``ValueError`` before any launch."""
    return (cfg.train_conv_impl == "pallas"
            and isinstance(batch.graph, SparseGraph)
            and cfg.tie_edge_kernel and cfg.depth > 0
            and cfg.kernel_quant == "none"
            and not cfg.legacy_no_lstm
            and batch.aa.shape[0] <= SCATTER_ONEHOT_MAX_NODES)


def gkn_apply(params, cfg: ModelConfig, batch: GKNBatch,
              return_latent: bool = False,
              scatter_hint: Optional[str] = None):
    """Batched forward over ``batch.window`` and ``batch.graph``:
    (B, R, out_width) [and the (B, R, width) latent]. ``scatter_hint``
    overrides ``cfg.scatter_mode`` on the per-layer path: callers whose
    graphs were rebuilt on the device pass
    ``rollout.scan.rebuilt_scatter_hint``, so that a "blocked" dataset
    layout never reduces a CSR-packed rebuild. The kernel path reads the
    edge indices and ignores it."""
    if takes_train_kernel(cfg, batch):
        return _gkn_apply_kernel_batched(params, cfg, batch, return_latent)
    return gkn_apply_single(params, cfg, batch.aa, batch.window, batch.graph,
                            return_latent, scatter_hint=scatter_hint)


def _gkn_apply_kernel_batched(params, cfg: ModelConfig, batch: GKNBatch,
                              return_latent: bool):
    """The forward with the conv stack as one kernel over the batch
    (``ops/cuda/train_conv.py``). The kernel tensor is made once, in the
    compute dtype, and pre-masked; the kernels read the mask only to skip
    padded slots."""
    check_supported(cfg)
    cd = compute_dtype(cfg)
    graph = batch.graph
    r = batch.aa.shape[0]
    x = _encode_nodes(params, cfg, batch.aa, batch.window)       # (B, R, w)
    kt = mlp_apply(params["edge_kernel"], graph.edge_feats,
                   compute_dtype=cd).to(cd)
    kt = kt * graph.mask[..., None].to(cd)                       # (B, E, w^2)
    inv_deg = sparse_inv_degree(graph.edges, graph.mask, r)
    x = train_conv(
        x.contiguous(), kt, graph.edges.to(torch.int32).contiguous(),
        graph.mask.to(torch.float32).contiguous(), inv_deg.contiguous(),
        params["conv1"]["root"], params["conv1"]["bias"],
        params["conv2"]["root"], params["conv2"]["bias"], cfg.depth)
    return _head(params, cfg, batch.window, x, return_latent)
