"""Graph Kernel Network forward (``molecular_dynamics_neural_operator_tpu/models/gkn.py``).

The sparse one-hot path of ``gkn_apply_single``: per-residue LSTM over the
window, amino-acid embedding, fc1, 2*depth weight-tied edge convs sharing
one edge-kernel MLP, fc2 head with the optional residual prior. Any
leading axes of ``window`` and the graph are batch axes (the JAX
package's ``vmap`` written out). With ``fused_conv_vjp`` the tied stack
runs through ``ops/conv_stack.tied_conv_stack`` and its hand-written
backward; both forms are differentiable.

``gkn_apply`` is the batched training and evaluation forward over a
``GKNBatch``. With ``train_conv_impl="pallas"`` (the JAX package's name
for its hand-written training kernel, kept so that one configuration
describes one model in both packages) the conv stack runs as the
hand-written kernel of ``ops/cuda/train_conv.py``, forward and backward:
CUDA for CUDA tensors, its plain version for CPU tensors. ``"xla"``
selects the per-layer path through ``gkn_apply_single``.

With ``electrostatics="dh"`` the Debye-Hückel potential at each residue,
from the window's last frame, is the eighth fc1 input
(``preprocess/grid.py``). With ``conv_impl="pallas"`` (again the JAX
package's name) the edge MLP and both conv stacks run as the fused
hand-written kernel of ``ops/cuda/fused_gkn.py``, forward only.

Not ported yet (``NotImplementedError``): dense graphs, ``window_diff``,
``legacy_no_lstm``, ``kernel_quant="int8"`` and the segment/blocked
scatter modes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import compute_dtype
from molecular_dynamics_neural_operator_tpu_torch.ops.conv_stack import (
    tied_conv_stack,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.fused_gkn import (
    fused_conv_stack_from_graph,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.train_conv import (
    train_conv,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    SCATTER_ONEHOT_MAX_NODES,
    edge_conv_init,
    edge_conv_sparse,
    edge_kernel_matrices,
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


class SparseGraph(NamedTuple):
    """edges (..., 2, E) int32 [src; dst]; mask (..., E) f32;
    edge_feats (..., E, 6)."""

    edges: torch.Tensor
    mask: torch.Tensor
    edge_feats: torch.Tensor


class GKNBatch(NamedTuple):
    """One training or evaluation batch: aa (R,) int amino-acid labels
    (one protein for the whole batch), window (B, T, R, 3), graph with a
    leading batch axis B, y (B, R, 3) targets."""

    aa: torch.Tensor
    window: torch.Tensor
    graph: SparseGraph
    y: torch.Tensor


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the options the port does not cover yet. Ported: the
    sparse one-hot forward (rollout and training), both priors,
    ``head_scale``, tied and untied edge kernels, ``fused_conv_vjp``,
    ``electrostatics="dh"`` and both values of ``train_conv_impl`` and
    ``conv_impl``."""
    if cfg.train_conv_impl not in ("xla", "pallas"):
        raise ValueError(
            f"unknown train_conv_impl: {cfg.train_conv_impl!r}")
    if cfg.conv_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown conv_impl: {cfg.conv_impl!r}")
    if cfg.electrostatics not in ("none", "dh"):
        raise ValueError(f"unknown electrostatics: {cfg.electrostatics!r}")
    if cfg.legacy_no_lstm and cfg.conv_impl == "pallas":
        raise ValueError(
            "legacy_no_lstm (single conv stack) supports conv_impl='xla' "
            "only: the fused kernel bakes in both stacks")
    for flag, name in ((cfg.window_diff, "window_diff"),
                       (cfg.legacy_no_lstm, "legacy_no_lstm")):
        if flag:
            raise NotImplementedError(f"{name}=True is not ported yet")
    if cfg.graph_mode != "sparse":
        raise NotImplementedError("only graph_mode='sparse' is ported")
    if cfg.kernel_quant != "none":
        raise NotImplementedError("kernel_quant='int8' is not ported yet")
    if cfg.scatter_mode not in ("auto", "onehot"):
        raise NotImplementedError(
            f"scatter_mode={cfg.scatter_mode!r} is not ported yet")
    if cfg.neighbor_impl != "dense_rank":
        raise NotImplementedError(
            f"neighbor_impl={cfg.neighbor_impl!r} is not ported yet")


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


def encode_nodes(params, emb_aa, window, phi=None):
    """window (..., T, R, 3) + embedding rows emb_aa (R, D) or (..., R, D)
    -> node features (..., R, width): LSTM over time, lstm_fc, concat with
    the embedding [and the potential phi (..., R)], fc1, ReLU. All f32."""
    h = lstm_apply(params["lstm"], window.movedim(-3, 0))       # (..., R, 3)
    h = linear_apply(params["lstm_fc"], h)
    feats = [emb_aa.expand(h.shape[:-1] + (-1,)), h]
    if phi is not None:
        feats.append(phi[..., None])
    return torch.relu(linear_apply(params["fc1"], torch.cat(feats, dim=-1)))


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
    return encode_nodes(params, params["emb"][aa.long()], window, phi)


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


def gkn_apply_single(params, cfg: ModelConfig, aa, window,
                     graph: SparseGraph, return_latent: bool = False,
                     tensor_cores: bool = False):
    """Forward one example (or a batch along leading axes).
    window (..., T, R, 3) -> (..., R, out_width). ``tensor_cores`` is
    passed to the edge-kernel MLP (``ops/mlp.py``)."""
    check_supported(cfg)
    if not isinstance(graph, SparseGraph):
        raise NotImplementedError("dense graphs are not ported yet")
    num_nodes = window.shape[-2]
    if num_nodes > SCATTER_ONEHOT_MAX_NODES:
        raise NotImplementedError(
            "more than 512 nodes needs the segment scatter, not ported yet")
    cd = compute_dtype(cfg)
    x = _encode_nodes(params, cfg, aa, window)
    if cfg.conv_impl == "pallas":
        # edge MLP and both conv stacks as one hand-written kernel
        x = fused_conv_stack_from_graph(params, cfg, x, graph.edges,
                                        graph.mask, graph.edge_feats)
        return _head(params, cfg, window, x, return_latent)
    k1 = edge_kernel_matrices(params["edge_kernel"], graph.edge_feats,
                              cfg.width, cd, tensor_cores)
    k2 = k1 if cfg.tie_edge_kernel else edge_kernel_matrices(
        params["edge_kernel2"], graph.edge_feats, cfg.width, cd,
        tensor_cores)
    inv_deg = sparse_inv_degree(graph.edges, graph.mask, num_nodes)
    if cfg.fused_conv_vjp and cfg.tie_edge_kernel and cfg.depth > 0:
        # hand-written backward over the whole tied stack: one-pass
        # kernel-tensor gradient (ops/conv_stack.py)
        x = tied_conv_stack(
            cfg.depth, cd, x, k1, graph.edges, graph.mask, inv_deg,
            params["conv1"]["root"], params["conv1"]["bias"],
            params["conv2"]["root"], params["conv2"]["bias"])
    else:
        for conv, kernels in (("conv1", k1), ("conv2", k2)):
            for _ in range(cfg.depth):
                x = torch.relu(edge_conv_sparse(
                    params[conv], x, kernels, graph.edges, graph.mask,
                    inv_deg, "onehot", cd))
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
    a sparse graph, a tied edge kernel, depth > 0, no quantization, the
    LSTM encoder and at most 512 nodes. Anything else takes the per-layer
    path.

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
              return_latent: bool = False):
    """Batched forward over ``batch.window`` and ``batch.graph``:
    (B, R, out_width) [and the (B, R, width) latent]."""
    if takes_train_kernel(cfg, batch):
        return _gkn_apply_kernel_batched(params, cfg, batch, return_latent)
    return gkn_apply_single(params, cfg, batch.aa, batch.window, batch.graph,
                            return_latent, tensor_cores=True)


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
    kt = mlp_apply(params["edge_kernel"], graph.edge_feats, compute_dtype=cd,
                   tensor_cores=True).to(cd)
    kt = kt * graph.mask[..., None].to(cd)                       # (B, E, w^2)
    inv_deg = sparse_inv_degree(graph.edges, graph.mask, r)
    x = train_conv(
        x.contiguous(), kt, graph.edges.to(torch.int32).contiguous(),
        graph.mask.to(torch.float32).contiguous(), inv_deg.contiguous(),
        params["conv1"]["root"], params["conv1"]["bias"],
        params["conv2"]["root"], params["conv2"]["bias"], cfg.depth)
    return _head(params, cfg, batch.window, x, return_latent)
