"""Autoregressive free rollout (``molecular_dynamics_neural_operator_tpu/rollout/scan.py``).

Each step rebuilds the contact graph from the window's last (or first)
frame (all pairs under ``graph_mode="dense"``, a padded edge list under
``"sparse"``: ranked from the contact map, or under
``neighbor_impl="cell_list"`` from the O(N) cell list of
``geometry/cells.py`` in the block layout), runs the GKN forward,
optionally clips the prediction and slides the window. The JAX ``lax.scan`` becomes a Python loop over plain tensor
ops; the edge-overflow flag stays a device tensor, so the loop never waits
on the card. This is the plain counterpart of the CUDA rollout
(``ops/cuda/persistent_rollout.py``) and its oracle on the card.

On the card ``make_rollout_fn`` runs the loop as replays of a block of
steps captured once as a CUDA graph (``ScanGraphs``, the counterpart of
the JAX package's ``jax.jit`` of the whole scan), on the dense and the
sparse graph alike; the cell list stays eager
(``ops/cuda/graphs.py::stays_eager``).
``rollout_scan`` is the loop issued op by op, the graphs' oracle.

``rollout_with_mse`` tracks each step's coordinate MSE against a true
continuation; ``rollout_python_loop`` reads every step back to the host,
the reference's loop shape, as an oracle and a baseline, not a fast path.
"""

from __future__ import annotations

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.geometry.cells import (
    cell_list_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    contact_map,
    dense_edge_features,
    edge_features_from_edges,
    padded_edges_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    DenseGraph,
    SparseGraph,
    check_supported,
    gkn_apply_single,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    KeepLast,
    StepGraphs,
    stays_eager,
    tree_identity,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    SCATTER_ONEHOT_MAX_NODES,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import span

COLLECT_MODES = ("coords", "contact_maps", "both")


def rebuilt_scatter_hint(cfg: ModelConfig, num_nodes: int) -> str | None:
    """Aggregation of a graph REBUILT on the device in a rollout or
    curriculum step. A rebuild is never in the dataset's edge layout:
    ``padded_edges_device`` packs it front to back, the cell list emits
    the block layout. ``cfg.scatter_mode`` describes
    the dataset's graphs (``edge_layout="blocked"``) and must not reach a
    rebuild, where "blocked" would sum unrelated slots into each node.
    None in dense mode, which has no scatter."""
    if cfg.graph_mode != "sparse":
        return None
    if (cfg.neighbor_impl == "cell_list"
            and num_nodes > SCATTER_ONEHOT_MAX_NODES):
        return "blocked"
    return "onehot" if num_nodes <= SCATTER_ONEHOT_MAX_NODES else "segment"


def _build_graph(cfg: ModelConfig, frame, threshold: float):
    """(graph, overflow) of frame (..., R, 3); overflow (...) is True where
    the rebuild lost edges to a static capacity: ``cfg.max_edges`` for the
    ranked rebuild, the cell capacity or ``cfg.max_degree`` for the cell
    list; never in dense mode."""
    check_supported(cfg)
    if cfg.graph_mode == "dense":
        overflow = torch.zeros(frame.shape[:-2], dtype=torch.bool,
                               device=frame.device)
        return DenseGraph(adj=contact_map(frame, threshold),
                          edge_feats=dense_edge_features(frame)), overflow
    if cfg.neighbor_impl == "cell_list":
        out = cell_list_edges(frame, threshold, cfg.max_degree,
                              cfg.cell_capacity, cfg.num_cells)
        graph = SparseGraph(edges=out.edges, mask=out.mask,
                            edge_feats=edge_features_from_edges(frame,
                                                                out.edges))
        return graph, out.cell_overflow | out.degree_overflow
    adj = contact_map(frame, threshold)
    edges, mask, count = padded_edges_device(adj, cfg.max_edges,
                                             return_count=True)
    graph = SparseGraph(edges=edges, mask=mask,
                        edge_feats=edge_features_from_edges(frame, edges))
    return graph, count > cfg.max_edges


def _step(params, cfg: ModelConfig, aa, window, threshold: float,
          graph_frame: str, clip: float | None = None):
    frame = window[..., -1, :, :] if graph_frame == "last" \
        else window[..., 0, :, :]
    graph, overflow = _build_graph(cfg, frame, threshold)
    # the rebuild's layout is this step's, not cfg.scatter_mode's
    out = gkn_apply_single(params, cfg, aa, window, graph,
                           scatter_hint=rebuilt_scatter_hint(
                               cfg, window.shape[-2]))
    if clip is not None:
        out = torch.clamp(out, -clip, clip)
    new_window = torch.cat([window[..., 1:, :, :], out[..., None, :, :]],
                           dim=-3)
    return new_window, out, overflow


def rollout_scan(params, cfg: ModelConfig, aa, window0, num_steps: int,
                 threshold: float = 8.0, graph_frame: str = "last",
                 collect: str = "coords", clip: float | None = None):
    """Roll ``num_steps`` steps from window0 (..., T, R, 3); aa is (R,),
    or (..., R) with one sequence per leading index.

    collect: "coords" -> (..., num_steps, R, 3); "contact_maps" ->
    (..., num_steps, R, R); "both" -> the tuple of the two. Returns
    (collected, final_window, {"edge_overflow": bool tensor (...)})."""
    if graph_frame not in ("last", "first"):
        raise ValueError(f"unknown graph_frame: {graph_frame!r} "
                         "(expected 'last' or 'first')")
    if collect not in COLLECT_MODES:
        raise ValueError(f"unknown collect mode: {collect}")
    window = window0
    overflowed = torch.zeros(window0.shape[:-3], dtype=torch.bool,
                             device=window0.device)
    ys = []
    for _ in range(num_steps):
        window, out, overflow = _step(params, cfg, aa, window, threshold,
                                      graph_frame, clip)
        overflowed = overflowed | overflow
        ys.append(collected_outputs(out, collect, threshold))
    return stacked_outputs(ys, collect, window0.dim() - 3), window, {
        "edge_overflow": overflowed}


def rollout_scan_chunked(params, cfg: ModelConfig, aa, window0,
                         num_steps: int, stream_chunk: int | None,
                         threshold: float = 8.0, graph_frame: str = "last",
                         collect: str = "coords", clip: float | None = None):
    """``rollout_scan`` of window0 (S, T, R, 3) with the streams taken in
    sequential chunks of ``stream_chunk``: the live kernel tensors are
    (C, E, w, w) instead of (S, E, w, w), the work is the same. aa is
    (R,) or, one sequence per stream, (S, R). ``None`` runs all streams
    at once."""
    def run(a, w):
        return rollout_scan(params, cfg, a, w, num_steps, threshold,
                            graph_frame, collect, clip)

    s = window0.shape[0]
    if stream_chunk is None:
        return run(aa, window0)
    if s % stream_chunk:
        raise ValueError(f"stream count {s} not divisible by stream_chunk "
                         f"{stream_chunk}")
    parts = [run(aa[i:i + stream_chunk] if aa.dim() == 2 else aa,
                 window0[i:i + stream_chunk])
             for i in range(0, s, stream_chunk)]
    return _cat_parts(parts)


def collected_outputs(out, collect: str, threshold: float) -> tuple:
    """What ``collect`` keeps of a step's coordinates ``out``, as a tuple
    (coordinates, contact map or both)."""
    if collect == "coords":
        return (out,)
    maps = contact_map(out, threshold)
    return (maps,) if collect == "contact_maps" else (out, maps)


def collected(outputs: tuple, collect: str):
    """The collected result of stacked ``collected_outputs``: the tuple
    under ``collect="both"``, else its one tensor."""
    return tuple(outputs) if collect == "both" else outputs[0]


def stacked_outputs(ys: list, collect: str, step_axis: int):
    """``collected`` of each step's ``collected_outputs`` in ``ys``,
    stacked on ``step_axis``."""
    return collected(tuple(torch.stack(group, dim=step_axis)
                           for group in zip(*ys)), collect)


class ScanGraphs:
    """``rollout_scan`` of one model on the card as CUDA graphs: for each
    window and sequence shape, static inputs and outputs and a block of
    ``_step`` captured over them (``ops/cuda/graphs.py::StepGraphs``), all
    in one graph memory pool. The graphs read ``params`` where they are,
    and the fused kernel's cast of them (``conv_impl="pallas"``) is one
    of their operations, so an in-place change of the parameters reaches
    them. Calls are serialised by the caller, on one stream."""

    def __init__(self, params, cfg: ModelConfig, threshold: float = 8.0,
                 graph_frame: str = "last", collect: str = "coords",
                 clip: float | None = None):
        if graph_frame not in ("last", "first"):
            raise ValueError(f"unknown graph_frame: {graph_frame!r} "
                             "(expected 'last' or 'first')")
        if collect not in COLLECT_MODES:
            raise ValueError(f"unknown collect mode: {collect}")
        self.collect = collect

        def step(inputs, window):
            window, out, overflow = _step(params, cfg, inputs[0], window,
                                          threshold, graph_frame, clip)
            return window, collected_outputs(out, collect, threshold), \
                overflow

        self._graphs = StepGraphs(step, "rollout scan")

    def __call__(self, aa, window0, num_steps: int):
        """``rollout_scan(params, cfg, aa, window0, num_steps, ...)``."""
        outs, window, overflow = self._graphs((aa,), window0, num_steps)
        return collected(outs, self.collect), window, {
            "edge_overflow": overflow}

    def chunked(self, aa, window0, num_steps: int,
                stream_chunk: int | None):
        """``rollout_scan_chunked``: the chunks in sequence through the
        graphs of one chunk's shape."""
        s = window0.shape[0]
        if stream_chunk is None:
            return self(aa, window0, num_steps)
        if s % stream_chunk:
            raise ValueError(f"stream count {s} not divisible by "
                             f"stream_chunk {stream_chunk}")
        parts = [self(aa[i:i + stream_chunk] if aa.dim() == 2 else aa,
                      window0[i:i + stream_chunk], num_steps)
                 for i in range(0, s, stream_chunk)]
        return _cat_parts(parts)


def _cat_parts(parts):
    def cat(xs):
        if isinstance(xs[0], tuple):
            return tuple(cat(list(group)) for group in zip(*xs))
        return torch.cat(xs, dim=0)

    return (cat([p[0] for p in parts]), cat([p[1] for p in parts]),
            {"edge_overflow": cat([p[2]["edge_overflow"] for p in parts])})


def make_rollout_fn(cfg: ModelConfig, num_steps: int, threshold: float = 8.0,
                    graph_frame: str = "last", collect: str = "coords",
                    batched: bool = False, clip: float | None = None,
                    stream_chunk: int | None = None, device=None):
    """fn(params, aa, window0) -> (collected, final_window, diags) on
    ``device`` (``cuda`` unless the caller asks for the CPU). With
    ``batched=True`` window0 is (S, T, R, 3): S independent streams,
    stream-major outputs, aa (R,) for one protein or (S, R) for one
    sequence per stream. ``stream_chunk=C`` (batched only, S % C == 0)
    runs the streams in sequential chunks of C.

    On the card ``fn`` replays the CUDA graphs of a ``ScanGraphs`` that it
    keeps while the parameters are the same tensors at the same versions,
    so that repeated calls capture nothing again (the cell list, which
    stays eager, excepted). ``fn.eager`` is the loop issued op by op. A
    call of ``fn`` is the span ``rollout.call``."""
    if stream_chunk is not None and not batched:
        raise ValueError("stream_chunk only applies to batched=True "
                         "rollouts (single-stream has no stream axis)")
    dev = resolve_device(device)
    kept = KeepLast()

    def inputs(aa, window0):
        window0 = torch.as_tensor(window0, dtype=torch.float32, device=dev)
        if window0.dim() != (4 if batched else 3):
            raise ValueError(
                f"window0 must be {'(S, T, R, 3)' if batched else '(T, R, 3)'}"
                f", got {tuple(window0.shape)}")
        return torch.as_tensor(aa, device=dev), window0

    def eager(params, aa, window0):
        aa, window0 = inputs(aa, window0)
        if batched:
            return rollout_scan_chunked(params, cfg, aa, window0, num_steps,
                                        stream_chunk, threshold, graph_frame,
                                        collect, clip)
        return rollout_scan(params, cfg, aa, window0, num_steps, threshold,
                            graph_frame, collect, clip)

    def call(params, aa, window0):
        if dev.type != "cuda" or stays_eager(cfg):
            return eager(params, aa, window0)
        aa, window0 = inputs(aa, window0)
        graphs = kept.get(tree_identity(params), params,
                          lambda: ScanGraphs(params, cfg, threshold,
                                             graph_frame, collect, clip))
        return graphs.chunked(aa, window0, num_steps,
                                      stream_chunk if batched else None)

    def fn(params, aa, window0):
        with span("rollout.call"):
            return call(params, aa, window0)

    fn.eager = eager
    return fn


def rollout_with_mse(params, cfg: ModelConfig, aa, window0, truth,
                     threshold: float = 8.0, graph_frame: str = "last",
                     clip: float | None = None):
    """Roll ``truth.shape[0]`` steps from window0 (T, R, 3) and score each
    against truth (num_steps, R, 3): (coords (num_steps, R, 3), per-step
    MSE (num_steps,), final window), all on the window's device."""
    window, coords, mses = window0, [], []
    for y_true in truth:
        window, out, _ = _step(params, cfg, aa, window, threshold,
                               graph_frame, clip)
        coords.append(out)
        mses.append(torch.mean((out - y_true) ** 2))
    if not coords:
        return truth[:0].clone(), truth.new_zeros((0,)), window
    return torch.stack(coords), torch.stack(mses), window


def rollout_python_loop(params, cfg: ModelConfig, aa, window0,
                        num_steps: int, threshold: float = 8.0,
                        graph_frame: str = "last"):
    """The reference's host loop: one step, then its prediction read back
    to the host, ``num_steps`` times. Returns (numpy (num_steps, R, 3),
    final window tensor). The test oracle for ``rollout_scan``; it waits
    on the device every step."""
    window, outs = window0, []
    for _ in range(num_steps):
        window, out, _ = _step(params, cfg, aa, window, threshold,
                               graph_frame)
        outs.append(out.cpu().numpy())
    return np.stack(outs), window
