"""Rank workers of ``tests/test_torch_port_parallel.py``: the port's
parallel modules on gloo CPU ranks, started with ``spawn``.

A spawned rank imports this module to find its target, so it imports
only torch, numpy and the port, never JAX (``test_torch_port_isolation``
checks that). The parent writes each case's inputs under a work
directory; every rank joins the process group through a file there
(never a fixed port: several test workers run side by side), runs the
named cases in order and rank 0 writes each case's outputs as
``<case>.out.npz``. A rank that fails writes ``<case>.err`` and exits,
and ``run_ranks`` ends every rank past its deadline, so a hung
collective fails its tests and never the run.

This module holds no test of its own.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel import (
    gather_streams,
    make_edge_sharded_forward,
    make_edge_sharded_rollout_fn,
    make_edge_sharded_train_step,
    make_mesh,
    make_sharded_curriculum_train_step,
    make_sharded_rollout_fn,
    make_sharded_train_step,
    replicas_equal,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    _flatten,
    load_params_npz,
)

WORLD = 4
SPARSE = dict(width=16, ker_width=32, depth=2, window_size=4,
              num_residues=12, max_edges=128, graph_mode="sparse",
              compute_dtype="float32")
CELLS = dict(width=8, ker_width=16, depth=1, window_size=3,
             num_residues=16, graph_mode="sparse", compute_dtype="float32",
             predict_delta=True, neighbor_impl="cell_list", max_degree=16,
             max_edges=16 * 16, cell_capacity=16)
SERVE = dict(width=8, ker_width=16, depth=1, window_size=4,
             num_residues=10, max_edges=128, graph_mode="sparse",
             compute_dtype="float32", predict_delta=True)
TRAIN = dict(lr=1e-3, batch_size=8)
NOISE = 0.05
# (name, model options over SPARSE, train options over TRAIN, noise)
TEACHER_CASES = [
    ("xla", {}, {}, 0.0),
    ("pallas", dict(train_conv_impl="pallas"), {}, 0.0),
    ("xla_noise", {}, {}, NOISE),
    ("pallas_noise", dict(train_conv_impl="pallas"), {}, NOISE),
]
# (name, model options, train options, step options, K, noise)
CURRICULUM_CASES = [
    ("dense", dict(graph_mode="dense", predict_delta=True),
     dict(grad_clip_norm=1.0, skip_nonfinite_updates=True), {}, 3, 0.0),
    ("pallas", dict(predict_delta=True, train_conv_impl="pallas"), {},
     dict(coord_clip=100.0), 2, 0.0),
    ("pallas_grad_steps", dict(predict_delta=True, train_conv_impl="pallas"),
     {}, dict(coord_clip=100.0, grad_steps=1), 3, 0.0),
    ("xla_grad_steps", dict(predict_delta=True), {},
     dict(coord_clip=100.0, grad_steps=1), 3, 0.0),
    ("pallas_delta", dict(predict_delta=True, train_conv_impl="pallas"), {},
     dict(coord_clip=100.0, loss_space="delta"), 2, 0.0),
    ("delta_noise", dict(predict_delta=True, train_conv_impl="pallas"), {},
     dict(coord_clip=100.0, loss_space="delta"), 2, NOISE),
    # rank 0's rows barely move, so the floor binds there, at the GLOBAL
    # batch's mean displacement (a per-rank mean would floor them lower)
    ("delta_floor", dict(predict_delta=True), {},
     dict(coord_clip=100.0, loss_space="delta"), 2, 0.0),
]
EDGE_FORWARD_CASES = {"predict_delta": dict(predict_delta=True),
                      "dh": dict(electrostatics="dh"),
                      "head_scale": dict(predict_delta=True, head_scale=0.5)}
FNO = dict(num_residues=12, in_channels=4, width=8, modes1=4, modes2=4,
           depth=2, predict_delta=True)
# the multi-rank steps whose bodies must read nothing back (a capture on
# the card refuses a host read): name -> (step kind, model options)
BODY_CASES = {
    "teacher_pallas_noise": ("teacher", dict(train_conv_impl="pallas")),
    "teacher_xla": ("teacher", {}),
    "curriculum_rebuild_delta": ("curriculum", dict(
        predict_delta=True, train_conv_impl="pallas")),
    "curriculum_dense": ("curriculum", dict(graph_mode="dense",
                                            predict_delta=True)),
    "fno": ("fno", {}),
    "edge_sharded": ("edge", dict(predict_delta=True)),
}
# the steps the eager-or-graphed rule decides: name -> (kind, options)
RULE_CASES = {
    "teacher": ("teacher", {}),
    "teacher_cell_list": ("teacher", CELLS),
    "curriculum": ("curriculum", dict(predict_delta=True)),
    "curriculum_cell_list": ("curriculum", CELLS),
    "fno": ("fno", {}),
    "edge_sharded": ("edge", {}),
    "edge_sharded_cell_list": ("edge", CELLS),
}


class Recorder:
    """An optimizer whose update is zero and whose state becomes the
    gradients it was given: after one step ``state.opt_state`` holds the
    step's reduced gradients exactly."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return _zeros(params), grads


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


@contextlib.contextmanager
def backend_named(name: str):
    """Within the block every process group reads as ``name`` to
    ``torch.distributed.get_backend``: the CPU has no NCCL, and the rule
    that picks eager or graphed steps reads the backend."""
    saved = dist.get_backend
    dist.get_backend = lambda group=None: name
    try:
        yield
    finally:
        dist.get_backend = saved


class _Replayer:
    """A captured graph's stand-in on the CPU: a replay runs the body."""

    def __init__(self, body):
        self.replay = body


@contextlib.contextmanager
def cpu_graphs():
    """Within the block ``train/graphed.py``'s ``GraphedStep`` runs on
    the CPU: its capture runs the warm-up and keeps the body, and each
    replay runs the body again, eagerly. Its input buffers, static state
    and noise drawn outside the body are the card's."""
    from molecular_dynamics_neural_operator_tpu_torch.train import graphed

    saved = graphed.capture, torch.cuda.graph_pool_handle

    def capture(body, name, warmup=None, pool=None):
        if warmup is not None:
            warmup()
        return _Replayer(body), None

    graphed.capture, torch.cuda.graph_pool_handle = capture, lambda: None
    try:
        yield
    finally:
        graphed.capture, torch.cuda.graph_pool_handle = saved


# ---- the harness ------------------------------------------------------------

def run_ranks(workdir, cases, world: int = WORLD, timeout: float = 120.0):
    """Run ``cases`` (names of ``CASES``) in order on ``world`` gloo CPU
    ranks; returns once every rank has exited, or ends them all at the
    deadline and raises ``TimeoutError``. A case's outcome is in its
    files (``outputs``)."""
    # a rendezvous file of its own: a FileStore does not start over in a
    # file an earlier group used
    rdzv = Path(workdir) / f"rdzv.{os.getpid()}.{time.monotonic_ns()}"
    ctx = mp.start_processes(_worker,
                             args=(world, str(workdir), str(rdzv),
                                   list(cases)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks still running after {timeout} s "
                                   f"(cases {cases})")
            try:
                if ctx.join(timeout=min(left, 1.0)):
                    return
            except mp.ProcessExitedException:
                return  # the failing case wrote its .err
            except mp.ProcessRaisedException:
                return
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)


def outputs(workdir, case) -> dict:
    """Rank 0's outputs of ``case``; raises with the failing rank's
    traceback, or if the case never finished."""
    workdir = Path(workdir)
    for err in sorted(workdir.glob(f"{case}.err.*")):
        raise AssertionError(f"case {case} failed on {err.name}:\n"
                             + err.read_text())
    out = workdir / f"{case}.out.npz"
    if not out.exists():
        raise AssertionError(f"case {case} did not finish")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def _worker(rank, world, workdir, rdzv, cases):
    torch.set_num_threads(1)
    workdir = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world)
    try:
        for case in cases:
            try:
                out = CASES[case](rank, workdir)
            except BaseException:  # noqa: BLE001: reported to the parent
                (workdir / f"{case}.err.{rank}").write_text(
                    traceback.format_exc())
                os._exit(1)  # the other ranks may wait on this one
            if rank == 0:
                np.savez(workdir / f"{case}.out.npz", **out)
    finally:
        dist.destroy_process_group()


# ---- helpers ----------------------------------------------------------------

def _inputs(workdir, name) -> dict:
    with np.load(Path(workdir) / f"{name}.in.npz") as f:
        return {k: f[k] for k in f.files}


def _params(workdir, name):
    return load_params_npz(Path(workdir) / f"{name}.params.npz", "cpu")


def _tensors(batch: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flat(prefix, tree) -> dict:
    return {f"{prefix}{k}": v for k, v in _flatten(tree).items()}


def _state(cfg, tcfg, params, tx=None):
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    state, adam, _ = create_train_state(0, cfg, tcfg, device="cpu",
                                        params=params)
    if tx is None:
        return state, adam
    return TrainState(state.params, tx.init(state.params), 0, 0), tx


def _one_step(make_step, cfg, tcfg, params, global_batch, mesh, group,
              sharded: bool):
    """Gradients, metrics and the parameters after one Adam step, of the
    sharded step (each rank its rows) or the single-process step on the
    whole batch."""
    out = {}
    for kind in ("grads", "adam"):
        state, tx = _state(cfg, tcfg, params,
                           Recorder() if kind == "grads" else None)
        step, put = make_step(tx)
        batch = put(global_batch) if sharded else _tensors(global_batch)
        new, metrics = step(state, batch)
        if kind == "grads":
            out.update(_flat("grad/", new.opt_state))
            out.update({f"metric/{k}": v.detach().numpy()
                        for k, v in metrics.items()})
        else:
            out.update(_flat("params/", new.params))
            if sharded and not replicas_equal(new.params, group):
                raise AssertionError("ranks hold different parameters "
                                     "after the step")
    return out


# ---- cases ------------------------------------------------------------------

def case_mesh(rank, workdir):
    out = {}
    for name, mcfg in (("default", MeshConfig()),
                       ("model2", MeshConfig(data=2, model=2)),
                       ("model2_autofill", MeshConfig(data=1, model=2)),
                       ("model4", MeshConfig(data=1, model=4))):
        mesh = make_mesh(mcfg)
        out[name] = np.asarray(mesh.mesh.shape)
        out[f"{name}_coord"] = np.asarray(mesh.get_coordinate())
    try:
        make_mesh(MeshConfig(data=2, model=3))
    except ValueError as e:
        out["error"] = np.asarray(str(e))
    return out


def case_teacher(rank, workdir):
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        make_train_step,
    )

    batch = _inputs(workdir, "teacher")
    params = _params(workdir, "sparse")
    mesh = make_mesh(MeshConfig(data=WORLD, model=1))
    group = mesh.get_group("data")
    out = {}
    for name, mopts, topts, noise in TEACHER_CASES:
        cfg = ModelConfig(**{**SPARSE, **mopts})
        tcfg = TrainConfig(**{**TRAIN, **topts})
        for sharded in (True, False):
            if sharded:
                def make(tx):
                    return make_sharded_train_step(cfg, tx, mesh,
                                                   noise_std=noise)
            else:
                def make(tx):
                    return make_train_step(cfg, tx, noise_std=noise), None
            res = _one_step(make, cfg, tcfg, params, batch, mesh, group,
                            sharded)
            tag = "sharded" if sharded else "single"
            out.update({f"{name}/{tag}/{k}": v for k, v in res.items()})
    return out


def case_curriculum(rank, workdir):
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        make_curriculum_train_step,
    )

    mesh = make_mesh(MeshConfig(data=WORLD, model=1))
    group = mesh.get_group("data")
    out = {}
    for name, mopts, topts, sopts, k, noise in CURRICULUM_CASES:
        cfg = ModelConfig(**{**SPARSE, **mopts})
        tcfg = TrainConfig(**{**TRAIN, **topts, "rollout_steps": k})
        batch = _inputs(workdir, f"curriculum_{name}")
        params = _params(workdir, "sparse")
        for sharded in (True, False):
            if sharded:
                def make(tx):
                    return make_sharded_curriculum_train_step(
                        cfg, tx, mesh, rollout_steps=k, noise_std=noise,
                        **sopts)
            else:
                def make(tx):
                    return make_curriculum_train_step(
                        cfg, tx, rollout_steps=k, noise_std=noise,
                        **sopts), None
            res = _one_step(make, cfg, tcfg, params, batch, mesh, group,
                            sharded)
            tag = "sharded" if sharded else "single"
            out.update({f"{name}/{tag}/{k_}": v for k_, v in res.items()})
    return out


def case_edge_sharded(rank, workdir):
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        loss_and_grads,
    )

    inp = _inputs(workdir, "edge")
    t = _tensors(inp)
    mesh = make_mesh(MeshConfig(data=2, model=2))
    out = {}
    graph = gkn.SparseGraph(t["edges"], t["mask"], t["edge_feats"])
    for name, opts in EDGE_FORWARD_CASES.items():
        cfg = ModelConfig(**{**SPARSE, **opts})
        params = _params(workdir, f"edge_{name}")
        fwd = make_edge_sharded_forward(cfg, mesh)
        with torch.no_grad():
            out[f"forward/{name}"] = fwd(params, inp["aa"], inp["window"],
                                         inp["edges"], inp["mask"],
                                         inp["edge_feats"]).numpy()
            out[f"single/{name}"] = gkn.gkn_apply(
                params, cfg, gkn.GKNBatch(t["aa"], t["window"], graph,
                                          t["y"])).numpy()
    cfg = ModelConfig(**{**SPARSE, "predict_delta": True})
    params = _params(workdir, "edge_predict_delta")
    tcfg = TrainConfig(**TRAIN)
    group = mesh.get_group("data")
    args = (inp["aa"], inp["window"], inp["edges"], inp["mask"],
            inp["edge_feats"], inp["y"])
    for kind in ("grads", "adam"):
        state, tx = _state(cfg, tcfg, params,
                           Recorder() if kind == "grads" else None)
        new, metrics = make_edge_sharded_train_step(cfg, tx, mesh)(state,
                                                                   *args)
        if kind == "grads":
            out.update(_flat("train/grad/", new.opt_state))
            out.update({f"train/metric/{k}": v.numpy()
                        for k, v in metrics.items()})
        else:
            out.update(_flat("train/params/", new.params))
            if not replicas_equal(new.params, dist.group.WORLD):
                raise AssertionError("edge-sharded ranks diverged")

    # the single-process gradient of the same batch-sum loss
    _, grads = loss_and_grads(params, cfg, gkn.GKNBatch(
        t["aa"], t["window"], graph, t["y"]))
    out.update(_flat("single_grad/", grads))
    return out


def _edge_arrays(workdir) -> tuple:
    inp = _inputs(workdir, "edge")
    return (inp["aa"], inp["window"], inp["edges"], inp["mask"],
            inp["edge_feats"], inp["y"])


def _meshes() -> dict:
    """The data mesh of every rank and the 2 x 2 (data, model) mesh."""
    return {"data": make_mesh(MeshConfig(data=WORLD, model=1)),
            "edge": make_mesh(MeshConfig(data=2, model=2))}


def _multi_rank_step(kind, opts, workdir, meshes, noise=0.0):
    """(step, state, call) of a multi-rank step on the training ranks'
    inputs: ``call(run, state)`` takes one step of ``run`` (the step or
    one of its forms) from ``state``."""
    from molecular_dynamics_neural_operator_tpu_torch.models import fno
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        FNOConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_data_parallel_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    tcfg = TrainConfig(**TRAIN, grad_clip_norm=1.0,
                       skip_nonfinite_updates=True)
    cfg = ModelConfig(**{**SPARSE, **opts})
    if kind == "edge":
        state, tx = _state(cfg, tcfg, _params(workdir, "edge_predict_delta"))
        step = make_edge_sharded_train_step(cfg, tx, meshes["edge"])
        arrays = _edge_arrays(workdir)
        return step, state, lambda run, st: run(st, *arrays)
    mesh = meshes["data"]
    if kind == "fno":
        fcfg = FNOConfig(**FNO)
        params = fno.fno_init(fcfg, seed=0, device="cpu")
        tx, _ = make_optimizer(skip_nonfinite_updates=True)
        state = TrainState(params, tx.init(params), 0, 0)
        step, put = make_data_parallel_step(fno.fno_window_loss(fcfg), tx,
                                            mesh)
        host = _inputs(workdir, "teacher")
    else:
        state, tx = _state(cfg, tcfg, _params(workdir, "sparse"))
        if kind == "teacher":
            step, put = make_sharded_train_step(cfg, tx, mesh,
                                                noise_std=noise)
            host = _inputs(workdir, "teacher")
        else:
            dense = cfg.graph_mode == "dense"
            step, put = make_sharded_curriculum_train_step(
                cfg, tx, mesh, rollout_steps=3 if dense else 2,
                noise_std=noise, coord_clip=100.0,
                **({} if dense else dict(graph_frame="rebuild",
                                         loss_space="delta")))
            host = _inputs(workdir, "curriculum_dense" if dense
                           else "curriculum_delta_noise")
    batch = put(host)
    return step, state, lambda run, st: run(st, batch)


def case_no_host_read(rank, workdir):
    """Each multi-rank step's body, issued op by op on the gloo ranks,
    with every Python-level read of a tensor refused: "" when two steps
    read nothing back, else the refusal."""
    from test_torch_port_no_host_read import no_host_reads

    out, meshes = {}, _meshes()
    for name, (kind, opts) in BODY_CASES.items():
        step, state, call = _multi_rank_step(
            kind, opts, workdir, meshes,
            noise=NOISE if "noise" in name else 0.0)
        try:
            with no_host_reads():
                for _ in range(2):
                    state, _ = call(step.eager, state)
            out[name] = np.asarray("")
        except AssertionError as e:
            out[name] = np.asarray(str(e))
        dist.barrier()  # a refused read leaves a collective unmatched
    return out


def case_eager_rule(rank, workdir):
    """The eager-or-graphed rule (``ops/cuda/graphs.py::
    step_stays_eager``) as each multi-rank step applies it, with the
    groups read as gloo and as NCCL: ``<backend>/<case>`` is True where
    the step holds a ``GraphedStep``."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (  # noqa: E501
        step_stays_eager,
    )

    # the meshes' groups are made with the real backend, gloo
    out, meshes = {}, _meshes()
    group = meshes["data"].get_group("data")
    for backend in ("gloo", "nccl"):
        with backend_named(backend):
            for name, (kind, opts) in RULE_CASES.items():
                step, _, _ = _multi_rank_step(kind, opts, workdir, meshes)
                out[f"{backend}/{name}"] = np.asarray(
                    step.graphed is not None)
            out[f"{backend}/rule"] = np.asarray(
                step_stays_eager(ModelConfig(**SPARSE), (group,)))
    return out


def case_noise_outside(rank, workdir):
    """A data-parallel step with input noise through its ``GraphedStep``
    (the rule given NCCL groups, the capture stood in for on the CPU):
    the increments drawn outside the body into the graph's buffer of the
    GLOBAL batch's shape, then two steps; against the same two steps
    issued op by op (``step.eager``)."""
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        opt_state_leaves,
        tree_leaves,
    )

    out, meshes = {}, _meshes()
    for kind in ("teacher", "curriculum"):
        opts = BODY_CASES[f"{kind}_pallas_noise" if kind == "teacher"
                          else "curriculum_rebuild_delta"][1]
        with backend_named("nccl"):
            step, state0, call = _multi_rank_step(kind, opts, workdir,
                                                  meshes, noise=NOISE)
        runs = {}
        with cpu_graphs():
            for form, run in (("graphed", step.graphed),
                              ("eager", step.eager)):
                state, metrics = state0, []
                for _ in range(2):
                    state, m = call(run, state)
                    metrics.append(m)
                runs[form] = (state, metrics)
        (graph,) = step.graphed.graphs.values()
        out[f"{kind}/noise_rows"] = np.asarray(graph.batch["noise"].shape[0])
        (sg, mg), (se, me) = runs["graphed"], runs["eager"]
        leaves = [torch.equal(a, b) for a, b in zip(
            tree_leaves(sg.params) + opt_state_leaves(sg.opt_state),
            tree_leaves(se.params) + opt_state_leaves(se.opt_state))]
        leaves += [torch.equal(a[k], b[k]) for a, b in zip(mg, me)
                   for k in b]
        out[f"{kind}/bit_equal"] = np.asarray(all(leaves))
        out[f"{kind}/steps"] = np.asarray([sg.step, se.step])
        out[f"{kind}/replicas_equal"] = np.asarray(
            replicas_equal(sg.params, dist.group.WORLD))
    return out


def case_rollout_sharded(rank, workdir):
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    inp = _inputs(workdir, "rollout")
    params = _params(workdir, "rollout")
    cfg = ModelConfig(**{**SPARSE, "predict_delta": True})
    out = {}
    for name, mcfg, steps, chunk in (
            ("data4", MeshConfig(data=WORLD, model=1), 6, None),
            ("chunked", MeshConfig(data=2, model=2), 5, 1)):
        mesh = make_mesh(mcfg)
        roll = make_sharded_rollout_fn(cfg, mesh, num_steps=steps,
                                       stream_chunk=chunk)
        with torch.no_grad():
            coords, final_w, diags = roll(params, inp["aa"], inp["window0"])
            out[f"{name}/local_streams"] = np.asarray(coords.shape[0])
            out[f"{name}/coords"] = gather_streams(mesh, coords).numpy()
            out[f"{name}/final"] = gather_streams(mesh, final_w).numpy()
            out[f"{name}/overflow"] = diags["edge_overflow"].numpy()
            c1, f1, _ = make_rollout_fn(cfg, steps, batched=True,
                                        stream_chunk=chunk, device="cpu")(
                params, inp["aa"], inp["window0"])
        out[f"{name}/single_coords"] = c1.numpy()
        out[f"{name}/single_final"] = f1.numpy()
    mesh = make_mesh(MeshConfig(data=WORLD, model=1))
    for what, kw, window in (
            ("error_streams", {}, inp["window0"][:6]),
            ("error_chunk", dict(stream_chunk=3), inp["window0"])):
        try:
            make_sharded_rollout_fn(cfg, mesh, 2, **kw)(params, inp["aa"],
                                                        window)
        except ValueError as e:
            out[what] = np.asarray(str(e))
    return out


def case_rollout_edge_sharded(rank, workdir):
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    out = {}
    mesh = make_mesh(MeshConfig(data=1, model=WORLD))
    for name, opts, steps in (
            ("ranked", {**SPARSE, "predict_delta": True}, 5),
            ("cells", CELLS, 4),
            # 18 atoms do not divide over 4 ranks: the whole rebuild on
            # every rank, then each rank's slice of the block layout
            ("cells_replicated", {**CELLS, "num_residues": 18,
                                  "max_edges": 18 * 16}, 4)):
        cfg = ModelConfig(**opts)
        inp = _inputs(workdir, f"edge_roll_{name}")
        params = _params(workdir, f"edge_roll_{name}")
        roll = make_edge_sharded_rollout_fn(cfg, mesh, num_steps=steps)
        coords, final_w, diags = roll(params, inp["aa"], inp["window0"])
        out[f"{name}/coords"] = coords.numpy()
        out[f"{name}/final"] = final_w.numpy()
        out[f"{name}/overflow"] = diags["edge_overflow"].numpy()
        with torch.no_grad():
            c1, f1, _ = make_rollout_fn(cfg, steps, device="cpu")(
                params, inp["aa"], inp["window0"])
        out[f"{name}/single_coords"] = c1.numpy()
    params = _params(workdir, "edge_roll_ranked")
    for what, opts, window in (
            ("error_dense", {**SPARSE, "graph_mode": "dense"}, None),
            ("error_divide", {**SPARSE, "max_edges": 130}, None),
            ("error_cells", {**CELLS, "max_edges": 128},
             np.zeros((3, 16, 3), np.float32))):
        try:
            roll = make_edge_sharded_rollout_fn(ModelConfig(**opts), mesh, 2)
            roll(params, np.zeros(16, np.int32), window)
        except ValueError as e:
            out[what] = np.asarray(str(e))
    return out


def _requests(inp):
    return [(inp["aa"][i], inp["window"][i], int(inp["steps"][i]))
            for i in range(len(inp["steps"]))]


def case_server(rank, workdir):
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
        serve_follower,
    )

    cfg = ModelConfig(**SERVE)
    params = _params(workdir, "serve")
    inp = _inputs(workdir, "server")
    mesh = make_mesh(MeshConfig(data=WORLD, model=1))
    if rank > 0:
        serve_follower(params, cfg, mesh, segment_steps=4, device="cpu")
        return {}
    out = {}
    with RolloutServer(params, cfg, segment_steps=4, max_streams=8,
                       mesh=mesh, device="cpu") as srv:
        futs = [srv.submit(a, w, n) for a, w, n in _requests(inp)]
        for i, f in enumerate(futs):
            res = f.result(timeout=60)
            out[f"coords{i}"] = res.coords
            out[f"overflow{i}"] = np.asarray(res.edge_overflow)
        stats = srv.stats
    out.update({f"stats/{k}": np.asarray(v) for k, v in stats.items()})
    for what, kw in (("error_divisible", dict(max_streams=6)),
                     ("error_impl", dict(impl="persistent",
                                         aa=np.zeros(10, np.int32)))):
        try:
            RolloutServer(params, cfg, mesh=mesh, device="cpu", **kw)
        except ValueError as e:
            out[what] = np.asarray(str(e))
    return out


def case_serve_cli(rank, workdir):
    """``cli.serve`` with ``--data_mesh 2`` on every rank: rank 0 binds
    the socket, a client on rank 0 sends the requests over it, and the
    other ranks follow until rank 0's server stops."""
    from molecular_dynamics_neural_operator_tpu_torch.cli import serve

    args = serve.parse_args([
        "--checkpoint", str(Path(workdir) / "serve.params.npz"),
        "--device", "cpu", "--data_mesh", "2", "--segment_steps", "4",
        "--max_streams", "4", "--width", "8", "--kernel_width", "16",
        "--depth", "1", "--window_size", "4", "--num_residues", "10",
        "--max_edges", "128", "--compute_dtype", "float32",
        "--predict_delta"])
    params, cfg = serve._load(args)
    if rank > 0:
        if serve.serve(params, cfg, args) is not None:
            raise AssertionError("a follower returned a server")
        return {}
    ready = {"event": threading.Event()}
    thread = threading.Thread(target=serve.serve, args=(params, cfg, args),
                              kwargs={"ready": ready}, daemon=True)
    thread.start()
    if not ready["event"].wait(60):
        raise TimeoutError("the server did not bind")
    inp = _inputs(workdir, "server")
    out = {}
    try:
        with socket.create_connection(("127.0.0.1", ready["port"]),
                                      timeout=60) as sock:
            f = sock.makefile("rwb")
            for i, (a, w, n) in enumerate(_requests(inp)[:3]):
                f.write(json.dumps({"id": i, "aa": a.tolist(),
                                    "window": w.tolist(),
                                    "num_steps": n}).encode() + b"\n")
                f.flush()
                reply = json.loads(f.readline())
                if "error" in reply:
                    raise AssertionError(reply["error"])
                out[f"coords{i}"] = np.asarray(reply["coords"], np.float32)
            f.write(json.dumps({"op": "stats"}).encode() + b"\n")
            f.flush()
            stats = json.loads(f.readline())["stats"]
            out["segments_run"] = np.asarray(stats["segments_run"])
    finally:
        ready["tcp"].shutdown()
        thread.join(60)
    if thread.is_alive():
        raise TimeoutError("the server did not stop")
    return out


def case_train_cli(rank, workdir):
    """``cli.train --data_parallel`` on every rank: teacher, K = 2 and the
    FNO, each from its JAX init checkpoint; rank 0 alone writes."""
    from molecular_dynamics_neural_operator_tpu_torch.cli import train

    spec = json.loads((Path(workdir) / "train_cli.json").read_text())
    sys.modules["matplotlib"] = None  # both packages write .npz maps
    for argv in spec.values():
        train.main(argv + ["--data_parallel", "--device", "cpu"])
    return {"done": np.asarray(True)}


CASES = {name[5:]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}

