"""Process group, device mesh and the data-parallel train steps
(``molecular_dynamics_neural_operator_tpu/parallel/mesh.py``).

The JAX mesh is one process over many devices. Here it is one process
per device, PyTorch's own model: ranks are launched by ``torchrun`` (or
``torch.multiprocessing`` with ``spawn``), ``init_distributed`` joins the
process group, and ``make_mesh`` lays the ranks out on a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")``, one process group per axis.

Backend rule (``init_distributed``): NCCL when every rank has a card of
its own; gloo on the CPU, and gloo when ranks share a card (NCCL refuses
two ranks on one GPU). A backend that fails to initialize raises.

Data parallelism: every rank holds the same parameters and optimizer
state and runs the existing loss on its rows of the global batch
(``shard_batch``). The loss is a sum over the batch, so the gradient of
the global loss is the SUM of the ranks' gradients: the step all-reduces
the gradients and ``rel_l2`` by sum and ``mse`` by mean over the "data"
group, in one collective, and then applies the same update on every rank,
which keeps the replicas bit-equal (``replicas_equal`` checks it).
DistributedDataParallel's default would average the gradients, a factor
of the world size too small, and is not used. With
``train_conv_impl="pallas"`` each rank runs the training kernels on its
own rows, as the JAX package's explicit ``shard_map`` step does.

Input noise is drawn for the GLOBAL batch from ``train/noise.py``'s
generator of (seed, step) and each rank adds its rows of it, so the
noised window is the single-process step's, bit for bit.

One program per step: on ranks with a card each (NCCL) every
data-parallel step replays a CUDA graph that holds its forward, backward,
the all-reduce and the update (``train/graphed.py``), the counterpart of
the JAX package's ``jax.jit`` around its ``shard_map`` step. Every rank
captures the same graphs in the same order (a graph per batch shape, at
the first step of that shape, after one eager step that also creates the
NCCL communicator) and replays them in lockstep. Steps over gloo groups
and cell-list configurations run eagerly
(``ops/cuda/graphs.py::step_stays_eager``). ``step.eager`` is the step
issued op by op, the oracle.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    MeshConfig,
    ModelConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    step_stays_eager,
)
from molecular_dynamics_neural_operator_tpu_torch.parallel import comm
from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
    graphed_step,
    with_noise,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    _loss_fn,
    featurize_batch,
    value_and_grad,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    tree_leaves,
    tree_unflatten,
)
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
    apply_update,
)


def launched_world_size() -> int:
    """The world size of an initialized process group, else the one
    ``torchrun`` gives in ``WORLD_SIZE`` (1 when it is not set)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device=None, init_method: str = "env://",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``device`` is ``"cuda"`` (the default) or ``"cpu"``. Rank and world
    size come from ``torchrun``'s environment unless given. On the card,
    local rank i takes card i when every local rank has one, with NCCL;
    when ranks outnumber the cards they share them round robin, with
    gloo. The CPU takes gloo. A group initialized already is kept (its
    backend must follow the same rule)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the host")
        local_rank = int(os.environ.get("LOCAL_RANK", rank or 0)) \
            if dev.index is None else dev.index
        local_world = int(os.environ.get(
            "LOCAL_WORLD_SIZE", world_size or launched_world_size()))
        own_card = local_world <= torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl" if own_card else "gloo"
    else:
        backend = "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()!r}, but ranks "
                f"on {dev} need {backend!r}")
        return dev
    kw = {} if rank is None else {"rank": rank, "world_size": world_size}
    # Captured NCCL collectives need no environment setting here: NCCL
    # work issued during a capture never enters the process group's
    # watchdog, and ``ops/cuda/graphs.py::capture``'s thread-local mode
    # leaves the watchdog thread's event queries free (torch 2.11, NCCL
    # 2.28 on four H100s, ``chip_smoke.py`` phase 20g).
    dist.init_process_group(backend, init_method=init_method, **kw)
    return dev


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type=None):
    """The (data, model) ``DeviceMesh`` of every rank of the process
    group. With the defaults (1, 1) every rank goes on "data"; an
    explicit model axis takes what it asks for and "data" the rest, and a
    model axis that does not divide the world raises ``ValueError`` (the
    JAX package's auto-fill). ``device_type`` is the device the ranks
    compute on (``mesh_device`` returns it): ``cuda`` where there is a
    card unless given, so a CPU run on a machine with a card passes
    ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    data, model = cfg.data, cfg.model
    if data * model != n:
        if model > 1 and n % model == 0:
            data = n // model
        elif model > 1:
            raise ValueError(
                f"model axis {model} does not divide the {n} available "
                f"devices (data={cfg.data}, model={model})")
        else:
            data, model = n, 1
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=tuple(cfg.axis_names))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def batch_sharding(mesh):
    """The ``DTensor`` placements of a batch-major array: the batch axis
    over "data", replicated over "model" (the JAX package's
    ``NamedSharding(mesh, P("data"))``)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == "data" else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated_sharding(mesh):
    """The placements of an array held whole by every rank."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _rows(mesh, b: int, axis: str = "data") -> slice:
    n = axis_size(mesh, axis)
    if b % n:
        raise ValueError(f"batch of {b} rows does not divide over the "
                         f"'{axis}' axis size {n}")
    local = b // n
    i = axis_index(mesh, axis)
    return slice(i * local, (i + 1) * local)


def shard_batch(mesh, batch: dict) -> dict:
    """This rank's rows of a GLOBAL host batch: every batch-major array
    sliced along its first axis by the rank's "data" coordinate, the
    shared amino-acid labels ``aa`` whole. Arrays stay where they are
    (``data_parallel_put`` sends them to the card)."""
    rows = None
    out = {}
    for k, v in batch.items():
        if k == "aa":
            out[k] = v
            continue
        if rows is None:
            rows = _rows(mesh, v.shape[0])
        out[k] = v[rows]
    return out


def data_parallel_put(batch_size: int, device_type=None):
    """The default data mesh over every rank and the placement of a host
    batch, with the divisibility guard: ONE definition for every
    data-parallel entry point. Returns (mesh, put)."""
    n = dist.get_world_size()
    if batch_size % n:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the device "
            f"count {n} for data parallelism")
    mesh = make_mesh(device_type=device_type)
    dev = mesh_device(mesh)
    return mesh, lambda b: to_device(shard_batch(mesh, b), dev)


def sum_over_data(grads, l2, m, overflow, group, n: int):
    """The data-axis reduction of a step, in one collective: gradients and
    ``l2`` summed, ``m`` averaged (the shards are equal), ``overflow``
    (a bool tensor or None) OR-ed. Returns them in that order."""
    leaves = tree_leaves(grads)
    extra = [l2.float(), m.float()]
    if overflow is not None:
        extra.append(overflow.float())
    flat = torch.cat([g.reshape(-1) for g in leaves]
                     + [e.reshape(1) for e in extra])
    flat = comm.all_reduce(flat, group)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    l2, m = flat[at], flat[at + 1] / n
    if overflow is not None:
        overflow = flat[at + 2] > 0
    return tree_unflatten(grads, out), l2, m, overflow


def make_data_parallel_step(loss_fn: Callable, tx, mesh,
                            noise_std: float = 0.0,
                            data_axis: str = "data", cfg=None,
                            name: str = "data-parallel train step"):
    """A data-parallel train step around ``loss_fn(params, batch) ->
    (batch-sum loss, aux)``, aux the batch-mean MSE or (mse, overflow).
    Returns (step, put): ``put(global host batch)`` gives this rank's
    rows on its device, ``step(state, local batch) -> (state, metrics)``
    with ``rel_l2`` and ``mse`` (and ``edge_overflow``) of the global
    batch, the same on every rank. On NCCL ranks with a card each the
    step replays CUDA graphs unless ``cfg`` (the model's configuration,
    None for the FNO) stays eager; ``step.eager`` is the body issued op by
    op."""
    group = mesh.get_group(data_axis)
    n = axis_size(mesh, data_axis)
    index = axis_index(mesh, data_axis)
    dev = mesh_device(mesh)

    def body(state: TrainState, batch: dict):
        # the increments of the GLOBAL batch, drawn outside the body
        batch = with_noise(batch, noise_std, part=index)
        (l2, aux), grads = value_and_grad(loss_fn, state.params, batch)
        m, overflow = aux if isinstance(aux, tuple) else (aux, None)
        grads, l2, m, overflow = sum_over_data(grads, l2, m, overflow, group,
                                               n)
        metrics = {"rel_l2": l2, "mse": m}
        if overflow is not None:
            metrics["edge_overflow"] = overflow
        return apply_update(state, grads, tx), metrics

    def put(host_batch: dict) -> dict:
        return to_device(shard_batch(mesh, host_batch), dev)

    step = graphed_step(body, noise_std,
                        eager_only=step_stays_eager(cfg, (group,)),
                        name=name, noise_rows=n)
    return step, put


def make_sharded_train_step(cfg: ModelConfig, tx, mesh,
                            graph_frame: str = "first",
                            noise_std: float = 0.0):
    """Data-parallel teacher-forced step: params and optimizer state
    replicated, the batch sharded over "data". Returns (step, put): call
    ``put(host_batch)`` then ``step(state, device_batch)``."""

    def loss(params, batch):
        l2, (m, _) = _loss_fn(params, cfg, featurize_batch(cfg, batch,
                                                            graph_frame))
        return l2, m

    return make_data_parallel_step(
        loss, tx, mesh, noise_std, cfg=cfg,
        name="data-parallel teacher-forced train step")


def make_sharded_curriculum_train_step(
    cfg: ModelConfig,
    tx,
    mesh,
    rollout_steps: int,
    threshold: float = 8.0,
    step_weights=None,
    graph_frame: str = "first",
    coord_clip=None,
    loss_space: str = "absolute",
    grad_steps=None,
    noise_std: float = 0.0,
    burnin_dtype=None,
    unroll_scans: bool = False,
):
    """Data-parallel K-step curriculum step: each rank unrolls the K
    steps (forward and graph rebuild from its own predictions) for its
    rows alone, with no traffic until the gradient reduction; the delta
    loss's displacement floor pools over the GLOBAL batch (the
    curriculum's ``axis_name``). Host batches carry ``y_seq`` (B, K, R, 3)
    with B divisible by the "data" axis size. Returns (step, put)."""
    from molecular_dynamics_neural_operator_tpu_torch.train.curriculum import (  # noqa: E501
        make_curriculum_loss,
    )

    loss = make_curriculum_loss(
        cfg, rollout_steps, threshold=threshold, step_weights=step_weights,
        graph_frame=graph_frame, coord_clip=coord_clip,
        loss_space=loss_space, grad_steps=grad_steps,
        burnin_dtype=burnin_dtype, unroll_scans=unroll_scans,
        axis_name=mesh.get_group("data"))
    return make_data_parallel_step(
        loss, tx, mesh, noise_std, cfg=cfg,
        name=f"data-parallel K={rollout_steps} curriculum train step")


def replicas_equal(tree, group) -> bool:
    """True when every rank of ``group`` holds ``tree`` bit for bit: the
    leaves' bit patterns reduced by MAX and by MIN must agree."""
    if comm.size(group) == 1:
        return True
    flat = torch.cat([t.detach().reshape(-1).float().view(torch.int32)
                      for t in tree_leaves(tree)])
    hi = comm.all_reduce(flat, group, dist.ReduceOp.MAX)
    lo = comm.all_reduce(flat, group, dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))
