"""The port's step bodies read nothing back from the device, so each can
be captured whole in a CUDA graph: the optimizer's update (every chain,
with a non-finite gradient too), the teacher-forced, K-step curriculum
and FNO train steps, the rollout step of the graphed configurations
(the dense graph's included) and a serving bundle's exported step.
They run here on CPU tensors with every Python-level way of reading a
tensor's value (``__bool__``, ``item``, ``tolist`` and their kin) made to
raise. The multi-rank steps' bodies are held the same way, with this
module's ``no_host_reads``, on the gloo ranks of
``tests/test_torch_port_parallel.py``."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    FNOConfig,
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models import fno, gkn
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.serving import export
from molecular_dynamics_neural_operator_tpu_torch.train import (
    create_train_state,
    make_curriculum_train_step,
    make_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    make_optimizer,
    tree_map,
)
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
)

READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__",
         "numpy")
CFG = dict(width=16, ker_width=64, depth=2, window_size=4, num_residues=12,
           max_edges=128, graph_mode="sparse", compute_dtype="float32",
           predict_delta=True)
TRAIN = dict(lr=1e-3, batch_size=4, grad_clip_norm=1.0,
             skip_nonfinite_updates=True)


@contextlib.contextmanager
def no_host_reads():
    """Every Python-level read of a tensor's value on this thread raises
    (another thread of the process, such as a data loader left by another
    test, reads as before)."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}
    owner = threading.get_ident()

    def refuse(name):
        def read(self, *args, **kwargs):
            if threading.get_ident() == owner:
                raise AssertionError(f"host read: Tensor.{name}")
            return saved[name](self, *args, **kwargs)
        return read

    try:
        for name in READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def test_the_guard_itself_refuses_a_read():
    with no_host_reads(), pytest.raises(AssertionError, match="__bool__"):
        bool(torch.ones(()))
    assert bool(torch.ones(()))


def _tree(rng):
    return {"a": {"w": torch.as_tensor(rng.normal(size=(6, 5)),
                                       dtype=torch.float32),
                  "b": torch.as_tensor(rng.normal(size=(5,)),
                                       dtype=torch.float32)},
            "c": torch.as_tensor(rng.normal(size=(3,)), dtype=torch.float32)}


@pytest.mark.parametrize("kw", [
    dict(),
    dict(grad_clip_norm=0.5, scheduler_step=1, steps_per_epoch=2),
    dict(skip_nonfinite_updates=True),
    dict(grad_accum=2),
    dict(grad_accum=3, skip_nonfinite_updates=True, grad_clip_norm=1.0),
], ids=["plain", "clip-schedule", "guard", "accum", "all-three"])
def test_optimizer_update_reads_nothing_back(kw):
    rng = np.random.default_rng(0)
    tx, _ = make_optimizer(**kw)
    params = _tree(rng)
    state = tx.init(params)
    grads = [_tree(rng) for _ in range(4)]
    grads[1]["c"][0] = float("nan")
    with no_host_reads():
        for g in grads:
            upd, state = tx.update(g, state, params)
            params = tree_map(lambda p, u: p + u, params, upd)


def _window_batch(cfg, b=4, k=0, layout="csr"):
    """A batch of ``b`` windows (with ``y_seq`` of K = ``k`` when k > 0);
    ``layout`` is the sparse edge layout, or "dense" for an adjacency."""
    dense = layout == "dense"
    ds = WindowDataset(synthetic_trajectory(num_frames=24, num_residues=12,
                                            seed=4),
                       window_size=cfg.window_size,
                       graph_mode="dense" if dense else "sparse",
                       max_edges=cfg.max_edges,
                       edge_layout="csr" if dense else layout)
    idx = np.arange(b)
    batch = ds.get_batch(idx) if k == 0 else ds.get_batch(
        idx, rollout_horizon=k)
    return to_device(batch, "cpu")


def _state(cfg, **train):
    state, tx, _ = create_train_state(0, cfg, TrainConfig(**{**TRAIN,
                                                              **train}),
                                      device="cpu")
    return state, tx


@pytest.mark.parametrize("impl,opts,layout", [
    ("pallas", {}, "csr"),
    ("xla", {}, "csr"),
    ("pallas", {"window_diff": True}, "csr"),
    ("pallas", {"scatter_mode": "blocked", "max_edges": 144}, "blocked"),
    ("xla", {"scatter_mode": "blocked", "max_edges": 144,
             "compute_dtype": "bfloat16"}, "blocked"),
    ("xla", {"graph_mode": "dense"}, "dense"),
    ("xla", {"graph_mode": "dense", "compute_dtype": "bfloat16"}, "dense"),
], ids=["pallas", "xla", "window-diff", "blocked", "blocked-bf16-xla",
        "dense", "dense-bf16"])
def test_teacher_step_reads_nothing_back(impl, opts, layout):
    cfg = ModelConfig(**{**CFG, **opts}, train_conv_impl=impl)
    state, tx = _state(cfg)
    step = make_train_step(cfg, tx, noise_std=0.1)
    batch = _window_batch(cfg, layout=layout)
    with no_host_reads():
        for _ in range(2):
            state, _ = step(state, batch)


@pytest.mark.parametrize("opts", [
    dict(graph_frame="rebuild", loss_space="delta", coord_clip=100.0),
    dict(graph_frame="first", grad_steps=1, noise_std=0.1),
    dict(graph_mode="dense", graph_frame="rebuild", loss_space="delta",
         coord_clip=100.0),
    dict(graph_mode="dense", compute_dtype="bfloat16", graph_frame="first",
         grad_steps=1, noise_std=0.1),
], ids=["rebuild-delta", "burn-in-noise", "dense-rebuild-delta",
        "dense-bf16-burn-in-noise"])
def test_curriculum_step_reads_nothing_back(opts):
    """The K free steps rebuild each graph on the device, the dense
    adjacency too."""
    opts = dict(opts)
    model = {k: opts.pop(k) for k in ("graph_mode", "compute_dtype")
             if k in opts}
    cfg = ModelConfig(**{**CFG, **model}, train_conv_impl="pallas")
    state, tx = _state(cfg, grad_accum=2)
    step = make_curriculum_train_step(cfg, tx, rollout_steps=3, **opts)
    batch = _window_batch(cfg, k=3, layout="dense"
                          if cfg.graph_mode == "dense" else "csr")
    with no_host_reads():
        for _ in range(2):
            state, _ = step(state, batch)


@pytest.mark.parametrize("which", ["window", "curriculum"])
def test_fno_step_reads_nothing_back(which):
    cfg = FNOConfig(num_residues=12, in_channels=4, width=8, modes1=4,
                    modes2=4, depth=2, predict_delta=True)
    params = fno.fno_init(cfg, seed=0, device="cpu")
    tx, _ = make_optimizer(skip_nonfinite_updates=True)
    state = TrainState(params, tx.init(params), 0, 0)
    if which == "window":
        step = fno.make_fno_window_train_step(cfg, tx)
        batch = _window_batch(ModelConfig(**CFG))
    else:
        step = fno.make_fno_curriculum_train_step(cfg, tx, 2)
        batch = _window_batch(ModelConfig(**CFG), k=2)
    with no_host_reads():
        for _ in range(2):
            state, _ = step(state, batch)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(conv_impl="pallas", electrostatics="dh"),
    dict(compute_dtype="bfloat16", scatter_mode="segment"),
    dict(kernel_quant="int8"),
    dict(graph_mode="dense"),
    dict(graph_mode="dense", compute_dtype="bfloat16"),
], ids=["sparse", "fused-dh", "bf16-segment", "int8", "dense", "dense-bf16"])
def test_rollout_step_reads_nothing_back(opts):
    """The configurations whose rollouts the card runs as CUDA graphs."""
    cfg = ModelConfig(**{**CFG, **opts})
    params = gkn.gkn_init(cfg, seed=0, device="cpu")
    traj = synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    window0 = torch.as_tensor(np.stack([traj.positions[:4],
                                        traj.positions[8:12]]))
    fn = make_rollout_fn(cfg, 3, batched=True, device="cpu")
    aa = torch.as_tensor(traj.aminoacids)
    with no_host_reads():
        fn(params, aa, window0)


def test_kernel_rollout_step_reads_nothing_back():
    cfg = ModelConfig(**{**CFG, "ker_width": 64, "width": 16})
    params = gkn.gkn_init(cfg, seed=0, device="cpu")
    traj = synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    prepared = pr.PreparedRollout(params, cfg, traj.aminoacids, clip=100.0,
                                  device="cpu")
    with no_host_reads():
        prepared(torch.as_tensor(traj.positions[:4]), 3)


# ops in an exported program that read a value back to the host
HOST_READ_OPS = ("_local_scalar_dense", "_assert_async", "_assert_scalar",
                 "nonzero", "item")


@pytest.mark.parametrize("operator", ["gkn", "gkn-dense", "fno"])
def test_bundle_step_reads_nothing_back(tmp_path, operator):
    """The serving bundle's exported step, which the card replays as CUDA
    graphs: no node of the program reads a value back, and a few calls
    of the loaded step read nothing back either."""
    traj = synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    if operator == "fno":
        cfg = FNOConfig(num_residues=12, in_channels=4, width=8, modes1=4,
                        modes2=4, depth=2, predict_delta=True)
        params = fno.fno_init(cfg, seed=0, device="cpu")
        inputs = (fno.distance_matrix_channels(
            torch.as_tensor(traj.positions[:4])),)
    else:
        mode = "dense" if operator == "gkn-dense" else "sparse"
        cfg = ModelConfig(**{**CFG, "graph_mode": mode})
        params = gkn.gkn_init(cfg, seed=0, device="cpu")
        inputs = (torch.as_tensor(traj.aminoacids, dtype=torch.int32),
                  torch.as_tensor(np.stack([traj.positions[:4],
                                            traj.positions[8:12]])))
    kw = {} if operator == "fno" else dict(streams=2, collect="both",
                                           clip=100.0)
    bundle = export.load_bundle(export.save_bundle(
        tmp_path / operator, params, cfg, 3, **kw), device="cpu")
    ops = [str(node.target) for node in bundle.program.graph.nodes
           if node.op == "call_function"]
    assert not [op for op in ops if any(f"aten.{r}." in op
                                        for r in HOST_READ_OPS)]
    with no_host_reads(), torch.no_grad():
        for _ in range(3):
            if operator == "fno":
                inputs = (bundle.step(bundle.params, *inputs),)
            else:
                window, _, _ = bundle.step(bundle.params, *inputs)
                inputs = (inputs[0], window)
