"""The port's K-step curriculum loss (``train/curriculum.py``) against
``jax.value_and_grad`` of the JAX package's on the CPU: loss, MSE, edge
overflow and every parameter's gradient, at K = 1, 2 and 4, in both loss
spaces, with ``grad_steps`` None, 1 and K - 1, on the kernel path
(``train_conv_impl="pallas"``: the kernel's plain version here, the JAX
package's Pallas kernel as its own tests run it on the CPU) and the
per-layer path, on the breathing-mode and the Langevin trajectories.

Before any value is compared, the graphs that both packages rebuilt from
their own predictions must be the same edge lists at every step: a pair
that lies within rounding of the 8 A threshold would fail as itself, not
as a tolerance miss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
    langevin_trajectory as jax_langevin_trajectory,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.rollout import scan as jscan
from molecular_dynamics_neural_operator_tpu.train import (
    curriculum as jcurriculum,
)
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    train_conv as tc,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    curriculum,
    loop,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

BASE = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
            max_edges=128, graph_mode="sparse", compute_dtype="float32",
            predict_delta=True)
# f32, the one-step training tests' bound (test_torch_port_train_model.py):
# sums over 32 hidden units, <= 16 products per message, a node's edges and
# 4 layers, taken in another order by torch than by XLA; here K of them
# chained through the rebuilt windows. ATOL is absolute for a gradient leaf
# whose largest element is at most 1 and scales with that element above:
# under the delta loss on the Langevin data a leaf reaches 2e3, where one
# f32 unit in the last place is 1.2e-4, and an element that is a sum of
# such terms cancelling to 0.17 carries rounding of that size in either
# package.
RTOL, ATOL = 2e-4, 1e-5
BATCH = 5


def _trajectory(kind: str):
    if kind == "langevin":
        return jax_langevin_trajectory(num_frames=24, num_residues=12,
                                       seed=13)
    return jax_synthetic_trajectory(num_frames=24, num_residues=12, seed=4)


def _setup(impl: str, k: int, kind: str = "synthetic", **kw):
    opts = {**BASE, "train_conv_impl": impl, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    ds = JaxWindowDataset(_trajectory(kind), window_size=4,
                          graph_mode="sparse", max_edges=128,
                          use_native=False)
    batch = ds.get_batch(np.arange(BATCH), rollout_horizon=k)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, batch, jparams


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def record_graphs(monkeypatch):
    """Every graph either package rebuilds inside its curriculum, as numpy
    (edges (B, 2, E), mask (B, E)) in the order built: (port, jax)."""
    port, jax_rec = [], []
    port_build, jax_build = curriculum._build_graph, jscan._build_graph

    def port_wrapped(cfg, frame, threshold):
        graph, ov = port_build(cfg, frame, threshold)
        port.append((graph.edges.numpy().copy(), graph.mask.numpy().copy()))
        return graph, ov

    def jax_wrapped(cfg, frame, threshold):
        # called under vmap: one callback per example, in batch order
        graph, ov = jax_build(cfg, frame, threshold)
        jax.debug.callback(
            lambda e, m: jax_rec.append((np.asarray(e), np.asarray(m))),
            graph.edges, graph.mask, ordered=True)
        return graph, ov

    monkeypatch.setattr(curriculum, "_build_graph", port_wrapped)
    monkeypatch.setattr(jscan, "_build_graph", jax_wrapped)
    return port, jax_rec


def assert_same_graphs(port, jax_rec, batch: int, builds: int):
    """The same rebuilt edge lists and masks at every step."""
    assert len(port) == builds and len(jax_rec) == builds * batch
    for step, (edges, mask) in enumerate(port):
        for i in range(batch):
            je, jm = jax_rec[step * batch + i]
            np.testing.assert_array_equal(
                edges[i], je, err_msg=f"edges of example {i}, rebuild {step}")
            np.testing.assert_array_equal(
                mask[i], jm, err_msg=f"mask of example {i}, rebuild {step}")


def assert_grads_close(grads, jgrads, rtol=RTOL, atol=ATOL):
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert set(got) == set(want) and len(got) == 21
    for name, g in got.items():
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(g.numpy(), want[name], rtol, atol * scale,
                                   err_msg=name)


def run_both(jcfg, cfg, batch, jparams, opts):
    """((loss, (mse, overflow)), grads) of both packages'
    ``curriculum_loss_batched`` on one batch, stored graph from the first
    frame: (port, jax)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jloop.featurize_batch(jcfg, jb, "first")
    want = jax.jit(jax.value_and_grad(
        lambda p: jcurriculum.curriculum_loss_batched(
            p, jcfg, jg, jb["y_seq"], return_overflow=True, **opts),
        has_aux=True))(jparams)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = loop.value_and_grad(
        lambda p: curriculum.curriculum_loss_batched(
            p, cfg, loop.featurize_batch(cfg, tb, "first"), tb["y_seq"],
            return_overflow=True, **opts),
        params_from_jax(jparams, "cpu"))
    return got, want


def assert_matches(got, want):
    (loss, (m, ov)), grads = got
    (jl, (jm, jov)), jgrads = want
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(m), float(jm), rtol=RTOL)
    assert ov.shape == () and ov.dtype == torch.bool
    assert bool(ov) == bool(jov)
    assert_grads_close(grads, jgrads)


# (K, options): both loss spaces, grad_steps None, 1 and K - 1, the clip
# inside the unroll (tight enough to bind at 5 A) and step weights
CASES = [
    (1, dict(loss_space="absolute")),
    (1, dict(loss_space="delta")),
    (2, dict(loss_space="absolute", coord_clip=1000.0)),
    (2, dict(loss_space="delta")),
    (2, dict(loss_space="absolute", grad_steps=1)),
    (2, dict(loss_space="delta", grad_steps=1, coord_clip=1000.0)),
    (4, dict(loss_space="absolute", coord_clip=1000.0)),
    (4, dict(loss_space="delta", coord_clip=1000.0)),
    (4, dict(loss_space="absolute", grad_steps=1)),
    (4, dict(loss_space="delta", grad_steps=1, coord_clip=1000.0)),
    (4, dict(loss_space="absolute", grad_steps=3, coord_clip=1000.0)),
    (4, dict(loss_space="delta", grad_steps=3)),
    (4, dict(loss_space="absolute", coord_clip=5.0)),
    (4, dict(loss_space="delta", step_weights=[1.0, 2.0, 3.0, 4.0])),
    (4, dict(loss_space="delta", grad_steps=2, step_weights=[1.0, 3.0])),
]
CASE_IDS = ["-".join([f"K{k}"] + [f"{n}={v}" for n, v in o.items()])
            for k, o in CASES]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("k,opts", CASES, ids=CASE_IDS)
def test_curriculum_loss_matches_jax_on_the_breathing_trajectory(
        k, opts, impl, monkeypatch):
    jcfg, cfg, batch, jparams = _setup(impl, k)
    port, jax_rec = record_graphs(monkeypatch)
    got, want = run_both(jcfg, cfg, batch, jparams, opts)
    assert_same_graphs(port, jax_rec, BATCH, k - 1)
    assert_matches(got, want)


LANGEVIN = [
    ("pallas", 4, dict(loss_space="absolute", coord_clip=1000.0)),
    ("pallas", 4, dict(loss_space="delta", grad_steps=1, coord_clip=1000.0)),
    ("pallas", 4, dict(loss_space="delta", grad_steps=3)),
    ("pallas", 2, dict(loss_space="delta")),
    ("xla", 4, dict(loss_space="delta", coord_clip=1000.0)),
    ("xla", 1, dict(loss_space="delta")),
]


@pytest.mark.parametrize(
    "impl,k,opts", LANGEVIN,
    ids=["-".join([impl, f"K{k}"] + [f"{n}={v}" for n, v in o.items()])
         for impl, k, o in LANGEVIN])
def test_curriculum_loss_matches_jax_on_the_langevin_trajectory(
        impl, k, opts, monkeypatch):
    """Real per-frame motion: the delta loss's denominators differ from
    example to example and the rebuilt graphs from the stored ones."""
    jcfg, cfg, batch, jparams = _setup(impl, k, "langevin")
    port, jax_rec = record_graphs(monkeypatch)
    got, want = run_both(jcfg, cfg, batch, jparams, opts)
    assert_same_graphs(port, jax_rec, BATCH, k - 1)
    assert_matches(got, want)


def test_the_kernel_wrapper_runs_once_per_step_and_launches_nothing_here(
        monkeypatch):
    """On the kernel path every one of the K steps goes through
    ``train_conv``, burn-in included; on CPU tensors it is the plain
    version, so no kernel launches."""
    _, cfg, batch, jparams = _setup("pallas", 4)
    called, orig = [], gkn.train_conv
    monkeypatch.setattr(
        gkn, "train_conv", lambda *a, **k: called.append(1) or orig(*a, **k))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    tc.reset_launch_counts()
    for grad_steps in (None, 1):
        called.clear()
        loop.value_and_grad(
            lambda p: curriculum.curriculum_loss_batched(
                p, cfg, loop.featurize_batch(cfg, tb), tb["y_seq"],
                grad_steps=grad_steps),
            params_from_jax(jparams, "cpu"))
        assert len(called) == 4
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}


def test_grad_steps_k_equals_full_backprop_and_burn_in_gets_no_gradient():
    """grad_steps=K is the default to the bit; under grad_steps=1 the loss
    is the last step's alone, the MSE still averages all K steps, and a
    weight of 0 on the other steps with full backpropagation gives the
    same loss but other gradients (the burn-in's are cut)."""
    _, cfg, batch, jparams = _setup("pallas", 3)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gb = loop.featurize_batch(cfg, tb)
    params = params_from_jax(jparams, "cpu")

    def run(**kw):
        return loop.value_and_grad(
            lambda p: curriculum.curriculum_loss_batched(
                p, cfg, gb, tb["y_seq"], **kw), params)

    (l_full, m_full), g_full = run()
    (l_k, m_k), g_k = run(grad_steps=3)
    assert torch.equal(l_full, l_k) and torch.equal(m_full, m_k)
    for (_, a), (_, b) in zip(_flat(g_full), _flat(g_k)):
        assert torch.equal(a, b)
    (l_1, m_1), g_1 = run(grad_steps=1)
    (l_w, _), g_w = run(step_weights=[0.0, 0.0, 1.0])
    torch.testing.assert_close(l_1, l_w, rtol=1e-6, atol=0)
    torch.testing.assert_close(m_1, m_full, rtol=1e-6, atol=0)
    assert max((a - b).abs().max().item()
               for (_, a), (_, b) in zip(_flat(g_1), _flat(g_w))) > 0
    with pytest.raises(ValueError, match="grad_steps"):
        run(grad_steps=0)
    with pytest.raises(ValueError, match="step_weights"):
        run(grad_steps=1, step_weights=[0.5, 0.5])
    with pytest.raises(ValueError, match="loss_space"):
        run(loss_space="relative")


def test_options_that_are_not_ported_are_refused_by_name():
    jcfg, cfg, batch, jparams = _setup("xla", 2)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gb = loop.featurize_batch(cfg, tb)
    params = params_from_jax(jparams, "cpu")
    # every teacher_scatter_hint is ported: "segment" sums what "onehot"
    # sums, as the JAX package's does
    seg = curriculum.curriculum_loss_batched(params, cfg, gb, tb["y_seq"],
                                             teacher_scatter_hint="segment")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jseg = jcurriculum.curriculum_loss_batched(
        jparams, jcfg, jloop.featurize_batch(jcfg, jb), jb["y_seq"],
        teacher_scatter_hint="segment")
    np.testing.assert_allclose(float(seg[0]), float(jseg[0]), rtol=RTOL)
    # accepted: the one-hot hint and unroll_scans (the loop is unrolled)
    a = curriculum.curriculum_loss_batched(params, cfg, gb, tb["y_seq"],
                                           teacher_scatter_hint="onehot",
                                           unroll_scans=True)
    b = curriculum.curriculum_loss_batched(params, cfg, gb, tb["y_seq"])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    np.testing.assert_allclose(float(seg[0]), float(a[0]), rtol=RTOL)
