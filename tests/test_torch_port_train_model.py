"""The port's batched training forward ``gkn_apply`` and its loss and
gradients, with ``train_conv_impl`` "pallas" (the hand-written kernel's
plain version on the CPU) and "xla" (the per-layer path), against the JAX
package's ``gkn_apply`` and ``jax.value_and_grad(_loss_fn)``."""

import dataclasses

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
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    train_conv as tc,
)
from molecular_dynamics_neural_operator_tpu_torch.train import loop
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

BASE = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
            max_edges=128, graph_mode="sparse", compute_dtype="float32",
            predict_delta=True)
# f32, the bound the JAX package's own test of its training kernel uses:
# sums over 32 hidden units, <= 16 products per message, a node's edges and
# 4 layers, taken in another order by torch than by XLA
RTOL, ATOL = 2e-4, 1e-5


def _setup(impl, **kw):
    opts = {**BASE, "train_conv_impl": impl, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    traj = jax_synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    ds = JaxWindowDataset(traj, window_size=4, graph_mode="sparse",
                          max_edges=128, use_native=False)
    batch = ds.get_batch(np.arange(5))
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, cfg, batch, jparams


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


@pytest.mark.parametrize("frame", ["first", "last"])
def test_featurize_batch_matches_jax(frame):
    jcfg, cfg, batch, _ = _setup("xla")
    want = jloop.featurize_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, frame)
    got = loop.featurize_batch(cfg, _tensors(batch), frame)
    np.testing.assert_array_equal(got.graph.edge_feats.numpy(),
                                  np.asarray(want.graph.edge_feats))
    np.testing.assert_array_equal(got.graph.edges.numpy(),
                                  np.asarray(want.graph.edges))
    np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
    with pytest.raises(ValueError, match="graph_frame"):
        loop.featurize_batch(cfg, _tensors(batch), "middle")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("kw", [dict(), dict(predict_prior="extrapolate",
                                             head_scale=0.3)],
                         ids=["delta-last", "delta-extrap-scaled"])
def test_gkn_apply_matches_jax_output_and_latent(impl, kw):
    jcfg, cfg, batch, jparams = _setup(impl, **kw)
    jb = jloop.featurize_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want, want_lat = jgkn.gkn_apply(jparams, jcfg, jb, return_latent=True)
    with torch.no_grad():
        got, lat = gkn.gkn_apply(
            params_from_jax(jparams, "cpu"), cfg,
            loop.featurize_batch(cfg, _tensors(batch)), return_latent=True)
    assert got.shape == (5, 12, 3) and lat.shape == (5, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), RTOL, ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_loss_and_every_parameter_gradient_match_jax(impl):
    jcfg, cfg, batch, jparams = _setup(impl)
    jb = jloop.featurize_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    (want_l2, (want_mse, _)), want_grads = jax.value_and_grad(
        jloop._loss_fn, has_aux=True)(jparams, jcfg, jb)
    (l2, (m, out)), grads = loop.loss_and_grads(
        params_from_jax(jparams, "cpu"), cfg,
        loop.featurize_batch(cfg, _tensors(batch)))
    np.testing.assert_allclose(float(l2), float(want_l2), rtol=1e-5)
    np.testing.assert_allclose(float(m), float(want_mse), rtol=1e-5)
    want_flat = dict(_flat(jax.tree.map(np.asarray, want_grads)))
    got_flat = dict(_flat(grads))
    assert set(got_flat) == set(want_flat) and len(got_flat) == 21
    for name, g in got_flat.items():
        np.testing.assert_allclose(g.numpy(), want_flat[name], RTOL, ATOL,
                                   err_msg=name)


def test_both_impls_agree_in_bf16_and_the_cast_passes_gradients_through():
    """bf16: the two paths round at the same places; their f32 sums differ
    in order, so a rounding may flip by one bf16 unit (2^-8 of a value):
    2^-5 of each gradient's scale. The gradient reaches the edge-kernel MLP
    through the cast of K to bf16 (straight through, rounded to bf16)."""
    _, cfg_p, batch, jparams = _setup("pallas", compute_dtype="bfloat16")
    cfg_x = dataclasses.replace(cfg_p, train_conv_impl="xla")
    params = params_from_jax(jparams, "cpu")
    res = {}
    for name, cfg in (("pallas", cfg_p), ("xla", cfg_x)):
        (l2, _), grads = loop.loss_and_grads(
            params, cfg, loop.featurize_batch(cfg, _tensors(batch)))
        res[name] = (float(l2), dict(_flat(grads)))
    assert abs(res["pallas"][0] - res["xla"][0]) <= 2e-2 * res["xla"][0]
    for name, g in res["pallas"][1].items():
        ref = res["xla"][1][name]
        assert ref.abs().max() > 0, name
        assert (g - ref).abs().max() <= 2.0 ** -5 * ref.abs().max(), name
    last = res["pallas"][1]["edge_kernel/layer_2/w"]
    assert torch.equal(last, last.to(torch.bfloat16).float())


def _batch_for(cfg, n_nodes=12):
    aa = torch.zeros(n_nodes, dtype=torch.int32)
    graph = gkn.SparseGraph(torch.zeros(1, 2, 4, dtype=torch.int32),
                            torch.zeros(1, 4), torch.zeros(1, 4, 6))
    return gkn.GKNBatch(aa, torch.zeros(1, 4, n_nodes, 3), graph,
                        torch.zeros(1, n_nodes, 3))


@pytest.mark.parametrize("kw,nodes,kernel", [
    (dict(), 12, True),
    (dict(), 512, True),
    (dict(), 513, False),
    (dict(tie_edge_kernel=False), 12, False),
    (dict(depth=0), 12, False),
    (dict(legacy_no_lstm=True), 12, False),
    (dict(kernel_quant="int8"), 12, False),
    (dict(train_conv_impl="xla"), 12, False),
], ids=["tied", "512-nodes", "513-nodes", "untied", "depth-0", "legacy",
        "int8", "xla"])
def test_train_kernel_dispatch_follows_the_jax_rule(kw, nodes, kernel):
    cfg = ModelConfig(**{**BASE, "train_conv_impl": "pallas", **kw})
    assert gkn.takes_train_kernel(cfg, _batch_for(cfg, nodes)) is kernel


def _count_train_conv_calls(monkeypatch) -> list:
    """Wrap the kernel wrapper as ``gkn`` sees it; one entry per call."""
    called, orig = [], gkn.train_conv
    monkeypatch.setattr(
        gkn, "train_conv", lambda *a, **k: called.append(1) or orig(*a, **k))
    return called


@pytest.mark.parametrize("kw", [dict(tie_edge_kernel=False), dict(depth=0)],
                         ids=["untied", "depth-0"])
def test_pallas_impl_falls_to_the_per_layer_path_and_matches_jax(
        kw, monkeypatch):
    """Where the JAX package sends ``train_conv_impl="pallas"`` down its
    per-layer path the port does too, and never reaches the kernel's
    wrapper."""
    jcfg, cfg, batch, jparams = _setup("pallas", **kw)
    jb = jloop.featurize_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jgkn.gkn_apply(jparams, jcfg, jb)
    called = _count_train_conv_calls(monkeypatch)
    with torch.no_grad():
        got = gkn.gkn_apply(params_from_jax(jparams, "cpu"), cfg,
                            loop.featurize_batch(cfg, _tensors(batch)))
    assert not called
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_pallas_impl_reaches_the_kernel_wrapper_and_checks_the_config(
        monkeypatch):
    _, cfg, batch, jparams = _setup("pallas")
    called = _count_train_conv_calls(monkeypatch)
    with torch.no_grad():
        gkn.gkn_apply(params_from_jax(jparams, "cpu"), cfg,
                      loop.featurize_batch(cfg, _tensors(batch)))
    assert called == [1]
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}
    with pytest.raises(ValueError, match="unknown train_conv_impl"):
        gkn.check_supported(dataclasses.replace(cfg, train_conv_impl="cuda"))
    # the legacy variant is ported and, as in the JAX package, never takes
    # the training kernel
    called.clear()
    with torch.no_grad():
        gkn.gkn_apply(params_from_jax(jparams, "cpu"),
                      dataclasses.replace(cfg, legacy_no_lstm=True),
                      loop.featurize_batch(cfg, _tensors(batch)))
    assert called == []


@pytest.mark.parametrize("width", [72, 96])
def test_pallas_impl_trains_at_any_width_on_the_cpu_and_matches_jax(
        width, monkeypatch):
    """Widths past the training kernels' tensor-core body (64): on CPU
    tensors the kernel's plain version runs, as the JAX package runs its
    Pallas kernel, and the output and every parameter's gradient match
    ``jax.value_and_grad``."""
    jcfg, cfg, batch, jparams = _setup("pallas", width=width)
    jb = jloop.featurize_batch(
        jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jgkn.gkn_apply(jparams, jcfg, jb)
    (want_l2, _), want_grads = jax.value_and_grad(
        jloop._loss_fn, has_aux=True)(jparams, jcfg, jb)
    params = params_from_jax(jparams, "cpu")
    tb = loop.featurize_batch(cfg, _tensors(batch))
    called = _count_train_conv_calls(monkeypatch)
    with torch.no_grad():
        got = gkn.gkn_apply(params, cfg, tb)
    assert called == [1] and got.shape == (5, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    (l2, _), grads = loop.loss_and_grads(params, cfg, tb)
    np.testing.assert_allclose(float(l2), float(want_l2), rtol=1e-5)
    want_flat = dict(_flat(jax.tree.map(np.asarray, want_grads)))
    got_flat = dict(_flat(grads))
    assert set(got_flat) == set(want_flat)
    for name, g in got_flat.items():
        np.testing.assert_allclose(g.numpy(), want_flat[name], RTOL, ATOL,
                                   err_msg=name)
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}


@pytest.mark.parametrize("width", [16, 64, 60, 72, 96])
def test_train_kernel_width_rule_holds_off_the_cpu(width):
    """On and off the CPU every width takes the kernel path, as in the
    JAX package: the dispatch has no width rule (a meta tensor stands for
    a tensor on the card here). On the card the kernels see the width
    padded with zero columns to a multiple of 8."""
    cfg = ModelConfig(**{**BASE, "train_conv_impl": "pallas",
                         "width": width})
    assert gkn.takes_train_kernel(cfg, _batch_for(cfg)) is True
    batch = _batch_for(cfg)._replace(
        window=torch.zeros(1, 4, 12, 3, device="meta"))
    assert gkn.takes_train_kernel(cfg, batch) is True
    x0 = torch.zeros(2, 12, width)
    kt = torch.ones(2, 5, width * width)
    roots = [torch.ones(width, width), torch.ones(width)] * 2
    padded = tc._pad_width(x0, kt, *roots)
    wp = -(-width // 8) * 8
    assert padded[0].shape == (2, 12, wp) and padded[1].shape == (2, 5, wp * wp)
    assert [tuple(t.shape) for t in padded[2:]] == [(wp, wp), (wp,)] * 2
    assert padded[1].sum().item() == 5 * 2 * width * width
    assert padded[2][:width, :width].sum().item() == width * width
