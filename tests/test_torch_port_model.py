"""The PyTorch port's GKN forward against the JAX package's
``gkn_apply_single`` on the sparse one-hot path, on the CPU in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.rollout import scan as jscan
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.rollout import scan
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

BASE = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
            max_edges=160, graph_mode="sparse", compute_dtype="float32")
# f32 sums over <= 160 edges and 32 hidden units through 4 conv layers,
# taken in another order by torch than by XLA
RTOL, ATOL = 1e-5, 2e-5


def _cfgs(**kw):
    opts = {**BASE, **kw}
    return JaxModelConfig(**opts), ModelConfig(**opts)


def _inputs(cfg, seed, batch=None):
    rng = np.random.default_rng(seed)
    shape = (cfg.window_size, cfg.num_residues, 3)
    if batch:
        shape = (batch,) + shape
    base = rng.normal(size=shape[-2:]).astype(np.float32) * 5
    window = (base + 0.3 * rng.normal(size=shape)).astype(np.float32)
    aa = rng.integers(0, 20, cfg.num_residues).astype(np.int32)
    return aa, window


def _jax_graph(cfg, window):
    """The JAX package's sparse graph of the window's last frame(s)."""
    def one(frame):
        adj = jgeo.contact_map(frame, 8.0)
        edges, mask = jgeo.padded_edges_device(adj, cfg.max_edges)
        return jgkn.SparseGraph(
            edges=edges, mask=mask,
            edge_feats=jgeo.edge_features_from_edges(frame, edges))

    frame = jnp.asarray(window[..., -1, :, :])
    return one(frame) if frame.ndim == 2 else jax.vmap(one)(frame)


def _port_graph(jgraph):
    return gkn.SparseGraph(*(torch.as_tensor(np.array(t))
                             for t in jgraph))


@pytest.mark.parametrize("opts", [
    dict(predict_delta=False),
    dict(predict_delta=True, predict_prior="last"),
    dict(predict_delta=True, predict_prior="last", head_scale=0.3),
    dict(predict_delta=True, predict_prior="extrapolate"),
    dict(predict_delta=True, predict_prior="extrapolate",
         prior_damping=0.5, head_scale=0.05),
    dict(predict_delta=True, tie_edge_kernel=False),
], ids=["absolute", "delta-last", "delta-last-scaled", "delta-extrap",
        "delta-damped-scaled", "untied"])
def test_gkn_apply_single_matches_jax(opts):
    jcfg, cfg = _cfgs(**opts)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(7), jcfg))
    aa, window = _inputs(jcfg, 0)
    jgraph = _jax_graph(jcfg, window)
    want, want_latent = jgkn.gkn_apply_single(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(window), jgraph,
        return_latent=True)
    got, latent = gkn.gkn_apply_single(
        params_from_jax(jparams, "cpu"), cfg, torch.as_tensor(aa),
        torch.as_tensor(window), _port_graph(jgraph), return_latent=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent),
                               RTOL, ATOL)


def test_gkn_apply_single_batched_matches_vmapped_jax():
    """Leading axes of window and graph are batch axes (JAX's vmap)."""
    jcfg, cfg = _cfgs(predict_delta=True, predict_prior="extrapolate")
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(8), jcfg))
    aa, window = _inputs(jcfg, 1, batch=3)
    jgraph = _jax_graph(jcfg, window)
    want = jax.vmap(lambda w, g: jgkn.gkn_apply_single(
        jparams, jcfg, jnp.asarray(aa), w, g))(jnp.asarray(window), jgraph)
    got = gkn.gkn_apply_single(params_from_jax(jparams, "cpu"), cfg,
                               torch.as_tensor(aa), torch.as_tensor(window),
                               _port_graph(jgraph))
    assert got.shape == (3, 12, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


def test_residual_prior_matches_jax():
    jcfg, cfg = _cfgs(predict_delta=True, predict_prior="extrapolate",
                      prior_damping=0.9)
    _, window = _inputs(jcfg, 2, batch=2)
    np.testing.assert_array_equal(
        gkn.residual_prior(cfg, torch.as_tensor(window)).numpy(),
        np.asarray(jgkn.residual_prior(jcfg, jnp.asarray(window))))


def test_gkn_init_matches_jax_structure():
    for opts in (dict(), dict(tie_edge_kernel=False), dict(head_init="zero")):
        jcfg, cfg = _cfgs(**opts)
        want = jax.tree.map(lambda a: tuple(a.shape),
                            jgkn.gkn_init(jax.random.PRNGKey(0), jcfg))
        params = gkn.gkn_init(cfg, seed=0, device="cpu")
        got = jax.tree.map(lambda t: tuple(t.shape), params)
        assert got == want
    assert not params["fc2"]["w"].any()


@pytest.mark.parametrize("opts", [dict(window_diff=True),
                                  dict(legacy_no_lstm=True),
                                  dict(scatter_mode="segment"),
                                  dict(kernel_quant="int8"),
                                  dict(neighbor_impl="cell_list"),
                                  dict(graph_mode="dense")])
def test_unported_options_raise(opts):
    """Every option is ported now, the cell list too: each one-step
    forward matches the JAX package's (the cell list's on its own
    rebuild of the window's last frame)."""
    cfg = dataclasses.replace(ModelConfig(**BASE), **opts)
    gkn.check_supported(cfg)
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(9), jcfg))
    aa, window = _inputs(jcfg, 3)
    frame = jnp.asarray(window[-1])
    if cfg.graph_mode == "dense":
        jgraph = jgkn.DenseGraph(jgeo.contact_map(frame, 8.0),
                                 jgeo.dense_edge_features(frame))
        graph = gkn.DenseGraph(*(torch.as_tensor(np.array(t))
                                 for t in jgraph))
    elif cfg.neighbor_impl == "cell_list":
        jgraph, _ = jscan._build_graph(jcfg, frame, 8.0)
        graph, _ = scan._build_graph(cfg, torch.as_tensor(window[-1]), 8.0)
        for name, t in zip(graph._fields, graph):
            np.testing.assert_array_equal(t.numpy(), np.asarray(
                getattr(jgraph, name)), err_msg=name)
    else:
        jgraph = _jax_graph(jcfg, window)
        graph = _port_graph(jgraph)
    want = jgkn.gkn_apply_single(jparams, jcfg, jnp.asarray(aa),
                                 jnp.asarray(window), jgraph)
    got = gkn.gkn_apply_single(params_from_jax(jparams, "cpu"), cfg,
                               torch.as_tensor(aa), torch.as_tensor(window),
                               graph)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)