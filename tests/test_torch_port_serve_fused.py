"""``conv_impl="pallas"`` in the PyTorch port: the plain version of the
fused edge-MLP + conv-stack kernel (``ops/cuda/fused_gkn.py``; what the
wrapper runs on CPU tensors) against the JAX package's Pallas kernel in
interpret mode and against both packages' XLA paths."""

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
from molecular_dynamics_neural_operator_tpu.ops.pallas import (
    fused_gkn as jfused,
)
from molecular_dynamics_neural_operator_tpu.rollout import (
    rollout_scan as jax_rollout_scan,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    fused_gkn as fg,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    sparse_inv_degree,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import rollout_scan
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

# the shapes of tests/test_pallas_fused.py
SMALL = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", compute_dtype="float32")


def _setup(seed=0, **kw):
    opts = {**SMALL, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    window = (rng.normal(size=(4, 12, 3)) * 4).astype(np.float32)
    aa = (np.arange(12) % 20).astype(np.int32)
    return jcfg, cfg, jparams, params_from_jax(jparams, "cpu"), aa, window


def _jax_graph(cfg, frame):
    adj = jgeo.contact_map(frame, 8.0)
    edges, mask = jgeo.padded_edges_device(adj, cfg.max_edges)
    return jgkn.SparseGraph(edges=edges, mask=mask,
                            edge_feats=jgeo.edge_features_from_edges(
                                frame, edges))


def _port_graph(jgraph):
    return gkn.SparseGraph(*(torch.as_tensor(np.array(t)) for t in jgraph))


@pytest.mark.parametrize("cd,tol", [
    # f32: the same sums in another order (the JAX package's own tolerance
    # between its Pallas and XLA paths is rtol 1e-5, atol 1e-6)
    ("float32", 1e-5),
    # bf16: the Pallas body rounds every product xs * K to bf16 before the
    # f32 sum and the port, like both XLA paths, sums exact products and
    # rounds the message once: 2^-8 a product, averaged over 16 inputs and
    # the edges of a node, through 4 layers; 2^-5 of the output's scale
    ("bfloat16", 2.0 ** -5),
])
def test_fused_plain_matches_jax_pallas_interpret(cd, tol):
    jcfg, cfg, jparams, params, aa, window = _setup(compute_dtype=cd)
    jgraph = _jax_graph(jcfg, jnp.asarray(window[-1]))
    x = jgkn._encode_nodes(jparams, jcfg, jnp.asarray(aa),
                           jnp.asarray(window))
    want = jfused.fused_conv_stack_from_graph(
        jparams, jcfg, x, jgraph.edges, jgraph.mask, jgraph.edge_feats,
        interpret=True)
    graph = _port_graph(jgraph)
    before = profiling.counters().get("fused_edge_conv_stack", 0)
    got = fg.fused_conv_stack_from_graph(
        params, cfg, torch.as_tensor(np.array(x)), graph.edges, graph.mask,
        graph.edge_feats)
    assert got.shape == (12, 16) and got.dtype == torch.float32
    # CPU: the plain version
    assert profiling.counters().get("fused_edge_conv_stack", 0) == before
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0.1
    assert np.abs(got.numpy() - np.asarray(want)).max() <= tol * scale


def test_fused_plain_takes_streams_and_ignores_padded_slots():
    """(S, ...) operands equal S single calls, and a padded slot (mask 0)
    counts toward no node's degree whatever it names."""
    _, cfg, _, params, aa, window = _setup(seed=3)
    rng = np.random.default_rng(5)
    s, r, e, w = 3, 12, 128, 16
    real = 70
    mask = torch.zeros(s, e)
    mask[:, :real] = 1.0
    edges = torch.as_tensor(rng.integers(0, r, (s, 2, e)), dtype=torch.int32)
    edges[:, :, real:] = 0
    ef = torch.as_tensor(rng.normal(size=(s, e, 6)).astype(np.float32))
    x0 = torch.as_tensor(rng.normal(size=(s, r, w)).astype(np.float32))
    inv_deg = sparse_inv_degree(edges, mask, r)
    wts = fg.fused_weights(params, cfg)
    out = fg.fused_edge_conv_stack(ef, mask, edges, inv_deg, x0, *wts, 2)
    assert out.shape == (s, r, w)
    for i in range(s):
        one = fg.fused_edge_conv_stack(
            ef[i:i + 1], mask[i:i + 1], edges[i:i + 1], inv_deg[i:i + 1],
            x0[i:i + 1], *wts, 2)
        np.testing.assert_allclose(out[i].numpy(), one[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
    # padded slots pointed at node 5 instead of node 0: nothing changes
    moved = edges.clone()
    moved[:, :, real:] = 5
    assert torch.equal(sparse_inv_degree(moved, mask, r), inv_deg)
    again = fg.fused_edge_conv_stack(ef, mask, moved, inv_deg, x0, *wts, 2)
    np.testing.assert_allclose(again.numpy(), out.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_fused_weights_are_cast_once_and_follow_updates():
    _, cfg, _, params, _, _ = _setup(compute_dtype="bfloat16")
    a = fg.fused_weights(params, cfg)
    assert fg.fused_weights(params, cfg) is a
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32
    assert a[6].dtype == torch.bfloat16 and a[7].dtype == torch.float32
    params["conv1"]["root"].mul_(2.0)  # in place: the version counter moves
    b = fg.fused_weights(params, cfg)
    assert b is not a
    assert torch.equal(b[6], params["conv1"]["root"].to(torch.bfloat16))


@pytest.mark.parametrize("opts", [
    dict(predict_delta=False),
    dict(predict_delta=True, predict_prior="extrapolate", head_scale=0.3),
    dict(predict_delta=True, electrostatics="dh"),
], ids=["absolute", "delta-extrap-scaled", "dh"])
def test_gkn_apply_single_pallas_matches_jax_and_the_ports_xla(opts):
    jcfg, cfg, jparams, params, aa, window = _setup(seed=2,
                                                    conv_impl="pallas", **opts)
    jgraph = _jax_graph(jcfg, jnp.asarray(window[-1]))
    want, want_latent = jgkn.gkn_apply_single(
        jparams, jcfg, jnp.asarray(aa), jnp.asarray(window), jgraph,
        return_latent=True)
    args = (torch.as_tensor(aa), torch.as_tensor(window), _port_graph(jgraph))
    got, latent = gkn.gkn_apply_single(params, cfg, *args,
                                       return_latent=True)
    # f32 sums over <= 128 edges and 32 hidden units through 4 layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), 1e-5, 2e-5)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent),
                               1e-5, 2e-5)
    xla = gkn.gkn_apply_single(
        params, dataclasses.replace(cfg, conv_impl="xla"), *args)
    np.testing.assert_allclose(got.numpy(), xla.numpy(), 1e-5, 1e-5)


def test_pallas_and_xla_agree_in_bf16_to_the_bit_on_the_cpu():
    """Same cast points: on CPU tensors the fused path's plain version
    rounds exactly where the per-layer XLA path does."""
    _, cfg, _, params, aa, window = _setup(seed=4, compute_dtype="bfloat16",
                                           conv_impl="pallas",
                                           predict_delta=True)
    jgraph = _jax_graph(cfg, jnp.asarray(window[-1]))
    args = (torch.as_tensor(aa), torch.as_tensor(window), _port_graph(jgraph))
    got = gkn.gkn_apply_single(params, cfg, *args)
    xla = gkn.gkn_apply_single(
        params, dataclasses.replace(cfg, conv_impl="xla",
                                    fused_conv_vjp=False), *args)
    # bf16 roundings at equal places; the MLP's f32 sums run over the same
    # operands, in the same library call but for the batch shape
    np.testing.assert_allclose(got.numpy(), xla.numpy(), rtol=0, atol=2e-3)


def test_four_step_rollout_with_pallas_matches_jax_and_xla():
    jcfg, cfg, jparams, params, aa, window = _setup(conv_impl="pallas",
                                                    predict_delta=True)
    want, _, _ = jax_rollout_scan(jparams, jcfg, jnp.asarray(aa),
                                  jnp.asarray(window), 4)
    got, _, _ = rollout_scan(params, cfg, torch.as_tensor(aa),
                             torch.as_tensor(window), 4)
    xla, _, _ = rollout_scan(params, dataclasses.replace(cfg,
                                                         conv_impl="xla"),
                             torch.as_tensor(aa), torch.as_tensor(window), 4)
    # the JAX package's tolerance for this rollout (test_pallas_fused.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), xla.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_pallas_refuses_untied_kernels_and_the_legacy_variant():
    _, cfg, _, _, aa, window = _setup()
    bad = dataclasses.replace(cfg, conv_impl="pallas", tie_edge_kernel=False)
    params_u = gkn.gkn_init(bad, seed=0, device="cpu")
    graph = _port_graph(_jax_graph(cfg, jnp.asarray(window[-1])))
    with pytest.raises(ValueError, match="tie_edge_kernel"):
        gkn.gkn_apply_single(params_u, bad, torch.as_tensor(aa),
                             torch.as_tensor(window), graph)
    legacy = dataclasses.replace(cfg, conv_impl="pallas",
                                 legacy_no_lstm=True)
    with pytest.raises(ValueError, match="conv_impl='xla'"):
        gkn.check_supported(legacy)
    with pytest.raises(ValueError, match="unknown conv_impl"):
        gkn.check_supported(dataclasses.replace(cfg, conv_impl="cuda"))
    with pytest.raises(ValueError, match="unknown electrostatics"):
        gkn.check_supported(dataclasses.replace(cfg, electrostatics="pb"))
    gkn.check_supported(dataclasses.replace(cfg, conv_impl="pallas",
                                            electrostatics="dh"))
