"""``graph_encode``'s plain version above 128 residues against the JAX
package's XLA-path functions: the contact graph, the padded edge list with
its count, the edge features, the inverse degrees and the node encoder
(LSTM, lstm_fc, embedding, fc1, with and without the Debye-Hückel
potential). On the card the kernel is held against this plain version
(``tests/test_torch_port_kernels.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.ops import edge_conv as jconv
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

R = 160
# f32: LSTM transcendentals and sums of a few products taken in another
# order by torch than by XLA; with dh a sum over 159 sources
RTOL, ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("dh", [False, True], ids=["plain", "dh"])
@pytest.mark.parametrize("max_edges", [2048, 1024],
                         ids=["fits", "overflows"])
def test_graph_encode_plain_matches_jax_above_128_residues(dh, max_edges):
    opts = dict(width=16, ker_width=64, depth=1, window_size=10,
                num_residues=R, max_edges=max_edges, graph_mode="sparse",
                compute_dtype="float32",
                electrostatics="dh" if dh else "none")
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    traj = jax_synthetic_trajectory(num_frames=40, num_residues=R, seed=5)
    windows = np.stack([traj.positions[0:10], traj.positions[25:35]])
    aa = np.asarray(traj.aminoacids)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(1), jcfg))
    weights = pr.rollout_weights(params_from_jax(jparams, "cpu"), cfg, aa,
                                 "cpu")
    edges, mask, count, over, inv_deg, ef, x0 = pr.graph_encode_plain(
        torch.as_tensor(windows), weights, 8.0, max_edges, torch.float32)
    assert bool((count > max_edges).all()) == (max_edges == 1024)
    assert bool((count <= max_edges).all()) == (max_edges == 2048)
    for s in range(2):
        pos = jnp.asarray(windows[s, -1])
        adj = jgeo.contact_map(pos, 8.0)
        je, jm, jc = jgeo.padded_edges_device(adj, max_edges,
                                              return_count=True)
        np.testing.assert_array_equal(edges[s].numpy(), np.asarray(je))
        np.testing.assert_array_equal(mask[s].numpy(), np.asarray(jm))
        assert int(count[s]) == int(jc) and bool(over[s]) == (
            int(jc) > max_edges)
        np.testing.assert_array_equal(
            ef[s].numpy(), np.asarray(jgeo.edge_features_from_edges(pos, je)))
        np.testing.assert_array_equal(
            inv_deg[s].numpy(),
            np.asarray(jconv.sparse_inv_degree(je, jm, R)))
        want = jgkn._encode_nodes(jparams, jcfg, jnp.asarray(aa),
                                  jnp.asarray(windows[s]))
        np.testing.assert_allclose(x0[s].numpy(), np.asarray(want), RTOL,
                                   ATOL)
