"""The PyTorch port's ops, geometry, data and checkpoint loading against
the JAX package, on the CPU in f32.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its matmuls at HIGHEST precision (tests/conftest.py), so
the only differences left are summation order: each tolerance says so.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.data import (
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.ops import edge_conv as jconv
from molecular_dynamics_neural_operator_tpu.ops import lstm as jlstm
from molecular_dynamics_neural_operator_tpu.ops import mlp as jmlp
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry import contact
from molecular_dynamics_neural_operator_tpu_torch.ops import (
    edge_conv,
    lstm,
    mlp,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    load_params_npz,
    params_from_jax,
)

# f32 sums of at most a few hundred products, taken in another order by
# torch than by XLA: a few ulp of the largest partial sum.
RTOL, ATOL = 1e-5, 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), rtol=rtol, atol=atol)


def _graph(seed, r=12, e=160, scale=4.0):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(r, 3)) * scale).astype(np.float32)
    adj = np.asarray(jgeo.contact_map(jnp.asarray(pos), 8.0))
    edges, mask = jgeo.dense_to_padded_edges(adj, e)
    return pos, edges, mask


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_mlp_apply_matches_jax(cd):
    rng = np.random.default_rng(0)
    params = _np_tree(jmlp.mlp_init(jax.random.PRNGKey(1), [6, 32, 32, 64]))
    x = rng.normal(size=(2, 40, 6)).astype(np.float32) * 5
    jcd = None if cd is None else jnp.bfloat16
    want = jmlp.mlp_apply(params, jnp.asarray(x), compute_dtype=jcd)
    got = mlp.mlp_apply(params_from_jax(params, "cpu"), torch.as_tensor(x),
                        compute_dtype=None if cd is None else torch.bfloat16)
    # bf16 operands are rounded identically on both sides (round to
    # nearest even), so the bf16 case holds the same f32-order tolerance
    _close(got, want)


def test_linear_apply_matches_jax():
    rng = np.random.default_rng(1)
    params = _np_tree(jmlp.linear_init(jax.random.PRNGKey(2), 7, 16))
    x = rng.normal(size=(12, 7)).astype(np.float32)
    _close(mlp.linear_apply(params_from_jax(params, "cpu"),
                            torch.as_tensor(x)),
           jmlp.linear_apply(params, jnp.asarray(x)))


def test_lstm_apply_matches_jax():
    rng = np.random.default_rng(2)
    params = _np_tree(jlstm.lstm_init(jax.random.PRNGKey(3), 3, 3))
    xs = rng.normal(size=(10, 2, 28, 3)).astype(np.float32) * 3
    # transcendental functions (sigmoid, tanh) differ in the last ulp
    # between the two libraries, compounded over 10 steps
    _close(lstm.lstm_apply(params_from_jax(params, "cpu"),
                           torch.as_tensor(xs)),
           jlstm.lstm_apply(params, jnp.asarray(xs)), rtol=1e-5, atol=2e-6)


def test_edge_kernel_matrices_matches_jax():
    rng = np.random.default_rng(3)
    params = _np_tree(jmlp.mlp_init(jax.random.PRNGKey(4), [6, 32, 32, 64]))
    ef = rng.normal(size=(50, 6)).astype(np.float32) * 5
    got = edge_conv.edge_kernel_matrices(params_from_jax(params, "cpu"),
                                         torch.as_tensor(ef), 8)
    assert got.shape == (50, 8, 8) and got.dtype == torch.float32
    _close(got, jconv.edge_kernel_matrices(params, jnp.asarray(ef), 8))


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_conv_sparse_onehot_matches_jax(seed):
    rng = np.random.default_rng(seed + 10)
    pos, edges, mask = _graph(seed)
    w = 8
    conv = _np_tree(jconv.edge_conv_init(jax.random.PRNGKey(seed), w))
    x = rng.normal(size=(12, w)).astype(np.float32)
    kernels = rng.normal(size=(edges.shape[1], w, w)).astype(np.float32)
    inv_deg = np.asarray(jconv.sparse_inv_degree(jnp.asarray(edges),
                                                 jnp.asarray(mask), 12))
    want = jconv.edge_conv_sparse(conv, jnp.asarray(x), jnp.asarray(kernels),
                                  jnp.asarray(edges), jnp.asarray(mask),
                                  jnp.asarray(inv_deg), "onehot")
    got = edge_conv.edge_conv_sparse(
        params_from_jax(conv, "cpu"), torch.as_tensor(x),
        torch.as_tensor(kernels), torch.as_tensor(edges),
        torch.as_tensor(mask), torch.as_tensor(inv_deg), "onehot")
    _close(got, want)


def _blocked_layer(seed, r=64, d=8, w=16):
    """A cell-list block layout (slot n*d + k targets node n) with about
    40 % padded slots between the real ones, naming node 0."""
    rng = np.random.default_rng(seed)
    e = r * d
    mask = (rng.random(e) < 0.6).astype(np.float32)
    src = (rng.integers(0, r, e) * mask).astype(np.int32)
    edges = np.stack([src, np.repeat(np.arange(r), d).astype(np.int32)])
    x = rng.normal(size=(r, w)).astype(np.float32)
    kernels = (rng.normal(size=(e, w, w)) / w ** 0.5).astype(np.float32)
    g = rng.normal(size=(r, w)).astype(np.float32)
    return x, kernels, edges, mask, g


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_conv_sparse_blocked_matches_jax_with_gradients(seed, cd):
    """The blocked layer, one product a node over its slots, against the
    JAX package's message a slot summed per node: forward, dx and dK, in
    f32 and on bf16-rounded operands (the kernel tensor in bf16, as the
    model makes it). dK is one product an element rounded once on both
    sides: equal. dx is rounded to bf16 after an f32 sum taken in another
    order: within one bf16 step (2**-8) of the largest element."""
    r, w = 64, 16
    x, kernels, edges, mask, g = _blocked_layer(seed)
    conv = _np_tree(jconv.edge_conv_init(jax.random.PRNGKey(seed), w))
    inv_deg = np.asarray(jconv.sparse_inv_degree(
        jnp.asarray(edges), jnp.asarray(mask), r, "blocked"))
    tcd = None if cd is None else torch.bfloat16
    tk = torch.as_tensor(kernels).to(tcd or torch.float32)
    kernels = tk.float().numpy()

    def jlayer(x_, k_):
        return jconv.edge_conv_sparse(
            conv, x_, k_, jnp.asarray(edges), jnp.asarray(mask),
            jnp.asarray(inv_deg), "blocked",
            None if cd is None else jnp.bfloat16)

    want, vjp = jax.vjp(jlayer, jnp.asarray(x), jnp.asarray(kernels))
    want_dx, want_dk = vjp(jnp.asarray(g))
    tx = torch.as_tensor(x).requires_grad_(True)
    tk.requires_grad_(True)
    got = edge_conv.edge_conv_sparse(
        params_from_jax(conv, "cpu"), tx, tk, torch.as_tensor(edges),
        torch.as_tensor(mask), torch.as_tensor(inv_deg), "blocked", tcd)
    dx, dk = torch.autograd.grad(got, (tx, tk), torch.as_tensor(g))
    _close(got, want)
    if cd is None:
        _close(dx, want_dx)
    else:
        np.testing.assert_allclose(
            dx.numpy(), np.asarray(want_dx), rtol=0,
            atol=2.0 ** -8 * float(np.abs(np.asarray(want_dx)).max()))
    np.testing.assert_array_equal(dk.float().numpy(), np.asarray(want_dk))


def test_sparse_inv_degree_matches_jax_and_ignores_padding():
    pos, edges, mask = _graph(4)
    got = edge_conv.sparse_inv_degree(torch.as_tensor(edges),
                                      torch.as_tensor(mask), 12)
    want = jconv.sparse_inv_degree(jnp.asarray(edges), jnp.asarray(mask), 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the padded slots all name node 0; they must not raise its degree
    real = int(((edges[1] == 0) & (mask > 0)).sum())
    assert got[0].item() == pytest.approx(1.0 / max(real, 1))


def test_unported_modes_raise():
    """The segment and blocked degrees are ported (they match the one-hot
    count and the JAX package's); a blocked count on a list that is not
    in the block layout raises the JAX package's ValueError."""
    pos, edges, mask = _graph(4, e=168)  # 14 slots a node
    te, tm = torch.as_tensor(edges), torch.as_tensor(mask)
    onehot = edge_conv.sparse_inv_degree(te, tm, 12)
    for mode in ("segment", "blocked"):
        got = edge_conv.sparse_inv_degree(te, tm, 12, mode)
        want = jconv.sparse_inv_degree(jnp.asarray(edges), jnp.asarray(mask),
                                       12, mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if mode == "segment":
            np.testing.assert_array_equal(got.numpy(), onehot.numpy())
    with pytest.raises(ValueError, match="block layout"):
        edge_conv.sparse_inv_degree(torch.zeros(2, 4, dtype=torch.int32),
                                    torch.ones(4), 3, "blocked")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contact_map_matches_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(3, 28, 3)) * 6).astype(np.float32)
    got = contact.contact_map(torch.as_tensor(pos), 8.0)
    want = jgeo.contact_map(jnp.asarray(pos), 8.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.diagonal(got.numpy(), axis1=-2, axis2=-1) == 1).all()


@pytest.mark.parametrize("r,cap", [(28, 224), (12, 160), (28, 64)])
def test_padded_edges_device_matches_jax_exactly(r, cap):
    """Row-major order, padding at src=dst=0 with mask 0, the true count;
    (28, 64) is far above capacity, so edges are dropped."""
    traj = synthetic_trajectory(num_frames=8, num_residues=r, seed=13)
    adj = contact.contact_map(torch.as_tensor(traj.positions), 8.0)
    edges, mask, count = contact.padded_edges_device(adj, cap,
                                                     return_count=True)
    for i in range(adj.shape[0]):
        je, jm, jc = jgeo.padded_edges_device(jnp.asarray(adj[i].numpy()),
                                              cap, return_count=True)
        np.testing.assert_array_equal(edges[i].numpy(), np.asarray(je))
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jm))
        assert int(count[i]) == int(jc)
    assert edges.dtype == torch.int32
    if cap == 64:
        assert bool((count > cap).all()) and bool((mask == 1).all())


def test_edge_features_from_edges_matches_jax():
    pos, edges, _ = _graph(5)
    got = contact.edge_features_from_edges(torch.as_tensor(pos),
                                           torch.as_tensor(edges))
    want = jgeo.edge_features_from_edges(jnp.asarray(pos),
                                         jnp.asarray(edges))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(num_frames=4000, seed=13),
                                dict(num_frames=64, num_residues=12, seed=3),
                                dict(num_frames=50, seed=2, dt=0.01)])
def test_synthetic_trajectory_bit_identical(kw):
    mine = synthetic_trajectory(**kw)
    ref = jax_synthetic_trajectory(**kw)
    np.testing.assert_array_equal(mine.positions, ref.positions)
    np.testing.assert_array_equal(mine.aminoacids, ref.aminoacids)
    assert mine.positions.dtype == np.float32
    assert mine.aminoacids.dtype == np.int32


def test_load_params_npz_reads_bench_checkpoint_as_f32():
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "bench_ckpt.npz"
    params = load_params_npz(path, device="cpu")
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(params, "")
    with np.load(path) as raw:
        assert sorted(flat) == sorted(raw.files)
        assert len(flat) == 21
        for k, v in flat.items():
            assert v.dtype == torch.float32 and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(),
                                          raw[k].astype(np.float32))
    assert params["edge_kernel"]["layer_2"]["w"].shape == (1024, 4096)
