"""The port's remaining GKN options against the JAX package on the CPU in
f32: ``window_diff``, ``legacy_no_lstm`` (with TrainState checkpoints in
both directions), the int8 ``kernel_quant``, the ``segment`` scatter past
the one-hot bound, the ``blocked`` scatter with the blocked
``WindowDataset`` layout and their ``ValueError``s, and the scatter hints
of rebuilt graphs.

Tolerances: f32, rtol 2e-4 and atol 1e-5 (scaled by a gradient leaf's
largest element above 1); the int8 codes bit for bit and their scales to
rtol 1e-7; the blocked slots exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import geometry as jgeo
from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
    TrainConfig as JaxTrainConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.ops import edge_conv as jconv
from molecular_dynamics_neural_operator_tpu.rollout import scan as jscan
from molecular_dynamics_neural_operator_tpu.train import (
    create_train_state as jax_create_train_state,
)
from molecular_dynamics_neural_operator_tpu.train import (
    curriculum as jcurriculum,
)
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jcheckpoint,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry import (
    contact_map,
    edge_features_from_edges,
    padded_edges_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn
from molecular_dynamics_neural_operator_tpu_torch.ops import edge_conv
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    train_conv as tc,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import scan
from molecular_dynamics_neural_operator_tpu_torch.train import (
    create_train_state,
    curriculum,
    loop,
    make_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import checkpoint

RTOL, ATOL = 2e-4, 1e-5
BASE = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
            max_edges=144, graph_mode="sparse", compute_dtype="float32",
            predict_delta=True)
BATCH = 5


def _cfgs(**kw):
    opts = {**BASE, **kw}
    return JaxModelConfig(**opts), ModelConfig(**opts)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jgkn.gkn_init(jax.random.PRNGKey(seed), jcfg))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flat(v, name)
        else:
            yield name, v


def _assert_grads_close(grads, jgrads):
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(1.0, float(np.abs(want[name]).max()))
        np.testing.assert_allclose(g.numpy(), want[name], RTOL, ATOL * scale,
                                   err_msg=name)


def _batch(edge_layout="csr", max_edges=144, k=0, seed=4):
    traj = jax_synthetic_trajectory(num_frames=24, num_residues=12,
                                    seed=seed)
    ds = JaxWindowDataset(traj, window_size=4, graph_mode="sparse",
                          max_edges=max_edges, use_native=False,
                          edge_layout=edge_layout)
    return ds.get_batch(np.arange(BATCH), rollout_horizon=k)


def _both(jcfg, cfg, jparams, batch, scatter_hint=None):
    """Both packages' batched output and, through the loss, every
    gradient: ((out, (l2, grads)), (jax out, (jax l2, jax grads)))."""
    jb = jloop.featurize_batch(jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    want = jgkn.gkn_apply(jparams, jcfg, jb, scatter_hint=scatter_hint)
    (jl2, _), jgrads = jax.value_and_grad(jloop._loss_fn, has_aux=True)(
        jparams, jcfg, jb)
    tb = loop.featurize_batch(cfg, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    params = checkpoint.params_from_jax(jparams, "cpu")
    with torch.no_grad():
        got = gkn.gkn_apply(params, cfg, tb, scatter_hint=scatter_hint)
    (l2, _), grads = loop.loss_and_grads(params, cfg, tb)
    return (got, (l2, grads)), (want, (jl2, jgrads))


def _assert_both(got, want):
    (out, (l2, grads)), (jout, (jl2, jgrads)) = got, want
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), RTOL, ATOL)
    np.testing.assert_allclose(float(l2), float(jl2), rtol=RTOL)
    _assert_grads_close(grads, jgrads)


# ---- window_diff ------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_window_diff_forward_and_gradients_match_jax(impl):
    """Per-layer and on the training kernel (its plain version here, the
    JAX package's Pallas kernel in interpret mode)."""
    jcfg, cfg = _cfgs(window_diff=True, window_diff_scale=30.0,
                      train_conv_impl=impl)
    _assert_both(*_both(jcfg, cfg, _params(jcfg, 1), _batch()))


def test_window_diff_takes_the_training_kernel_and_the_fused_kernel(
        monkeypatch):
    jcfg, cfg = _cfgs(window_diff=True, train_conv_impl="pallas")
    tb = loop.featurize_batch(cfg, {k: torch.as_tensor(v)
                                    for k, v in _batch().items()})
    assert gkn.takes_train_kernel(cfg, tb)
    calls = []
    real = gkn.train_conv
    monkeypatch.setattr(gkn, "train_conv",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        gkn.gkn_apply(checkpoint.params_from_jax(_params(jcfg), "cpu"), cfg,
                      tb)
    assert calls == [1]
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}
    # the fused kernel (its plain version) serves window_diff as the JAX
    # package's Pallas kernel does
    jcfg, cfg = _cfgs(window_diff=True, conv_impl="pallas")
    jparams = _params(jcfg, 2)
    traj = synthetic_trajectory(num_frames=20, num_residues=12, seed=3)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    want, _, _ = jscan.rollout_scan(jparams, jcfg, jnp.asarray(aa),
                                    jnp.asarray(w0), 3)
    with torch.no_grad():
        got, _, _ = scan.rollout_scan(
            checkpoint.params_from_jax(jparams, "cpu"), cfg,
            torch.as_tensor(aa), torch.as_tensor(w0), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), RTOL, ATOL)


# ---- legacy_no_lstm ---------------------------------------------------------

def test_legacy_no_lstm_structure_forward_and_gradients_match_jax():
    jcfg, cfg = _cfgs(legacy_no_lstm=True, window_size=1)
    jparams = _params(jcfg, 3)
    shapes = jax.tree.map(lambda t: tuple(t.shape),
                          gkn.gkn_init(cfg, device="cpu"))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert not {"lstm", "lstm_fc", "conv2"} & set(shapes)
    traj = jax_synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    batch = JaxWindowDataset(traj, window_size=1, graph_mode="sparse",
                             max_edges=144, use_native=False
                             ).get_batch(np.arange(BATCH))
    _assert_both(*_both(jcfg, cfg, jparams, batch))
    with pytest.raises(ValueError, match="conv_impl='xla'"):
        gkn.check_supported(dataclasses.replace(cfg, conv_impl="pallas"))


def test_legacy_no_lstm_never_takes_the_training_kernel(monkeypatch):
    jcfg, cfg = _cfgs(legacy_no_lstm=True, train_conv_impl="pallas")
    _, xcfg = _cfgs(legacy_no_lstm=True)
    calls = []
    monkeypatch.setattr(gkn, "train_conv", lambda *a: calls.append(1))
    tb = loop.featurize_batch(cfg, {k: torch.as_tensor(v)
                                    for k, v in _batch().items()})
    params = checkpoint.params_from_jax(_params(jcfg), "cpu")
    with torch.no_grad():
        assert torch.equal(gkn.gkn_apply(params, cfg, tb),
                           gkn.gkn_apply(params, xcfg, tb))
    assert not calls


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_legacy_train_state_checkpoints_cross_packages(direction, tmp_path):
    jcfg, cfg = _cfgs(legacy_no_lstm=True)
    tcfg = dict(lr=1e-3, batch_size=BATCH)
    jstate, jtx, _ = jax_create_train_state(
        jax.random.PRNGKey(0), jcfg, JaxTrainConfig(**tcfg))
    state, tx, _ = create_train_state(
        0, cfg, TrainConfig(**tcfg), device="cpu",
        params=checkpoint.params_from_jax(
            jax.tree.map(np.asarray, jstate.params), "cpu"))
    batch = _batch()
    jstate, _ = jloop.make_train_step(jcfg, jtx, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, _ = make_train_step(cfg, tx)(
        state, {k: torch.as_tensor(v) for k, v in batch.items()})
    path = tmp_path / "legacy.npz"
    if direction == "jax_to_port":
        jcheckpoint.save_checkpoint(path, jstate, {"epoch": 0})
        got, meta = checkpoint.restore_checkpoint(path, state)
        want = jstate
    else:
        checkpoint.save_checkpoint(path, state, {"epoch": 0})
        want, meta = jcheckpoint.restore_checkpoint(path, jstate)
        got = state
    assert meta == {"epoch": 0}
    flat = jcheckpoint._flatten_with_paths(want)
    port = checkpoint._train_state_flat(got)
    assert set(port) == set(flat)
    assert not any("lstm" in k or "conv2" in k for k in port)
    for key, w in flat.items():
        if key != ".rng":
            np.testing.assert_allclose(port[key], w, RTOL, ATOL,
                                       err_msg=key)
    params, _ = checkpoint.restore_subtree(path, gkn.gkn_init(cfg,
                                                              device="cpu"),
                                           ".params", device="cpu")
    for name, p in _flat(params):
        np.testing.assert_array_equal(p.numpy(),
                                      port[f".params/{name}"], err_msg=name)


# ---- int8 -------------------------------------------------------------------

def test_quantize_kernels_int8_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    k = (rng.normal(size=(3, 40, 8, 8)) * 0.5).astype(np.float32)
    k[0, 0] = 0.0  # an all-zero kernel: the 1e-30 floor
    want_k8, want_s = jconv.quantize_kernels_int8(jnp.asarray(k))
    k8, s = edge_conv.quantize_kernels_int8(torch.as_tensor(k))
    assert k8.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(k8.numpy(), np.asarray(want_k8))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-7)
    # |k8 s - k| <= s / 2, plus one f32 unit in the last place of k
    err = np.abs(k8.numpy() * s.numpy()[..., None, None] - k)
    bound = s.numpy()[..., None, None] / 2 + np.spacing(np.abs(k))
    assert (err <= bound).all()
    # halves round to even in both packages
    half = torch.tensor([[[0.5, 1.5], [2.5, 127.0]]])
    assert edge_conv.quantize_kernels_int8(half)[0].tolist() == [
        [[0, 2], [2, 127]]]


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_int8_forward_and_gradients_match_jax(tied):
    jcfg, cfg = _cfgs(kernel_quant="int8", tie_edge_kernel=tied, width=8,
                      ker_width=16)
    _assert_both(*_both(jcfg, cfg, _params(jcfg, 5), _batch()))


def test_int8_is_refused_where_jax_refuses_it():
    jcfg, cfg = _cfgs(kernel_quant="int8")
    params = checkpoint.params_from_jax(_params(jcfg), "cpu")
    traj = synthetic_trajectory(num_frames=8, num_residues=12, seed=1)
    w = torch.as_tensor(traj.positions[:4])
    frame = w[-1]
    dense = gkn.DenseGraph(contact_map(frame), torch.zeros(12, 12, 6))
    for c, g in ((cfg, dense),
                 (dataclasses.replace(cfg, conv_impl="pallas"), None)):
        if g is None:
            edges, mask = padded_edges_device(contact_map(frame), 144)
            g = gkn.SparseGraph(edges, mask,
                                edge_features_from_edges(frame, edges))
        with pytest.raises(ValueError, match="sparse XLA conv path"):
            gkn.gkn_apply_single(params, c, torch.as_tensor(traj.aminoacids),
                                 w, g)
    with pytest.raises(ValueError, match="unknown kernel_quant"):
        gkn.check_supported(dataclasses.replace(cfg, kernel_quant="int4"))


# ---- segment past the one-hot bound -----------------------------------------

SEG_R = 520


def _large_inputs():
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 52, size=(SEG_R, 3)).astype(np.float32)
    window = (base + 0.2 * rng.normal(size=(2, 4, SEG_R, 3))).astype(
        np.float32)
    aa = rng.integers(0, 20, SEG_R).astype(np.int32)
    return aa, window


def test_segment_past_512_nodes_matches_jax_and_the_forced_onehot():
    opts = dict(width=8, ker_width=16, depth=1, num_residues=SEG_R,
                max_edges=12 * SEG_R)
    jcfg, cfg = _cfgs(**opts)
    jparams = _params(jcfg, 6)
    aa, window = _large_inputs()

    def graph(frame):
        adj = jgeo.contact_map(frame, 8.0)
        edges, mask = jgeo.padded_edges_device(adj, opts["max_edges"])
        return jgkn.SparseGraph(edges, mask,
                                jgeo.edge_features_from_edges(frame, edges))

    jg = jax.vmap(graph)(jnp.asarray(window[:, 0]))
    assert float(jg.mask.sum(-1).max()) < opts["max_edges"]
    batch = {"aa": aa, "window": window, "y": window[:, -1] + 0.1,
             "edges": np.asarray(jg.edges), "mask": np.asarray(jg.mask)}
    got, want = _both(jcfg, cfg, jparams, batch)
    _assert_both(got, want)
    # the forced one-hot scatter gives the same sums
    tb = loop.featurize_batch(cfg, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    params = checkpoint.params_from_jax(jparams, "cpu")
    with torch.no_grad():
        onehot = gkn.gkn_apply(params, cfg, tb, scatter_hint="onehot")
    np.testing.assert_allclose(onehot.numpy(), got[0].numpy(), RTOL, ATOL)
    assert scan.rebuilt_scatter_hint(cfg, SEG_R) == "segment"


# ---- blocked ----------------------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_blocked_scatter_on_blocked_batches_matches_jax(impl):
    """Padded slots sit between real slots: the per-layer "blocked"
    reduction and the training kernel (plain version here, the Pallas
    kernel in interpret mode in JAX) both hold."""
    jcfg, cfg = _cfgs(scatter_mode="blocked", train_conv_impl=impl)
    batch = _batch("blocked")
    assert (np.diff(batch["mask"], axis=-1) > 0).any()  # gaps in the slots
    _assert_both(*_both(jcfg, cfg, _params(jcfg, 7), batch))


def test_blocked_and_onehot_agree_on_the_same_graphs():
    jcfg, cfg = _cfgs(scatter_mode="blocked")
    params = checkpoint.params_from_jax(_params(jcfg, 8), "cpu")
    tb = loop.featurize_batch(cfg, {k: torch.as_tensor(v)
                                    for k, v in _batch("blocked").items()})
    with torch.no_grad():
        blocked = gkn.gkn_apply(params, cfg, tb)
        onehot = gkn.gkn_apply(params, cfg, tb, scatter_hint="onehot")
    np.testing.assert_allclose(blocked.numpy(), onehot.numpy(), RTOL, ATOL)


def test_blocked_layout_value_errors_match_jax():
    x = torch.zeros(5, 4)
    edges = torch.zeros(2, 12, dtype=torch.int32)
    mask = torch.ones(12)
    conv = {"root": torch.zeros(4, 4), "bias": torch.zeros(4)}
    for call in (lambda: edge_conv.sparse_inv_degree(edges, mask, 5,
                                                     "blocked"),
                 lambda: edge_conv.edge_conv_sparse(
                     conv, x, torch.zeros(12, 4, 4), edges, mask,
                     torch.ones(5), "blocked")):
        with pytest.raises(ValueError) as got:
            call()
        with pytest.raises(ValueError) as want:
            jconv._check_blocked_layout(12, 5)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown scatter_mode"):
        edge_conv.edge_conv_sparse(conv, x, torch.zeros(12, 4, 4), edges,
                                   mask, torch.ones(5), "sorted")
    traj = synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    jtraj = jax_synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    for kw in (dict(graph_mode="dense", edge_layout="blocked"),
               dict(graph_mode="sparse", edge_layout="blocked",
                    max_edges=100),
               dict(graph_mode="sparse", edge_layout="blocked",
                    max_edges=36),
               dict(graph_mode="sparse", edge_layout="rows")):
        with pytest.raises(ValueError) as got:
            WindowDataset(traj, window_size=4, **kw)
        with pytest.raises(ValueError) as want:
            JaxWindowDataset(jtraj, window_size=4, use_native=False, **kw)
        assert str(got.value) == str(want.value)
    # recomputed maps: the in-degree is checked batch by batch
    ds = WindowDataset(traj, window_size=4, graph_mode="sparse",
                       edge_layout="blocked", max_edges=36,
                       use_stored_contact_maps=False)
    jds = JaxWindowDataset(jtraj, window_size=4, graph_mode="sparse",
                           edge_layout="blocked", max_edges=36,
                           use_stored_contact_maps=False, use_native=False)
    with pytest.raises(ValueError) as got:
        ds.get_batch([0, 1])
    with pytest.raises(ValueError) as want:
        jds.get_batch([0, 1])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("stored", [True, False], ids=["stored", "recomputed"])
def test_blocked_window_dataset_slots_match_jax_exactly(stored):
    traj = synthetic_trajectory(num_frames=40, num_residues=12, seed=6)
    jtraj = jax_synthetic_trajectory(num_frames=40, num_residues=12, seed=6)
    kw = dict(window_size=4, graph_mode="sparse", edge_layout="blocked",
              max_edges=192, use_stored_contact_maps=stored)
    ds = WindowDataset(traj, **kw)
    jds = JaxWindowDataset(jtraj, use_native=False, **kw)
    assert ds.max_degree == jds.max_degree == 16
    for idx in ([0, 5, 9, 30], [3], list(range(36))):
        got, want = ds.get_batch(idx), jds.get_batch(idx)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if stored:
        np.testing.assert_array_equal(ds._slot_flat, jds._slot_flat)


# ---- the scatter hints of rebuilt graphs ------------------------------------

@pytest.mark.parametrize("kw,r", [
    (dict(graph_mode="dense"), 12),
    (dict(), 12),
    (dict(scatter_mode="blocked"), 12),
    (dict(), 600),
    (dict(neighbor_impl="cell_list"), 600),
    (dict(neighbor_impl="cell_list"), 12),
])
def test_rebuilt_scatter_hint_matches_jax(kw, r):
    jcfg, cfg = _cfgs(**kw)
    assert scan.rebuilt_scatter_hint(cfg, r) == \
        jscan.rebuilt_scatter_hint(jcfg, r)


def test_a_blocked_dataset_curriculum_rebuilds_with_the_onehot_hint():
    """K = 2 on a blocked batch: the first step reduces by slot, the free
    step's CSR rebuild must not; loss and gradients as JAX's."""
    jcfg, cfg = _cfgs(scatter_mode="blocked")
    jparams = _params(jcfg, 9)
    batch = _batch("blocked", k=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opts = dict(return_overflow=True, coord_clip=1000.0)
    (jl, (jm, _)), jgrads = jax.value_and_grad(
        lambda p: jcurriculum.curriculum_loss_batched(
            p, jcfg, jloop.featurize_batch(jcfg, jb), jb["y_seq"], **opts),
        has_aux=True)(jparams)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, (m, _)), grads = loop.value_and_grad(
        lambda p: curriculum.curriculum_loss_batched(
            p, cfg, loop.featurize_batch(cfg, tb), tb["y_seq"], **opts),
        checkpoint.params_from_jax(jparams, "cpu"))
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(m), float(jm), rtol=RTOL)
    _assert_grads_close(grads, jgrads)
