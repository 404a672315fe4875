"""The port's losses, stored contact edges, window dataset, batch stream
and split against the JAX package's, on the CPU. The data modules are
numpy on both sides, so everything but the losses is held exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
    batch_iterator as jax_batch_iterator,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.models import losses as jlosses
from molecular_dynamics_neural_operator_tpu.train.split import (
    train_valid_split as jax_train_valid_split,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    TrajectoryData,
    WindowDataset,
    batch_iterator,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.models import losses
from molecular_dynamics_neural_operator_tpu_torch.train import (
    train_valid_split,
)

# f32 norms over 36 to 84 values, summed in another order by torch than by
# XLA: a few units in the last place
RTOL = 2e-6


def _pair(seed, shape=(5, 12, 3)):
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=shape) * 5).astype(np.float32)
    x = (y + 0.1 * rng.normal(size=shape)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("name,kw", [
    ("lp_rel", dict()),
    ("lp_rel", dict(size_average=False)),
    ("lp_rel", dict(reduction=False)),
    ("lp_rel", dict(p=1, size_average=False)),
    ("lp_abs", dict()),
    ("lp_abs", dict(size_average=False, d=3)),
    ("lp_abs", dict(reduction=False)),
    ("mse", dict()),
], ids=["rel-mean", "rel-sum", "rel-each", "rel-p1", "abs-mean", "abs-sum-d3",
        "abs-each", "mse"])
def test_losses_match_jax(name, kw):
    x, y = _pair(0)
    got = getattr(losses, name)(torch.as_tensor(x), torch.as_tensor(y), **kw)
    want = getattr(jlosses, name)(jnp.asarray(x), jnp.asarray(y), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("kw", [dict(num_frames=40, seed=13),
                                dict(num_frames=24, num_residues=12, seed=4),
                                dict(num_frames=16, seed=2, threshold=6.0)])
def test_synthetic_trajectory_edges_and_rmsd_bit_identical(kw):
    mine, ref = synthetic_trajectory(**kw), jax_synthetic_trajectory(**kw)
    assert isinstance(mine, TrajectoryData)
    assert len(mine.edge_indices) == len(ref.edge_indices) == kw["num_frames"]
    for a, b in zip(mine.edge_indices, ref.edge_indices):
        assert a.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mine.rmsd, ref.rmsd)
    flat, off = mine.packed_edges()
    jflat, joff = ref.packed_edges()
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(mine.edge_index(3), ref.edge_index(3))


def _datasets(stored=True, **kw):
    opts = dict(window_size=4, graph_mode="sparse", max_edges=128,
                use_stored_contact_maps=stored, **kw)
    mine = WindowDataset(
        synthetic_trajectory(num_frames=24, num_residues=12, seed=4), **opts)
    ref = JaxWindowDataset(
        jax_synthetic_trajectory(num_frames=24, num_residues=12, seed=4),
        use_native=False, **opts)
    return mine, ref


def _same_batch(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("stored", [True, False], ids=["stored", "recomputed"])
@pytest.mark.parametrize("horizon", [1, 3])
def test_get_batch_matches_jax_exactly(stored, horizon):
    mine, ref = _datasets(stored, horizon=horizon)
    assert len(mine) == len(ref)
    idx = np.array([0, 7, 3, len(mine) - 1])
    _same_batch(mine.get_batch(idx), ref.get_batch(idx))


def test_get_batch_rollout_horizon_matches_jax_and_checks_its_range():
    mine, ref = _datasets()
    _same_batch(mine.get_batch([0, 5], rollout_horizon=3),
                ref.get_batch([0, 5], rollout_horizon=3))
    with pytest.raises(ValueError, match="rollout_horizon"):
        mine.get_batch([len(mine) - 1], rollout_horizon=3)


@pytest.mark.parametrize("kw", [
    dict(batch_size=5),
    dict(batch_size=5, epoch=3, seed=2),
    dict(batch_size=5, shuffle=False, drop_last=False),
    dict(batch_size=8, shuffle=False, drop_last=False, pad_last=True),
    dict(batch_size=5, rollout_horizon=5, drop_last=False, pad_last=True),
], ids=["shuffled", "epoch-seed", "remainder", "pad-last", "horizon"])
def test_batch_iterator_matches_jax_exactly(kw):
    mine, ref = _datasets()
    indices = np.arange(len(mine))
    got = list(batch_iterator(mine, indices, **kw))
    want = list(jax_batch_iterator(ref, indices, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same_batch(a, b)
    if kw.get("pad_last"):
        assert got[-1]["w"].sum() < kw["batch_size"]
        assert all(len(b["w"]) == kw["batch_size"] for b in got)


def test_batch_iterator_shuffle_depends_on_seed_and_epoch():
    mine, _ = _datasets()
    idx = np.arange(len(mine))

    def first(**kw):
        return next(batch_iterator(mine, idx, 5, **kw))["window"]

    assert np.array_equal(first(seed=1, epoch=2), first(seed=1, epoch=2))
    assert not np.array_equal(first(seed=1, epoch=2), first(seed=1, epoch=3))
    assert not np.array_equal(first(seed=1, epoch=2), first(seed=2, epoch=2))


def test_window_dataset_refusals():
    traj = synthetic_trajectory(num_frames=24, num_residues=12, seed=4)
    with pytest.raises(ValueError, match="exceeds max_edges"):
        WindowDataset(traj, window_size=4, graph_mode="sparse", max_edges=8)
    with pytest.raises(ValueError, match="longer than the input"):
        WindowDataset(traj, window_size=30, graph_mode="sparse")
    # the dense mode and the blocked layout are ported; the blocked
    # layout refuses what the JAX package refuses
    dense = WindowDataset(traj, window_size=4, graph_mode="dense")
    assert dense.get_batch([0])["adj"].shape == (1, 12, 12)
    with pytest.raises(ValueError, match="divisible by num_residues"):
        WindowDataset(traj, window_size=4, graph_mode="sparse",
                      max_edges=100, edge_layout="blocked")
    with pytest.raises(ValueError, match="requires sparse"):
        WindowDataset(traj, window_size=4, graph_mode="dense",
                      edge_layout="blocked")
    none = WindowDataset(traj, window_size=4, graph_mode="none")
    assert set(none.get_batch([0])) == {"aa", "window", "y"}


@pytest.mark.parametrize("kw", [dict(), dict(split_pct=0.5),
                                dict(method="random", seed=3)])
def test_train_valid_split_matches_jax(kw):
    got, want = train_valid_split(37, **kw), jax_train_valid_split(37, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        train_valid_split(10, method="nope")
