"""The port's host input pipeline: the producer thread of
``data/prefetch.py`` and the native packer of ``data/packing.py`` (its own
copy of ``csrc/packing.cpp``), against the JAX package's.

The thread must keep the batches' order, re-raise the producer's
exception at the consumer, floor ``size`` at 1, and leave no thread
behind when the consumer stops early. The packer's three functions must
give the numpy path's arrays bit for bit, and the JAX package's packer's
(g++ builds both here); so must every batch of a ``WindowDataset`` on the
native path.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.data import packing as jax_packing
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    batch_iterator,
    packing,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    prefetch_to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import _build


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "prefetch_to_device"]


@pytest.mark.parametrize("size", [0, 1, 3, 10])
@pytest.mark.parametrize("thread", [True, False])
def test_order_and_every_batch(size, thread):
    batches = [{"i": np.array([i])} for i in range(9)]
    got = [int(b["i"]) for b in prefetch_to_device(
        iter(batches), size, device="cpu", producer_thread=thread)]
    assert got == list(range(9))
    assert not _prefetch_threads()


def test_the_producer_exception_reaches_the_consumer():
    def source():
        for i in range(5):
            if i == 3:
                raise KeyError("batch 3 is broken")
            yield {"i": np.array([i])}

    seen = []
    with pytest.raises(KeyError, match="batch 3 is broken"):
        for b in prefetch_to_device(source(), 2, device="cpu"):
            seen.append(int(b["i"]))
    assert seen == [0, 1, 2]
    assert not _prefetch_threads()


def test_size_is_floored_at_one():
    produced = []

    def source():
        for i in range(50):
            produced.append(i)
            yield {"i": np.array([i])}

    it = prefetch_to_device(source(), 0, device="cpu")
    assert int(next(it)["i"]) == 0
    time.sleep(0.3)
    # one handed out, one in the queue, one waiting for room: not all 50,
    # which an unbounded queue (maxsize 0) would have staged
    assert len(produced) <= 3
    assert [int(b["i"]) for b in it] == list(range(1, 50))


def test_an_early_stop_leaves_no_thread_behind():
    closed = threading.Event()

    def source():
        try:
            for i in range(1000):
                yield {"i": np.array([i])}
        finally:
            closed.set()

    for b in prefetch_to_device(source(), 2, device="cpu"):
        if int(b["i"]) == 4:
            break
    assert closed.is_set()
    assert not _prefetch_threads()
    # an exception in the consumer's loop stops the producer as well
    with pytest.raises(RuntimeError, match="consumer"):
        for b in prefetch_to_device(source(), 2, device="cpu"):
            raise RuntimeError("consumer failed")
    assert not _prefetch_threads()


@pytest.fixture(scope="module")
def traj():
    return synthetic_trajectory(num_frames=300, num_residues=28, seed=4)


def test_the_packer_equals_numpy_and_the_jax_packer(traj):
    assert packing.available(), packing.load_error()
    assert jax_packing.available()
    flat, offsets = traj.packed_edges()
    idx = np.array([5, 0, 17, 17, 250, 3], np.int64)
    r = traj.num_residues
    dense = packing.pack_dense_batch(flat, offsets, idx, r)
    np.testing.assert_array_equal(
        dense, jax_packing.pack_dense_batch(flat, offsets, idx, r))
    edges, mask = packing.pack_padded_batch(flat, offsets, idx, 256)
    j_edges, j_mask = jax_packing.pack_padded_batch(flat, offsets, idx, 256)
    np.testing.assert_array_equal(edges, j_edges)
    np.testing.assert_array_equal(mask, j_mask)
    windows = packing.gather_windows(traj.positions, idx, 10)
    np.testing.assert_array_equal(
        windows, jax_packing.gather_windows(traj.positions, idx, 10))
    # the numpy path's arrays
    np.testing.assert_array_equal(
        windows, traj.positions[idx[:, None] + np.arange(10)])
    for b, i in enumerate(idx):
        e = traj.edge_index(int(i))
        n = e.shape[1]
        np.testing.assert_array_equal(edges[b, :, :n], e)
        assert not edges[b, :, n:].any() and mask[b].sum() == n
        want = np.zeros((r, r), np.float32)
        want[e[0], e[1]] = 1.0
        np.testing.assert_array_equal(dense[b], want)
    assert edges.dtype == np.int32 and mask.dtype == np.float32
    # a frame with more stored edges than slots raises, as the numpy path
    with pytest.raises(ValueError, match="exceeds max_edges 8"):
        packing.pack_padded_batch(flat, offsets, idx, 8)
    # an empty batch
    assert packing.pack_dense_batch(flat, offsets, idx[:0], r).shape == (
        0, r, r)


@pytest.mark.parametrize("graph_mode", ["dense", "sparse", "none"])
def test_native_batches_equal_the_numpy_path_and_jax(traj, graph_mode):
    kw = dict(window_size=10, graph_mode=graph_mode, max_edges=256)
    native = WindowDataset(traj, use_native=True, **kw)
    plain = WindowDataset(traj, use_native=False, **kw)
    jax_ds = JaxWindowDataset(traj, use_native=True, **kw)
    assert native.use_native and not plain.use_native and jax_ds.use_native
    for rollout_horizon in (0, 4):
        it = zip(batch_iterator(native, np.arange(200), 32, seed=1,
                                rollout_horizon=rollout_horizon),
                 batch_iterator(plain, np.arange(200), 32, seed=1,
                                rollout_horizon=rollout_horizon))
        for a, b in it:
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    idx = np.array([7, 1, 99, 150])
    a, j = native.get_batch(idx), jax_ds.get_batch(idx)
    assert a.keys() == j.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], j[k], err_msg=k)


def test_the_dataset_logs_its_path(traj, monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger="molecular_dynamics_neural_"
                     "operator_tpu_torch.data.windows")
    WindowDataset(traj, graph_mode="sparse", max_edges=256)
    assert "native packer" in caplog.text
    caplog.clear()
    WindowDataset(traj, graph_mode="sparse", max_edges=256, use_native=False)
    assert "numpy path (use_native=False)" in caplog.text
    caplog.clear()
    monkeypatch.setattr(packing, "_load", lambda: None)
    monkeypatch.setattr(packing, "_error", "RuntimeError: no compiler")
    ds = WindowDataset(traj, graph_mode="sparse", max_edges=256)
    assert not ds.use_native
    assert "not available (RuntimeError: no compiler)" in caplog.text


def test_the_packer_is_built_apart_from_the_kernels(tmp_path, monkeypatch):
    """An edit to csrc/packing.cpp rebuilds the packer and no kernel."""
    assert packing.SOURCE.parent == _build.CSRC
    assert "packing" not in _build.SOURCES
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(packing, "SOURCE", csrc / "packing.cpp")
    kernels = {n: _build._target(n).name for n in _build.SOURCES}
    before = packing._target().name
    with open(csrc / "packing.cpp", "a") as f:
        f.write("// edited\n")
    assert packing._target().name != before
    assert {n: _build._target(n).name for n in _build.SOURCES} == kernels


def test_a_train_epoch_through_the_thread_equals_the_plain_generator(traj):
    """The same batches reach the step, in the same order."""
    ds = WindowDataset(traj, window_size=10, graph_mode="sparse",
                       max_edges=256)
    seen = {True: [], False: []}
    for thread in (True, False):
        for b in prefetch_to_device(
                batch_iterator(ds, np.arange(100), 16, seed=3), 2,
                device="cpu", producer_thread=thread):
            assert isinstance(b["window"], torch.Tensor)
            seen[thread].append(b["window"].sum().item())
    assert seen[True] == seen[False] and len(seen[True]) == 6
