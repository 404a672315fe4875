"""The PyTorch port's continuous-batching rollout server and its TCP front,
on the CPU: the cases of tests/test_serving_server.py (the mesh server
on several ranks is in tests/test_torch_port_parallel.py; here a mesh of
one rank), the same trace of requests through the JAX ``RolloutServer``
and the port's, and segment chaining to the bit.

Every wait has its own time limit, so a hung scheduler fails a test and
does not hang the run."""

import contextlib
import dataclasses
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.serving import (
    RolloutServer as JaxRolloutServer,
)
from molecular_dynamics_neural_operator_tpu_torch.cli import (
    serve as serve_cli,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import rollout_scan
from molecular_dynamics_neural_operator_tpu_torch.serving import (
    RolloutResult,
    RolloutServer,
)
from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
    _next_pow2,
    _pad_size,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
    save_checkpoint,
)

OPTS = dict(width=8, ker_width=16, depth=1, window_size=4, num_residues=10,
            max_edges=128, graph_mode="sparse", compute_dtype="float32",
            predict_delta=True)
WAIT = 120  # seconds a test waits for a result before it fails
# A batch of S streams sums the same f32 products as one stream, but a
# product over S*E rows may take them in another order than one over E
# rows; fed back for up to 30 steps (the JAX tests' tolerance)
BATCH_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = JaxModelConfig(**OPTS), ModelConfig(**OPTS)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(0), jcfg))
    traj = synthetic_trajectory(num_frames=64, num_residues=10, seed=5)
    return cfg, params_from_jax(jparams, "cpu"), traj, jcfg, jparams


def _server(setup, **kw):
    cfg, params = setup[0], setup[1]
    return RolloutServer(params, cfg, device="cpu", **kw)


@contextlib.contextmanager
def _serving(setup, params=None, cfg=None, **kw):
    """A server whose shutdown, too, has a time limit."""
    srv = RolloutServer(setup[1] if params is None else params,
                        setup[0] if cfg is None else cfg, device="cpu", **kw)
    ok = False
    try:
        yield srv
        ok = True
    finally:
        srv.close(drain=ok, timeout=WAIT)


def _direct(setup, aa, w0, n, one_stream_batch=False):
    """A dedicated rollout. ``one_stream_batch`` runs it as the server runs
    a lone request, with a stream axis of 1: bit equality holds at the same
    stream count only, since PyTorch's batched products may sum in another
    order than its unbatched ones."""
    aa = torch.as_tensor(np.asarray(aa))
    w0 = torch.as_tensor(np.asarray(w0, np.float32))
    if one_stream_batch:
        aa, w0 = aa[None], w0[None]
    with torch.no_grad():
        coords, final, _ = rollout_scan(setup[1], setup[0], aa, w0, n)
    if one_stream_batch:
        coords, final = coords[0], final[0]
    return coords.numpy(), final.numpy()


def test_single_request_matches_direct_rollout(setup):
    traj = setup[2]
    aa, w0 = traj.aminoacids, traj.positions[:4]
    with _serving(setup, segment_steps=5, max_streams=4) as srv:
        res = srv.rollout(aa, w0, 12, timeout=WAIT)  # 2 segments + tail of 2
    want, want_final = _direct(setup, aa, w0, 12, one_stream_batch=True)
    assert isinstance(res, RolloutResult)
    # one request is one stream: the segments run the direct rollout's ops
    np.testing.assert_array_equal(res.coords, want)
    np.testing.assert_array_equal(res.final_window, want_final)
    np.testing.assert_allclose(res.coords, _direct(setup, aa, w0, 12)[0],
                               **BATCH_TOL)
    assert res.coords.shape == (12, 10, 3) and res.coords.dtype == np.float32
    assert res.edge_overflow is False


def test_tail_shorter_than_window(setup):
    # num_steps=2 < window_size=4: the carry is re-derived after the tail
    traj = setup[2]
    aa, w0 = traj.aminoacids, traj.positions[:4]
    with _serving(setup, segment_steps=8, max_streams=2) as srv:
        res = srv.rollout(aa, w0, 2, timeout=WAIT)
    want, want_final = _direct(setup, aa, w0, 2, one_stream_batch=True)
    np.testing.assert_array_equal(res.coords, want)
    np.testing.assert_array_equal(res.final_window, want_final)
    np.testing.assert_array_equal(res.final_window,
                                  np.concatenate([w0[2:], want]))


def test_concurrent_requests_each_match(setup):
    traj = setup[2]
    aa = traj.aminoacids
    reqs = [(traj.positions[i:i + 4], 3 + 4 * i) for i in range(5)]
    with _serving(setup, segment_steps=4, max_streams=4) as srv:
        futs = [srv.submit(aa, w0, n) for w0, n in reqs]
        results = [f.result(timeout=WAIT) for f in futs]
        stats = srv.stats
    for (w0, n), res in zip(reqs, results):
        want, want_final = _direct(setup, aa, w0, n)
        np.testing.assert_allclose(res.coords, want, **BATCH_TOL)
        np.testing.assert_allclose(res.final_window, want_final, **BATCH_TOL)
    assert stats["requests_completed"] == 5
    assert stats["steps_served"] == sum(n for _, n in reqs)
    assert 0 < stats["occupancy"] <= 1


def test_requests_join_mid_flight(setup):
    # a long request is in flight; a short one submitted later joins at a
    # segment boundary and both are right
    traj = setup[2]
    aa = traj.aminoacids
    with _serving(setup, segment_steps=3, max_streams=4) as srv:
        long_f = srv.submit(aa, traj.positions[:4], 30)
        deadline = time.monotonic() + WAIT
        while srv.stats["segments_run"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        short_f = srv.submit(aa, traj.positions[8:12], 4)
        short = short_f.result(timeout=WAIT)
        long = long_f.result(timeout=WAIT)
    want_s, _ = _direct(setup, aa, traj.positions[8:12], 4)
    want_l, _ = _direct(setup, aa, traj.positions[:4], 30)
    np.testing.assert_allclose(short.coords, want_s, **BATCH_TOL)
    np.testing.assert_allclose(long.coords, want_l, **BATCH_TOL)


def test_per_request_amino_acid_sequences(setup):
    traj = setup[2]
    rng = np.random.default_rng(3)
    aas = [traj.aminoacids, rng.integers(0, 20, size=10).astype(np.int32)]
    w0 = traj.positions[:4]
    with _serving(setup, segment_steps=4, max_streams=2) as srv:
        results = [f.result(timeout=WAIT)
                   for f in srv.submit_many([(a, w0, 6) for a in aas])]
    wants = [_direct(setup, a, w0, 6)[0] for a in aas]
    for res, want in zip(results, wants):
        np.testing.assert_allclose(res.coords, want, **BATCH_TOL)
    assert not np.allclose(wants[0], wants[1], atol=1e-3)


def test_more_requests_than_streams(setup):
    traj = setup[2]
    aa = traj.aminoacids
    with _serving(setup, segment_steps=4, max_streams=2) as srv:
        futs = [srv.submit(aa, traj.positions[i:i + 4], 5) for i in range(6)]
        results = [f.result(timeout=WAIT) for f in futs]
        stats = srv.stats
    for i, res in enumerate(results):
        want, _ = _direct(setup, aa, traj.positions[i:i + 4], 5)
        np.testing.assert_allclose(res.coords, want, **BATCH_TOL)
    assert stats["requests_completed"] == 6 and stats["steps_served"] == 30
    assert stats["steps_computed"] % 4 == 0


def test_submit_many_shares_the_first_segment_and_pads_to_powers_of_two(
        setup):
    """Requests enqueued together join one segment; 3 requests pad to 4
    streams, 5 on 4 streams leave one for later."""
    traj = setup[2]
    aa = traj.aminoacids
    with _serving(setup, segment_steps=4, max_streams=4) as srv:
        futs = srv.submit_many([(aa, traj.positions[i:i + 4], 4)
                                for i in range(3)])
        results = [f.result(timeout=WAIT) for f in futs]
        assert srv.stats == {"segments_run": 1, "steps_computed": 16,
                             "steps_served": 12, "requests_completed": 3,
                             "occupancy": 0.75}
        futs = srv.submit_many([(aa, traj.positions[i:i + 4], 6)
                                for i in range(5)])
        results += [f.result(timeout=WAIT) for f in futs]
        stats = srv.stats
    # then 4 streams for 2 segments (8 steps for 6), then 1 stream for 2
    assert stats["segments_run"] == 1 + 2 + 2
    assert stats["steps_computed"] == 16 + 2 * 16 + 2 * 4
    assert stats["steps_served"] == 12 + 30
    for i, res in enumerate(results[3:]):
        want, _ = _direct(setup, aa, traj.positions[i:i + 4], 6)
        np.testing.assert_allclose(res.coords, want, **BATCH_TOL)
    with _serving(setup) as srv:
        with pytest.raises(ValueError, match="window must be"):
            srv.submit_many([(aa, traj.positions[:4], 2),
                             (aa, traj.positions[:3], 2)])
        assert srv.stats["segments_run"] == 0


def test_pad_sizes():
    assert [_next_pow2(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    assert [_pad_size(n, 8) for n in range(1, 9)] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert _pad_size(5, 6) == 6 and _pad_size(3, 6) == 4


def test_mesh_is_refused_until_it_is_ported(setup, tmp_path):
    """The mesh server on a process group of this process alone: it serves
    as the server without a mesh does, and refuses ``impl="persistent"``
    and a ``max_streams`` that does not divide over the data axis (one
    rank: every count divides)."""
    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        MeshConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_mesh,
    )

    traj = setup[2]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), device_type="cpu")
        with pytest.raises(ValueError, match="impl='scan'"):
            _server(setup, mesh=mesh, impl="persistent",
                    aa=np.zeros(10, np.int32))
        with _serving(setup, segment_steps=4, max_streams=3,
                      mesh=mesh) as srv:
            res = srv.rollout(traj.aminoacids, traj.positions[:4], 6,
                              timeout=WAIT)
        want, want_final = _direct(setup, traj.aminoacids,
                                   traj.positions[:4], 6,
                                   one_stream_batch=True)
        np.testing.assert_array_equal(res.coords, want)
        np.testing.assert_array_equal(res.final_window, want_final)
    finally:
        dist.destroy_process_group()


def test_constructor_refusals(setup):
    for kw, match in ((dict(segment_steps=0), "segment_steps"),
                      (dict(max_streams=0), "max_streams"),
                      (dict(impl="pallas"), "unknown impl"),
                      (dict(impl="persistent",
                            aa=np.zeros(10, np.int32), stream_chunk=2),
                       "stream_chunk")):
        with pytest.raises(ValueError, match=match):
            _server(setup, **kw)
    # dense and cell-list configurations are served now
    # (tests/test_torch_port_dense.py and tests/test_torch_port_cells.py
    # hold their results)
    dense = dataclasses.replace(setup[0], graph_mode="dense")
    RolloutServer(setup[1], dense, device="cpu").close(timeout=WAIT)
    cells = dataclasses.replace(setup[0], neighbor_impl="cell_list")
    RolloutServer(setup[1], cells, device="cpu").close(timeout=WAIT)


def test_submit_validation(setup):
    traj = setup[2]
    srv = _server(setup, segment_steps=4, max_streams=2)
    try:
        with pytest.raises(ValueError, match="aa must be"):
            srv.submit(np.zeros(7, np.int32), traj.positions[:4], 3)
        with pytest.raises(ValueError, match="window must be"):
            srv.submit(traj.aminoacids, traj.positions[:3], 3)
        with pytest.raises(ValueError, match="num_steps"):
            srv.submit(traj.aminoacids, traj.positions[:4], 0)
    finally:
        srv.close(timeout=WAIT)
    with pytest.raises(RuntimeError, match="shut down"):
        srv.submit(traj.aminoacids, traj.positions[:4], 3)


@pytest.mark.parametrize("opts", [{}, dict(electrostatics="dh")],
                         ids=["plain", "dh"])
def test_persistent_impl(setup, opts):
    # the kernel rollout (plain versions on the CPU); one shared sequence
    traj = setup[2]
    cfg = dataclasses.replace(setup[0], **opts)
    jcfg = dataclasses.replace(setup[3], **opts)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(1), jcfg))
    params = params_from_jax(jparams, "cpu")
    aa = np.asarray(traj.aminoacids, np.int32)
    w0 = traj.positions[:4]
    pr.reset_launch_counts()
    with _serving(setup, params, cfg, segment_steps=4, max_streams=2,
                  impl="persistent", aa=aa) as srv:
        with pytest.raises(ValueError, match="one amino-acid sequence"):
            srv.submit((aa + 1) % 20, w0, 3)
        res = srv.rollout(aa, w0, 6, timeout=WAIT)
    want, want_final, _ = pr.make_persistent_rollout_fn(
        cfg, 6, device="cpu")(params, aa, w0)
    np.testing.assert_array_equal(res.coords, want.numpy())
    np.testing.assert_array_equal(res.final_window, want_final.numpy())
    assert pr.launch_counts()["graph_encode"] == 0  # CPU: plain versions
    # the same request through the JAX server on its Pallas kernel
    # (interpret mode): f32 sums in another order, fed back for 6 steps
    with JaxRolloutServer(jparams, jcfg, segment_steps=4, max_streams=2,
                          impl="persistent", aa=aa) as jsrv:
        jres = jsrv.rollout(aa, w0, 6, timeout=WAIT)
    np.testing.assert_allclose(res.coords, jres.coords, rtol=2e-4, atol=2e-4)
    assert res.edge_overflow == jres.edge_overflow


def test_persistent_impl_requires_aa(setup):
    with pytest.raises(ValueError, match="pass it as aa="):
        _server(setup, impl="persistent")


def test_scan_impl_with_the_fused_kernel_and_stream_chunk(setup):
    traj = setup[2]
    cfg = dataclasses.replace(setup[0], conv_impl="pallas")
    aa = traj.aminoacids
    reqs = [(aa, traj.positions[i:i + 4], 5) for i in range(4)]
    with _serving(setup, cfg=cfg, segment_steps=4, max_streams=4,
                  stream_chunk=2) as srv:
        results = [f.result(timeout=WAIT) for f in srv.submit_many(reqs)]
        assert srv.stats["steps_computed"] == 2 * 16
    for (_, w0, n), res in zip(reqs, results):
        want, _ = _direct(setup, aa, w0, n)  # conv_impl="xla"
        np.testing.assert_allclose(res.coords, want, **BATCH_TOL)


def test_warmup_and_stats(setup):
    traj = setup[2]
    with _serving(setup, segment_steps=2, max_streams=4) as srv:
        srv.warmup()
        res = srv.rollout(traj.aminoacids, traj.positions[:4], 2,
                          timeout=WAIT)
        stats = srv.stats
    assert res.coords.shape == (2, 10, 3)
    assert stats["segments_run"] == 1  # warmup does not count
    assert stats["occupancy"] == 1.0  # one stream, no pad, no tail waste
    assert stats["steps_computed"] == stats["steps_served"] == 2
    with _serving(setup, segment_steps=2, max_streams=6, impl="persistent",
                 aa=traj.aminoacids) as srv:
        srv.warmup()  # 1, 2, 4 and the full load of 6
        assert srv.stats == {"segments_run": 0, "steps_computed": 0,
                             "steps_served": 0, "requests_completed": 0,
                             "occupancy": 0.0}


def test_close_without_drain_cancels(setup):
    traj = setup[2]
    srv = _server(setup, segment_steps=2, max_streams=2)
    futs = [srv.submit(traj.aminoacids, traj.positions[:4], 10_000)
            for _ in range(3)]
    futs += srv.submit_many([(traj.aminoacids, traj.positions[:4], 10_000)])
    srv.close(drain=False, timeout=WAIT)
    for f in futs:
        # it was cancelled (or, for a short request, already served)
        with pytest.raises(RuntimeError, match="shut down"):
            f.result(timeout=5)


def test_a_failing_scheduler_fails_every_waiter(setup, monkeypatch):
    traj = setup[2]
    srv = _server(setup, segment_steps=2, max_streams=2)

    def boom(aa_b, win_b):
        raise FloatingPointError("the segment failed")

    monkeypatch.setattr(srv, "_segment", boom)
    futs = srv.submit_many([(traj.aminoacids, traj.positions[:4], 4)] * 3)
    for f in futs:
        with pytest.raises(FloatingPointError, match="segment failed"):
            f.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="scheduler died"):
        srv.submit(traj.aminoacids, traj.positions[:4], 2)
    srv.close(timeout=WAIT)


def test_a_hung_scheduler_times_out_the_waiter_and_the_shutdown(setup,
                                                               monkeypatch):
    traj = setup[2]
    srv = _server(setup, segment_steps=2, max_streams=2)
    release = threading.Event()
    segment = srv._segment

    def stuck(aa_b, win_b):
        release.wait(timeout=WAIT)
        return segment(aa_b, win_b)

    monkeypatch.setattr(srv, "_segment", stuck)
    fut = srv.submit(traj.aminoacids, traj.positions[:4], 2)
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.2)
    with pytest.raises(TimeoutError, match="scheduler thread"):
        srv.close(timeout=0.2)
    release.set()
    assert fut.result(timeout=WAIT).coords.shape == (2, 10, 3)
    srv.close(timeout=WAIT)


def test_many_client_threads_lose_no_request_and_no_count(setup):
    """More client threads than cores, a shortened switch interval: every
    request is answered with its own trajectory and the counters add up."""
    import sys

    traj = setup[2]
    aa = traj.aminoacids
    horizons = [1 + (3 * i) % 7 for i in range(24)]
    results = [None] * len(horizons)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _serving(setup, segment_steps=3, max_streams=4) as srv:
            def client(i):
                results[i] = srv.rollout(aa, traj.positions[i:i + 4],
                                         horizons[i], timeout=WAIT)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(horizons))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
                assert not t.is_alive()
            stats = srv.stats
    finally:
        sys.setswitchinterval(before)
    assert stats["requests_completed"] == len(horizons)
    assert stats["steps_served"] == sum(horizons)
    assert stats["steps_computed"] >= stats["steps_served"]
    assert stats["steps_computed"] % 3 == 0
    for i, (n, res) in enumerate(zip(horizons, results)):
        want, _ = _direct(setup, aa, traj.positions[i:i + 4], n)
        np.testing.assert_allclose(res.coords, want, **BATCH_TOL)


@pytest.mark.parametrize("impl", ["scan", "persistent"])
def test_chaining_64_and_36_equals_100_to_the_bit(setup, impl):
    """Segments chained through the carried window equal one rollout at the
    same stream count: a 100-step request served as 64 + 36, and a
    64-step request resubmitted from its final window for 36 more."""
    traj = setup[2]
    aa, w0 = np.asarray(traj.aminoacids, np.int32), traj.positions[:4]
    kw = dict(impl=impl, aa=aa if impl == "persistent" else None)
    with _serving(setup, segment_steps=64, max_streams=2, **kw) as srv:
        whole = srv.rollout(aa, w0, 100, timeout=WAIT)
        first = srv.rollout(aa, w0, 64, timeout=WAIT)
        rest = srv.rollout(aa, first.final_window, 36, timeout=WAIT)
    if impl == "scan":
        want, want_final = _direct(setup, aa, w0, 100, one_stream_batch=True)
    else:
        want, want_final, _ = pr.rollout_kernels(setup[1], setup[0], aa, w0,
                                                 100, device="cpu")
        want, want_final = want.numpy(), want_final.numpy()
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(whole.coords, want)
    np.testing.assert_array_equal(whole.final_window, want_final)
    np.testing.assert_array_equal(
        np.concatenate([first.coords, rest.coords]), want)
    np.testing.assert_array_equal(rest.final_window, want_final)


def test_same_trace_through_the_jax_server_and_the_port(setup):
    """The slice as a whole: coordinates within the stated tolerance, equal
    ``edge_overflow`` and equal ``stats``. The trace is one whose packing
    does not depend on thread timing: requests one after another on four
    streams, then six at once on a single stream (served first come, first
    served)."""
    cfg, params, traj, jcfg, jparams = setup
    rng = np.random.default_rng(11)
    horizons = [12, 2, 5, 10, 1]
    trace = [(rng.integers(0, 20, size=10).astype(np.int32),
              traj.positions[3 * i:3 * i + 4], n)
             for i, n in enumerate(horizons)]

    def one_by_one(server):
        with server as srv:
            results = [srv.rollout(*req, timeout=WAIT) for req in trace]
            return results, srv.stats

    def queued(server):
        with server as srv:
            futs = [srv.submit(*req) for req in trace + trace[:1]]
            return [f.result(timeout=WAIT) for f in futs], srv.stats

    for run, kw in ((one_by_one, dict(segment_steps=5, max_streams=4)),
                    (queued, dict(segment_steps=4, max_streams=1))):
        got, stats = run(_serving(setup, **kw))
        want, jstats = run(JaxRolloutServer(jparams, jcfg, **kw))
        assert stats == jstats
        assert stats["requests_completed"] == len(got)
        for res, jres in zip(got, want):
            assert res.coords.shape == jres.coords.shape
            # f32 sums in another order than XLA's, fed back for <= 12 steps
            np.testing.assert_allclose(res.coords, jres.coords, rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(res.final_window, jres.final_window,
                                       rtol=2e-4, atol=2e-4)
            assert res.edge_overflow == jres.edge_overflow


def test_edge_overflow_is_reported_per_request(setup):
    cfg, params, traj, jcfg, jparams = setup
    tight = dataclasses.replace(cfg, max_edges=16)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    far = w0 * 100.0  # no contacts but the self pairs: 10 edges
    with _serving(setup, cfg=tight, segment_steps=2, max_streams=2,
                  clip=1e4) as srv:
        futs = srv.submit_many([(aa, w0, 2), (aa, far, 2)])
        near_res, far_res = [f.result(timeout=WAIT) for f in futs]
    assert near_res.edge_overflow is True and far_res.edge_overflow is False
    with JaxRolloutServer(jparams, dataclasses.replace(jcfg, max_edges=16),
                          segment_steps=2, max_streams=2, clip=1e4) as jsrv:
        assert jsrv.rollout(aa, w0, 2, timeout=WAIT).edge_overflow is True


def _ask(f, obj):
    f.write(json.dumps(obj).encode() + b"\n")
    f.flush()
    return json.loads(f.readline())


def test_tcp_server_end_to_end(setup):
    cfg, params, traj = setup[:3]
    args = serve_cli.parse_args(["--port", "0", "--segment_steps", "4",
                                 "--max_streams", "4", "--device", "cpu",
                                 "--max_request_steps", "50"])
    ready = {"event": threading.Event()}
    t = threading.Thread(target=serve_cli.serve, args=(params, cfg, args),
                         kwargs={"ready": ready}, daemon=True)
    t.start()
    assert ready["event"].wait(timeout=60)
    aa, w0 = traj.aminoacids, traj.positions[:4]
    with socket.create_connection(("127.0.0.1", ready["port"]),
                                  timeout=60) as s:
        f = s.makefile("rwb")
        resp = _ask(f, {"id": "r1", "aa": np.asarray(aa).tolist(),
                        "window": np.asarray(w0, np.float32).tolist(),
                        "num_steps": 6})
        assert resp["id"] == "r1" and "error" not in resp
        want, want_final = _direct(setup, aa, w0, 6, one_stream_batch=True)
        np.testing.assert_array_equal(
            np.asarray(resp["coords"], np.float32), want)
        np.testing.assert_array_equal(
            np.asarray(resp["final_window"], np.float32), want_final)
        assert resp["edge_overflow"] is False
        # errors keep the connection alive
        bad = _ask(f, {"id": "r2", "aa": [0], "window": [[0.0]],
                       "num_steps": 1})
        assert bad["id"] == "r2" and "aa must be" in bad["error"]
        too_long = _ask(f, {"id": "r3", "aa": np.asarray(aa).tolist(),
                            "window": np.asarray(w0).tolist(),
                            "num_steps": 51})
        assert "max_request_steps" in too_long["error"]
        f.write(b"this is not json\n")
        f.flush()
        assert "error" in json.loads(f.readline())
        stats = _ask(f, {"op": "stats", "id": "r4"})
        assert stats["id"] == "r4"
        assert stats["stats"]["requests_completed"] == 1
        assert stats["stats"]["steps_served"] == 6
    ready["tcp"].shutdown()
    t.join(timeout=30)
    assert not t.is_alive()


def test_cli_loads_a_run_directory_and_a_checkpoint(setup, tmp_path):
    cfg, params = setup[0], setup[1]
    run = tmp_path / "run"
    save_checkpoint(run / "best.npz", params, {"epoch": 4})
    (run / "config.json").write_text(json.dumps(
        {"model": dataclasses.asdict(cfg), "train": {"lr": 0.1}}))
    args = serve_cli.parse_args(["--run_path", str(run), "--device", "cpu"])
    got, got_cfg = serve_cli._load(args)
    assert got_cfg == cfg
    assert torch.equal(got["fc1"]["w"], params["fc1"]["w"])
    # flags instead of a run directory
    args = serve_cli.parse_args([
        "--checkpoint", str(run / "best.npz"), "--device", "cpu", "--width",
        "8", "--kernel_width", "16", "--depth", "1", "--window_size", "4",
        "--num_residues", "10", "--max_edges", "128", "--compute_dtype",
        "float32", "--predict_delta"])
    got, got_cfg = serve_cli._load(args)
    assert got_cfg == cfg
    assert torch.equal(got["emb"], params["emb"])
    (run / "best.npz").unlink()
    with pytest.raises(SystemExit, match="does not exist"):
        serve_cli._load(serve_cli.parse_args(
            ["--run_path", str(run), "--device", "cpu"]))
    # no checkpoint: seeded random weights
    got, _ = serve_cli._load(serve_cli.parse_args(["--device", "cpu"]))
    assert got["fc1"]["w"].shape == (7, 64)
    persistent = serve_cli.parse_args(["--impl", "persistent", "--device",
                                       "cpu"])
    with pytest.raises(SystemExit, match="--aa_npy"):
        serve_cli.serve(params, cfg, persistent)


def test_cli_flags_match_the_jax_cli():
    from molecular_dynamics_neural_operator_tpu.cli import serve as jax_cli

    ours = vars(serve_cli.parse_args([]))
    theirs = vars(jax_cli.parse_args([]))
    assert ours.pop("device") is None
    assert ours == theirs


def test_cli_refuses_data_mesh_before_reading_the_checkpoint(tmp_path,
                                                             capsys):
    """``--data_mesh`` is served now (tests/test_torch_port_parallel.py):
    in one process, as on one JAX device, it changes nothing and the CLI
    goes on to read the checkpoint."""
    missing = tmp_path / "nowhere.npz"
    with pytest.raises(FileNotFoundError, match="nowhere.npz"):
        serve_cli.main(["--checkpoint", str(missing), "--data_mesh", "2",
                        "--device", "cpu"])
    # 0 (the default) is the JAX CLI's single-device server
    assert serve_cli.parse_args(["--data_mesh", "0"]).data_mesh == 0
    args = serve_cli.parse_args(["--compilation_cache", str(tmp_path)])
    assert args.compilation_cache == tmp_path
