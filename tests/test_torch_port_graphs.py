"""The port's step loops as CUDA graphs (ops/cuda/graphs.py,
train/graphed.py): the kernel rollout, the scan rollout on the sparse
and the dense graph, the server's segments, the serving bundle and the
train steps against the same loops issued op by op.

The tests marked ``gpu`` capture and replay graphs on the card and skip
without one (a CUDA graph has no CPU mode); ``python3 chip_smoke.py``
runs the same comparisons at the bench shapes. The others hold, on the
CPU, what the graphs rely on: the functional update, the rollout
functions' cache, and the steps' eager form.
"""

import dataclasses

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    FNOConfig,
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models import fno, gkn_init
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    graphs,
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    ScanGraphs,
)
from molecular_dynamics_neural_operator_tpu_torch.serving import (
    RolloutServer,
)
from molecular_dynamics_neural_operator_tpu_torch.serving.export import (
    load_bundle,
    save_bundle,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    apply_update,
    create_train_state,
    make_curriculum_train_step,
    make_train_step,
)
from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
    copy_state,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    opt_state_leaves,
    tree_leaves,
    tree_map,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

SMALL = dict(width=16, ker_width=64, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", predict_delta=True)
TRAIN = dict(lr=1e-3, batch_size=4, grad_clip_norm=1.0,
             skip_nonfinite_updates=True)
# graphed against eager train steps: the same kernels on the same inputs;
# the training limits of chip_smoke.py in case a library picks another
# algorithm under capture
TOL_LOSS, TOL_MOVE = 2e-2, 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _traj():
    return synthetic_trajectory(num_frames=64, num_residues=12, seed=4)


def _windows(streams, device):
    traj = _traj()
    return torch.as_tensor(np.stack([traj.positions[6 * i:6 * i + 4]
                                     for i in range(streams)]),
                           device=device)


def _leaves(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [x for v in out.values() for x in _leaves(v)]
    return [x for v in out for x in _leaves(v)]


def _same(a, b) -> bool:
    """Two rollouts' results (tensors in tuples and dicts) equal to the
    bit."""
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _train_setup(device, **cfg_kw):
    cfg = ModelConfig(**{**SMALL, **cfg_kw})
    ds = WindowDataset(_traj(), window_size=4, graph_mode=cfg.graph_mode,
                       max_edges=128)
    state, tx, _ = create_train_state(0, cfg, TrainConfig(**TRAIN),
                                      device=device)
    return cfg, ds, state, tx


def _state_tensors(state):
    return tree_leaves(state.params) + opt_state_leaves(state.opt_state)


def test_apply_update_donates_only_when_asked():
    """Nothing donates on the eager path: a step and ``apply_update``
    leave the state they are given as it was and return tensors of their
    own, which a graphed step copies into its static state."""
    cfg, ds, state, tx = _train_setup("cpu")
    batch = to_device(ds.get_batch(np.arange(4)), "cpu")
    step = make_train_step(cfg, tx)
    before = [t.clone() for t in _state_tensors(state)]
    kept, _ = step(state, batch)
    for a, b in zip(_state_tensors(state), before):
        assert torch.equal(a, b)
    assert all(a is not b for a, b in zip(_state_tensors(kept),
                                          _state_tensors(state)))
    grads = tree_map(torch.ones_like, state.params)
    new = apply_update(state, grads, tx)
    for a, b in zip(_state_tensors(state), before):
        assert torch.equal(a, b)
    copied = copy_state(new)
    assert all(a is not b for a, b in zip(_state_tensors(copied),
                                          _state_tensors(new)))
    for a, b in zip(_state_tensors(copied), _state_tensors(new)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    assert new.step == copied.step == state.step + 1


def test_keep_last_rebuilds_when_the_key_changes():
    kept, made = graphs.KeepLast(), []

    def make():
        made.append(object())
        return made[-1]

    t = torch.zeros(3)
    a = kept.get(graphs.tree_identity({"t": t}), t, make)
    assert kept.get(graphs.tree_identity({"t": t}), t, make) is a
    t.add_(1)
    b = kept.get(graphs.tree_identity({"t": t}), t, make)
    assert b is not a and len(made) == 2
    # outside a capture nothing is made once for it
    assert graphs.per_capture("k", make) is None and len(made) == 2


def test_steps_on_the_cpu_are_their_eager_form():
    cfg, ds, state, tx = _train_setup("cpu")
    teacher = to_device(ds.get_batch(np.arange(4)), "cpu")
    k2 = to_device(ds.get_batch(np.arange(4), rollout_horizon=2), "cpu")
    for step, batch in ((make_train_step(cfg, tx, noise_std=0.1), teacher),
                        (make_curriculum_train_step(cfg, tx, 2), k2)):
        a, ma = step(state, batch)
        b, mb = step.eager(state, batch)
        assert torch.equal(ma["rel_l2"], mb["rel_l2"])
        for x, y in zip(_state_tensors(a), _state_tensors(b)):
            assert torch.equal(x, y)


def test_configurations_that_stay_eager():
    """Only the cell list's loops stay op by op; the dense graph's replay
    graphs as the sparse graph's do."""
    assert not graphs.stays_eager(ModelConfig(**{**SMALL,
                                                 "graph_mode": "dense"}))
    assert graphs.stays_eager(ModelConfig(**{**SMALL,
                                             "neighbor_impl": "cell_list"}))
    assert not graphs.stays_eager(ModelConfig(**SMALL))
    assert not graphs.stays_eager(ModelConfig(**{**SMALL,
                                                 "conv_impl": "pallas"}))


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("streams", [1, 8])
def test_graphed_kernel_rollout_is_the_eager_loop_to_the_bit(cuda, cd,
                                                             streams):
    """100 steps (a block of 64 and a tail of 36), twice: bit-equal to
    the eager step loop, with the same launches a step."""
    cfg = ModelConfig(**SMALL, compute_dtype=cd)
    params = gkn_init(cfg, seed=0, device=cuda)
    prepared = pr.PreparedRollout(params, cfg, _traj().aminoacids,
                                  clip=100.0, device=cuda)
    w0 = _windows(streams, cuda)
    pr.reset_launch_counts()
    want = prepared.eager(w0, 100)
    eager_counts = pr.launch_counts()
    for _ in range(2):
        pr.reset_launch_counts()
        got = prepared(w0, 100)
        assert pr.launch_counts() == eager_counts
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2]["edge_overflow"],
                           want[2]["edge_overflow"])
    assert eager_counts == {"graph_encode": 100, "edge_mlp": 300,
                            "conv_head": 100, "conv_head_wide": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [1, 8])
def test_graphed_kernel_rollout_carries_the_wide_launches(cuda, streams):
    """At width 64 in bf16 conv_head takes the wide plan at one stream
    and the narrow one at 8 (an H100 holds fewer than 8 of its 16-block
    clusters); a replay adds the wide launches its capture made, and the
    graphs stay bit-equal to the eager loop."""
    cfg = ModelConfig(**{**SMALL, "width": 64}, compute_dtype="bfloat16")
    params = gkn_init(cfg, seed=0, device=cuda)
    prepared = pr.PreparedRollout(params, cfg, _traj().aminoacids,
                                  clip=100.0, device=cuda)
    w0 = _windows(streams, cuda)
    pr.reset_launch_counts()
    want = prepared.eager(w0, 100)
    eager_counts = pr.launch_counts()
    for _ in range(2):
        pr.reset_launch_counts()
        got = prepared(w0, 100)
        assert pr.launch_counts() == eager_counts
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert eager_counts == {"graph_encode": 100, "edge_mlp": 300,
                            "conv_head": 100,
                            "conv_head_wide": 100 if streams == 1 else 0}


@pytest.mark.gpu
@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_graphed_scan_rollout_is_the_eager_loop_to_the_bit(cuda, conv_impl):
    cfg = ModelConfig(**SMALL, conv_impl=conv_impl)
    params = gkn_init(cfg, seed=0, device=cuda)
    fn = make_rollout_fn(cfg, 70, batched=True, clip=100.0,
                         collect="both", device=cuda)
    aa = torch.as_tensor(_traj().aminoacids, device=cuda)
    w0 = _windows(4, cuda)
    want = fn.eager(params, aa, w0)
    for _ in range(2):
        got = fn(params, aa, w0)
        for a, b in zip((*got[0], got[1], got[2]["edge_overflow"]),
                        (*want[0], want[1], want[2]["edge_overflow"])):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("streams", [1, 8])
def test_graphed_dense_rollout_is_the_eager_loop_to_the_bit(cuda, cd,
                                                            streams):
    """The dense graph's scan, 100 steps (a block and a tail) collecting
    both outputs, twice: bit-equal to the loop issued op by op; eight
    streams in chunks of four. Each graphed call counts the kernel tensors
    made by the hand-written edge MLP (``fused_edge_mlp``, none in f32)
    that the eager loop counts: the capture holds its counts and every
    replay adds them."""
    cfg = ModelConfig(**{**SMALL, "graph_mode": "dense"}, compute_dtype=cd)
    params = gkn_init(cfg, seed=0, device=cuda)
    batched = streams > 1
    fn = make_rollout_fn(cfg, 100, batched=batched, clip=100.0,
                         collect="both", stream_chunk=4 if batched else None,
                         device=cuda)
    aa = torch.as_tensor(_traj().aminoacids, device=cuda)
    w0 = _windows(streams, cuda) if batched else _windows(1, cuda)[0]

    def hand_mlp():
        return profiling.counters().get("fused_edge_mlp", 0)

    before = hand_mlp()
    want = fn.eager(params, aa, w0)
    eager = hand_mlp() - before
    assert (eager > 0) == (cd == "bfloat16")
    for _ in range(2):
        before = hand_mlp()
        assert _same(fn(params, aa, w0), want)
        assert hand_mlp() - before == eager


@pytest.mark.gpu
def test_graphed_scan_from_a_window_of_another_layout(cuda):
    """A window laid out otherwise than a step's result (the FNO's
    distance channels are such a carry): the loop's first block reads it
    as given, the later blocks a step's result, as the eager loop does;
    bit-equal over a block and a tail."""
    cfg = ModelConfig(**{**SMALL, "graph_mode": "dense"})
    params = gkn_init(cfg, seed=0, device=cuda)
    fn = make_rollout_fn(cfg, 70, batched=True, clip=100.0, device=cuda)
    aa = torch.as_tensor(_traj().aminoacids, device=cuda)
    w0 = _windows(4, cuda).transpose(-1, -2).contiguous().transpose(-1, -2)
    assert not w0.is_contiguous()
    want = fn.eager(params, aa, w0)
    for _ in range(2):
        assert _same(fn(params, aa, w0), want)


@pytest.mark.gpu
@pytest.mark.parametrize("operator", ["gkn", "gkn-dense", "fno"])
def test_graphed_bundle_is_its_eager_loop_to_the_bit(cuda, tmp_path,
                                                     operator):
    """A bundle's graphs against its step loop issued from Python, 70
    steps (a block and a tail), twice, then with hot-swapped weights and
    with its own again: every result bit-equal, the swapped one
    different."""
    traj = _traj()
    if operator == "fno":
        cfg = FNOConfig(num_residues=12, in_channels=4, width=8, modes1=4,
                        modes2=4, depth=2, predict_delta=True)
        params = fno.fno_init(cfg, seed=0, device=cuda)
        other = fno.fno_init(cfg, seed=1, device=cuda)
        args = (fno.distance_matrix_channels(
            torch.as_tensor(traj.positions[:4], device=cuda)),)
        kw = {}
    else:
        mode = "dense" if operator == "gkn-dense" else "sparse"
        cfg = ModelConfig(**{**SMALL, "graph_mode": mode})
        params = gkn_init(cfg, seed=0, device=cuda)
        other = gkn_init(cfg, seed=1, device=cuda)
        args = (torch.as_tensor(traj.aminoacids, device=cuda),
                _windows(4, cuda))
        kw = dict(streams=4, stream_chunk=2, collect="both", clip=100.0)
    bundle = load_bundle(save_bundle(tmp_path / operator, params, cfg, 70,
                                     **kw), device=cuda)
    want = bundle.eager(*args)
    swapped = bundle.eager(*args, params=other)
    assert not _same(swapped, want)
    for _ in range(2):
        assert _same(bundle(*args), want)
    assert _same(bundle(*args, params=other), swapped)
    assert _same(bundle(*args), want)


@pytest.mark.gpu
def test_a_bundle_called_from_two_threads_serves_each_its_weights(
        cuda, tmp_path):
    """Two threads call one bundle at once, five times each, with
    different weights (one on a stream of its own): every result is its
    own checkpoint's eager rollout to the bit."""
    import threading

    cfg = ModelConfig(**SMALL)
    weights = [gkn_init(cfg, seed=s, device=cuda) for s in (0, 1)]
    bundle = load_bundle(save_bundle(tmp_path / "b", weights[0], cfg, 70,
                                     streams=4, collect="both", clip=100.0),
                         device=cuda)
    aa = torch.as_tensor(_traj().aminoacids, device=cuda)
    w0 = _windows(4, cuda)
    wants = [bundle.eager(aa, w0, params=p) for p in weights]
    assert not _same(wants[0], wants[1])
    start, results = threading.Barrier(2), [[], []]
    torch.cuda.synchronize()

    def serve(i):
        with torch.cuda.stream(torch.cuda.Stream() if i else
                               torch.cuda.current_stream()):
            start.wait()
            for _ in range(5):
                results[i].append(bundle(aa, w0, params=weights[i]))
            torch.cuda.current_stream().synchronize()

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for want, got in zip(wants, results):
        assert len(got) == 5 and all(_same(g, want) for g in got)


@pytest.mark.gpu
def test_a_served_request_after_the_graph_buffers_were_reused(cuda):
    """A request that spans three segments, served beside others that
    come and go, equals its dedicated rollout to the bit although every
    segment replays over the same static buffers."""
    cfg = ModelConfig(**SMALL, compute_dtype="bfloat16")
    params = gkn_init(cfg, seed=0, device=cuda)
    traj = _traj()
    aa = traj.aminoacids
    w = [traj.positions[6 * i:6 * i + 4] for i in range(5)]
    dedicated = pr.PreparedRollout(params, cfg, aa, clip=100.0, device=cuda)
    with RolloutServer(params, cfg, segment_steps=8, max_streams=4,
                       impl="persistent", aa=aa, clip=100.0,
                       device=cuda) as server:
        server.warmup()
        futures = [server.submit(aa, w[0], 20)]
        futures += server.submit_many([(aa, w[i], 5 + 4 * i)
                                       for i in range(1, 5)])
        results = [f.result(timeout=600) for f in futures]
    for res, wi, n in zip(results, w, [20, 9, 13, 17, 21]):
        coords, final, _ = dedicated(torch.as_tensor(wi, device=cuda), n)
        assert np.array_equal(res.coords, coords.cpu().numpy())
        assert np.array_equal(res.final_window, final.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["pallas", "xla", "dense"])
def test_graphed_teacher_steps_agree_with_the_eager_steps(cuda, impl):
    """Four steps with noise, the third on a batch with a NaN: the graphed
    state within the training limits of the eager one, and over the NaN
    batch the graphed parameters, moments and apply count bit-unchanged
    with the skip counted. "dense" is the dense graph's step."""
    opts = dict(graph_mode="dense") if impl == "dense" \
        else dict(train_conv_impl=impl)
    cfg, ds, state0, tx = _train_setup(cuda, **opts)
    step = make_train_step(cfg, tx, noise_std=0.05)
    batches = [to_device(ds.get_batch(np.arange(4) + 4 * i), cuda)
               for i in range(4)]
    batches[2]["window"][1, 0, 3, 0] = float("nan")
    eager, graphed = state0, state0
    for i, batch in enumerate(batches):
        before = [t.clone() for t in _state_tensors(graphed)]
        eager, me = step.eager(eager, batch)
        graphed, mg = step(graphed, batch)
        if i == 2:
            assert not bool(graphed.opt_state.last_finite)
            assert int(graphed.opt_state.total_notfinite) == 1
            n_params = len(tree_leaves(graphed.params))
            skipped = _state_tensors(graphed)
            for a, b in zip(skipped[:n_params] + skipped[n_params + 6:],
                            before[:n_params] + before[n_params + 6:]):
                assert torch.equal(a, b)
            assert int(graphed.opt_state.count) == 2
            continue
        assert abs(float(mg["rel_l2"]) - float(me["rel_l2"])) <= \
            TOL_LOSS * abs(float(me["rel_l2"]))
    assert graphed.step == eager.step == 4
    assert int(graphed.opt_state.count) == int(eager.opt_state.count) == 3
    for a, b, p0 in zip(tree_leaves(graphed.params),
                        tree_leaves(eager.params),
                        tree_leaves(state0.params)):
        move = float((b - p0).norm())
        assert float((a - b).norm()) <= TOL_MOVE * max(move, 1e-12)


@pytest.mark.gpu
def test_rollouts_kept_across_graphed_steps_use_the_new_parameters(cuda):
    """A graphed step writes its state by replay. A kernel rollout and a
    fused scan rollout kept across such steps, and scan graphs whose
    parameters change in place, roll out the parameters as they are now:
    each equal to the eager rollout of a fresh copy of them."""
    cfg, ds, state, tx = _train_setup(cuda)
    step = make_train_step(cfg, tx)
    aa = torch.as_tensor(_traj().aminoacids, device=cuda)
    w0 = _windows(2, cuda)
    fused = dataclasses.replace(cfg, conv_impl="pallas")
    kernel_fn = pr.make_persistent_rollout_fn(cfg, 20, clip=100.0,
                                              device=cuda)
    scan_fn = make_rollout_fn(fused, 20, batched=True, clip=100.0,
                              device=cuda)
    for epoch in range(2):
        for i in range(2):
            state, _ = step(state, to_device(
                ds.get_batch(np.arange(4) + 4 * (i + 2 * epoch)), cuda))
        fresh = tree_map(torch.clone, state.params)
        want = pr.PreparedRollout(fresh, cfg, aa, clip=100.0,
                                  device=cuda).eager(w0, 20)
        assert torch.equal(kernel_fn(state.params, aa, w0)[0], want[0])
        assert torch.equal(scan_fn(state.params, aa, w0)[0],
                           scan_fn.eager(fresh, aa, w0)[0])
    params = tree_map(torch.clone, state.params)
    kept = ScanGraphs(params, fused, clip=100.0)
    kept(aa, w0, 20)
    torch._foreach_mul_(tree_leaves(params), 1.01)
    assert torch.equal(kept(aa, w0, 20)[0],
                       scan_fn.eager(tree_map(torch.clone, params), aa,
                                     w0)[0])
