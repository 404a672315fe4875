"""The port's CUDA kernel wrappers (ops/cuda/persistent_rollout.py,
ops/cuda/train_conv.py and ops/cuda/fused_gkn.py).

On the CPU a wrapper runs its kernel's plain version; those tests run
everywhere. The tests marked ``gpu`` launch the kernels and hold each
against its plain version on the card; they skip without a CUDA card
(CUDA kernels have no CPU mode). ``python3 chip_smoke.py`` runs the same
comparisons at the bench shapes.
"""

import contextlib

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    edge_features_from_edges,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    residual_prior,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    fused_gkn as fg,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    edge_mlp as em,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    train_conv as tc,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    sparse_inv_degree,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    curriculum,
    loop,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    tree_leaves,
    tree_map,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

# ker_width 64 and width 16 keep every edge-MLP output a multiple of 64
SMALL = dict(width=16, ker_width=64, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", predict_delta=True,
             predict_prior="extrapolate", prior_damping=0.5)


def _setup(cd="float32", streams=1, device="cpu"):
    cfg = ModelConfig(**SMALL, compute_dtype=cd)
    params = gkn_init(cfg, seed=0, device=device)
    traj = synthetic_trajectory(num_frames=32, num_residues=12, seed=4)
    windows = torch.as_tensor(np.stack(
        [traj.positions[5 * i:5 * i + 4] for i in range(streams)]),
        device=device)
    aa = torch.as_tensor(traj.aminoacids, device=device)
    return cfg, params, aa, windows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    # the plain versions are the oracle: full f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_wrappers_on_cpu_run_the_plain_versions_and_launch_nothing():
    cfg, params, aa, windows = _setup(streams=2)
    pr.reset_launch_counts()
    weights = pr.rollout_weights(params, cfg, aa, "cpu")
    bufs = pr.alloc_buffers(cfg, 2, 12, "cpu")
    pr.graph_encode(windows, weights, 8.0, bufs)
    edges, mask, count, _, inv_deg, ef, x0 = pr.graph_encode_plain(
        windows, weights, 8.0, cfg.max_edges, torch.float32)
    for got, want in ((bufs.edges, edges), (bufs.mask, mask),
                      (bufs.count, count.int()), (bufs.inv_deg, inv_deg),
                      (bufs.ef, ef), (bufs.x0, x0)):
        assert torch.equal(got, want)
    layer = weights["mlp"][0]
    a = ef.reshape(-1, 6)
    out = em.edge_mlp(a, layer["w"], layer["b"], True)
    assert torch.equal(out, em.edge_mlp_plain(a, layer["w"], layer["b"],
                                              True))
    assert pr.launch_counts() == {"graph_encode": 0, "edge_mlp": 0,
                                  "conv_head": 0, "conv_head_wide": 0}


@pytest.mark.parametrize("streams,wide,plan", [
    (1, 7, "wide"), (2, 7, "wide"), (4, 7, "wide"), (7, 7, "wide"),
    (8, 7, "narrow"), (32, 7, "narrow"), (1, 0, "narrow"), (8, 8, "wide")])
def test_conv_head_goes_wide_while_the_card_holds_every_streams_cluster(
        streams, wide, plan):
    """A 16-block cluster a stream only while all of them run at once:
    one more stream would wait for a second wave, which 8-block clusters
    (15 at once on an H100) never need at 8 streams."""
    assert pr.conv_head_plan(streams, wide) == plan


def test_wide_clusters_asks_each_card_once_a_shape(monkeypatch):
    """The card is asked once per shape and device, on that device; the
    count it gives is all the wrapper knows of which shapes have a wide
    plan (0 for the CUDA-core body: f32, or bf16 at another width), so
    those stay narrow."""
    asked, current = [], []

    @contextlib.contextmanager
    def on(device):
        current.append(device)
        yield
        current.pop()

    def clusters(r, w, e, cd, wide=False):
        asked.append((r, w, e, cd, wide, current[-1]))
        return 7 if (cd, w) == (torch.bfloat16, 64) else 0

    monkeypatch.setattr(pr.torch.cuda, "device", on)
    monkeypatch.setattr(pr, "conv_head_clusters", clusters)
    monkeypatch.setattr(pr, "_wide_clusters", {})
    card, other = torch.device("cuda", 0), torch.device("cuda", 1)
    for _ in range(2):
        assert pr.wide_clusters(28, 64, 224, torch.bfloat16, card) == 7
    assert asked == [(28, 64, 224, torch.bfloat16, True, card)]
    assert pr.wide_clusters(28, 64, 256, torch.bfloat16, card) == 7
    assert pr.wide_clusters(28, 64, 224, torch.bfloat16, other) == 7
    assert asked[-1][-1] == other and len(asked) == 3
    for cd, w in ((torch.float32, 64), (torch.bfloat16, 16),
                  (torch.bfloat16, 128)):
        for _ in range(2):
            assert pr.wide_clusters(28, w, 224, cd, card) == 0
        assert pr.conv_head_plan(1, pr.wide_clusters(28, w, 224, cd,
                                                     card)) == "narrow"
    assert len(asked) == 6


def test_edge_mlp_plain_masks_rows_and_keeps_dtype():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(8, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, generator=g)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
    out = em.edge_mlp_plain(a, w, b, False, mask)
    assert out.dtype == torch.bfloat16
    assert not out[1].any() and not out[3].any()
    want = (a.float() @ w.float() + b).to(torch.bfloat16)
    assert torch.equal(out[0], want[0])


def test_operand_checks_raise():
    t = torch.zeros(4, 3)
    dev = t.device
    with pytest.raises(ValueError, match="dtype"):
        pr._check(t, "t", torch.bfloat16, (4, 3), dev)
    with pytest.raises(ValueError, match="shape"):
        pr._check(t, "t", torch.float32, (3, 4), dev)
    with pytest.raises(ValueError, match="contiguous"):
        pr._check(t.t(), "t", torch.float32, (3, 4), dev)
    with pytest.raises(ValueError, match="no kernel"):
        pr._on_cpu(torch.empty(2, device="meta"))


@pytest.mark.parametrize("k,which", [(64, "a"), (64, "w"), (64, "out"),
                                     (6, "w"), (6, "out")])
def test_misaligned_bf16_operands_of_the_edge_mlp_raise(k, which):
    """A bf16 layer's kernel is fixed by K; an operand view that does not
    start on a 16-byte boundary raises and is handed to no other kernel."""
    bf16 = torch.bfloat16
    ops = {"a": torch.zeros(8 * k + 8, dtype=bf16),
           "w": torch.zeros(k * 64 + 8, dtype=bf16),
           "out": torch.zeros(8 * 64 + 8, dtype=bf16)}
    shapes = {"a": (8, k), "w": (k, 64), "out": (8, 64)}

    def views(shifted):
        return [ops[n][(1 if n == shifted else 0):][:np.prod(shapes[n])]
                .view(shapes[n]) for n in ("a", "w", "out")]

    em._check_mlp_alignment(*views(None), k, "edge_mlp")
    with pytest.raises(ValueError, match=f"{which} must start on a 16-byte"):
        em._check_mlp_alignment(*views(which), k, "edge_mlp")


def test_alignment_rule_leaves_the_fma_layers_alone():
    """f32 layers, bf16 layers with another K, and the 6-wide layer's input
    (12-byte rows, read by element) carry no alignment rule."""
    for cd, k in ((torch.float32, 64), (torch.bfloat16, 40),
                  (torch.bfloat16, 6)):
        a = torch.zeros(8 * k + 8, dtype=cd)[1:][:8 * k].view(8, k)
        w = torch.zeros(k * 64 + 8, dtype=cd)
        out = torch.zeros(8 * 64 + 8, dtype=cd)
        shift = 0 if (cd, k) == (torch.bfloat16, 6) else 1
        em._check_mlp_alignment(a, w[shift:][:k * 64].view(k, 64),
                                out[shift:][:8 * 64].view(8, 64), k, "edge_mlp")


def _mlp_operands(seed, cd, m, kw, n, device="cpu"):
    """Seeded operands of the edge-kernel MLP, made with numpy: ef (m, 6),
    three layers 6 -> kw -> kw -> n, a row mask with holes."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).to(dtype)

    ef = t(rng.normal(size=(m, 6)) * 4.0, cd)
    mlp = [{"w": t(rng.normal(size=(k, o)) / np.sqrt(k), cd),
            "b": t(rng.normal(size=o))}
           for k, o in ((6, kw), (kw, kw), (kw, n))]
    row_mask = t(rng.random(m) > 0.25)
    return ef, mlp, row_mask


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,kw,n", [(5, 64, 64), (224, 64, 256),
                                    (130, 128, 192)])
def test_edge_mlp_stack_on_cpu_equals_the_three_call_form_to_the_bit(
        cd, m, kw, n):
    ef, mlp, row_mask = _mlp_operands(3, cd, m, kw, n)
    h1 = torch.full((m, kw), 7.0, dtype=cd)
    h2, out = torch.empty(m, kw, dtype=cd), torch.empty(m, n, dtype=cd)
    pr.reset_launch_counts()
    got = em.edge_mlp_stack(ef, mlp, row_mask, h1, h2, out)
    a = em.edge_mlp(ef, mlp[0]["w"], mlp[0]["b"], True)
    b = em.edge_mlp(a, mlp[1]["w"], mlp[1]["b"], True)
    want = em.edge_mlp(b, mlp[2]["w"], mlp[2]["b"], False, row_mask)
    assert got is out and got.dtype == cd
    assert torch.equal(h1, a) and torch.equal(h2, b)
    assert torch.equal(got, want)
    assert not got[row_mask == 0].any()
    assert pr.launch_counts()["edge_mlp"] == 0


def test_edge_mlp_stack_is_what_a_step_runs_on_cpu():
    cfg, params, aa, windows = _setup(streams=2)
    weights = pr.rollout_weights(params, cfg, aa, "cpu")
    bufs = pr.alloc_buffers(cfg, 2, 12, "cpu")
    win, coords = windows.clone(), torch.empty(2, 12, 3)
    pr.step(bufs, weights, cfg, 8.0, 100.0, win, coords)
    a = bufs.ef.view(-1, 6)
    for i, layer in enumerate(weights["mlp"]):
        a = em.edge_mlp_plain(a, layer["w"], layer["b"], i < 2,
                              bufs.mask.view(-1) if i == 2 else None)
    assert torch.equal(bufs.kmat, a)
    assert torch.equal(win[:, -1], coords)
    assert torch.equal(win[:, :-1], windows[:, 1:])


def _stress_graphs(seed, s, r, e, real, hub_degree, device):
    """Edge lists (name, edges (s, 2, e) int32, mask (s, e)), made with
    numpy, that stress how the conv stack deals edges to blocks: a hub
    (node 3) whose in-degree exceeds the messages a block holds at a time
    beside a node (5) without incoming edges, real edges in random slots;
    and every slot taken."""
    rng = np.random.default_rng(seed)
    edges = np.zeros((s, 2, e), np.int32)
    mask = np.zeros((s, e), np.float32)
    others = [j for j in range(r) if j not in (3, 5)]
    for i in range(s):
        slots = rng.permutation(e)[:real]
        dst = rng.choice(others, real)
        dst[:hub_degree] = 3
        edges[i, 0, slots] = rng.integers(0, r, real)
        edges[i, 1, slots] = dst
        mask[i, slots] = 1.0
    full = rng.integers(0, r, (s, 2, e)).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=device)

    return [("hub", t(edges), t(mask)),
            ("full", t(full), t(np.ones((s, e), np.float32)))]


def test_stress_graphs_are_what_they_say():
    (_, edges, mask), (_, full, full_mask) = _stress_graphs(
        11, 3, 12, 128, 90, 60, "cpu")
    for i in range(3):
        dst = edges[i, 1][mask[i] > 0]
        assert int((dst == 3).sum()) == 60 and not bool((dst == 5).any())
        assert int(mask[i].sum()) == 90
    inv = sparse_inv_degree(edges, mask, 12)
    assert torch.equal(inv[:, 3], torch.full((3,), 1 / 60))
    assert torch.equal(inv[:, 5], torch.ones(3))    # no edge: degree floor 1
    assert bool((full_mask == 1).all())
    # padded slots name node 0 and count toward no degree
    pads = int((mask[0] == 0).sum())
    assert pads == 38 and not edges[0][:, mask[0] == 0].any()
    assert inv[0, 0] == 1 / max(1, int(((edges[0, 1] == 0) & (mask[0] > 0)).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("streams", [1, 3])
def test_kernels_match_plain_versions_on_the_card(cuda, cd, streams):
    cfg, params, aa, windows = _setup(cd, streams, cuda)
    weights = pr.rollout_weights(params, cfg, aa, cuda)
    bufs = pr.alloc_buffers(cfg, streams, 12, cuda)
    pr.graph_encode(windows, weights, 8.0, bufs)
    edges, mask, count, over, inv_deg, ef, x0 = pr.graph_encode_plain(
        windows, weights, 8.0, cfg.max_edges, bufs.ef.dtype)
    torch.cuda.synchronize()
    # integer work and copied coordinates: exact
    for got, want in ((bufs.edges, edges), (bufs.mask, mask),
                      (bufs.count.long(), count), (bufs.inv_deg, inv_deg),
                      (bufs.ef, ef)):
        assert torch.equal(got, want)
    assert bool(bufs.overflow[0]) == bool(over.any())
    # LSTM transcendentals and f32 sums in another order
    torch.testing.assert_close(bufs.x0, x0, rtol=1e-5, atol=1e-5)

    a = ef.reshape(-1, 6)
    for i, layer in enumerate(weights["mlp"]):
        rm = mask.reshape(-1) if i == 2 else None
        got = em.edge_mlp(a, layer["w"], layer["b"], i < 2, rm)
        want = em.edge_mlp_plain(a, layer["w"], layer["b"], i < 2, rm)
        # f32: ulp-level order differences; bf16: one flipped rounding
        # of the output, 2^-8 relative
        tol = 1e-5 if cd == "float32" else 2.0 ** -7
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale
        a = want

    # the step's entry: one call, three launches, the same function
    pr.reset_launch_counts()
    em.edge_mlp_stack(ef.reshape(-1, 6), weights["mlp"], mask.reshape(-1),
                      bufs.h1, bufs.h2, bufs.kmat)
    torch.cuda.synchronize()
    assert pr.launch_counts()["edge_mlp"] == 3
    scale = max(1.0, a.float().abs().max().item())
    assert (bufs.kmat.float() - a.float()).abs().max().item() <= 3 * tol * scale

    graphs = [("contacts", edges, mask)] + _stress_graphs(
        5, streams, 12, cfg.max_edges, 90, 60, cuda)
    for name, g_edges, g_mask in graphs:
        g_inv = sparse_inv_degree(g_edges, g_mask, 12)
        kmat = a if name == "contacts" else a * g_mask.reshape(-1, 1).to(a.dtype)
        for dst, src in ((bufs.edges, g_edges), (bufs.mask, g_mask),
                         (bufs.inv_deg, g_inv), (bufs.x0, x0),
                         (bufs.kmat, kmat)):
            dst.copy_(src)
        win_k, win_p = windows.clone(), windows.clone()
        coords = torch.empty(streams, 12, 3, device=cuda)
        pr.conv_head(bufs, weights, cfg, 100.0, win_k, coords)
        want = pr.conv_head_plain(x0, kmat, g_edges, g_mask, g_inv, weights,
                                  cfg, 100.0, win_p)
        torch.cuda.synchronize()
        # held on the head's own output, the coordinates minus the prior:
        # f32 ulp-level sums; bf16 a message rounding flipped by one unit
        # (2^-8 relative), averaged over edges and layers. The output is
        # rounded into f32 coordinates after the prior is added: 2 ulps on
        # top.
        head_out = (want - residual_prior(cfg, windows)).abs().max().item()
        ulp = torch.finfo(torch.float32).eps * want.abs().max().item()
        tol_head = (1e-4 if cd == "float32" else 1e-2) * head_out + 2 * ulp
        assert tol_head < 0.1 * head_out, name
        assert (coords - want).abs().max().item() <= tol_head, name
        assert torch.equal(win_k[:, :-1], win_p[:, :-1]), name
    # 12 nodes over 8 blocks of 512 threads: the card holds two a GPC at least
    assert pr.conv_head_clusters(12, cfg.width, cfg.max_edges,
                                 bufs.kmat.dtype) >= 1
    # the wide plan at the flagship's shapes: 16 blocks of 256 threads
    assert pr.conv_head_clusters(28, 64, 224, torch.bfloat16, wide=True) >= 1
    # width 16 runs the CUDA-core body, which has no wide plan
    assert pr.conv_head_clusters(12, cfg.width, cfg.max_edges,
                                 bufs.kmat.dtype, wide=True) == 0


def _conv_head_steps(shape, streams, device):
    """One step's conv_head inputs in bf16 at width 64 (the tensor-core
    body, the only one with a wide plan) from seeded weights (every layer
    alive): (cfg, weights, windows, [(name, edges, mask, inv_deg, x0,
    kmat)]) for the contacts graph of seeded windows and _stress_graphs's
    (a hub of in-degree 60, one of in-degree R - 1, every slot taken), K
    from the plain edge MLP on each graph's edge features."""
    if shape == "flagship":    # chip_smoke.py::bench_cfg: 28 residues
        cfg = ModelConfig(compute_dtype="bfloat16", graph_mode="sparse",
                          max_edges=224, predict_delta=True)
        r, real = 28, 200
    else:
        cfg = ModelConfig(**{**SMALL, "width": 64},
                          compute_dtype="bfloat16")
        r, real = 12, 90
    e, t = cfg.max_edges, cfg.window_size
    params = gkn_init(cfg, seed=0, device=device)
    traj = synthetic_trajectory(num_frames=400, num_residues=r, seed=4)
    windows = torch.as_tensor(np.stack(
        [traj.positions[50 * i:50 * i + t] for i in range(streams)]),
        device=device)
    weights = pr.rollout_weights(
        params, cfg, torch.as_tensor(traj.aminoacids, device=device), device)
    edges, mask, _, _, inv_deg, _, x0 = pr.graph_encode_plain(
        windows, weights, 8.0, e, torch.bfloat16)
    graphs = ([("contacts", edges, mask)]
              + _stress_graphs(5, streams, r, e, real, 60, device)
              + _stress_graphs(6, streams, r, e, real, r - 1, device)[:1])
    steps = []
    for name, g_edges, g_mask in graphs:
        a = edge_features_from_edges(windows[:, -1], g_edges).to(
            torch.bfloat16).reshape(streams * e, 6)
        for i, layer in enumerate(weights["mlp"]):
            a = em.edge_mlp_plain(a, layer["w"], layer["b"], i < 2,
                                  g_mask.reshape(-1) if i == 2 else None)
        steps.append((name, g_edges, g_mask,
                      sparse_inv_degree(g_edges, g_mask, r), x0, a))
    return cfg, weights, windows, steps


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["small", "flagship"])
@pytest.mark.parametrize("streams", [1, 2, 4])
def test_wide_conv_head_gives_the_narrow_plans_bits_on_the_card(
        cuda, shape, streams, monkeypatch):
    """The wide plan (16 blocks a stream, 16 columns a warp) takes the
    same sums in the same order as the narrow one: the same coordinates
    and the same slid window, to the bit, and both within the plain
    version's tolerance (test_kernels_match_plain_versions_on_the_card's).
    Random weights without the clip: activations grow with every layer."""
    cfg, weights, windows, steps = _conv_head_steps(shape, streams, cuda)
    r = windows.shape[2]
    bufs = pr.alloc_buffers(cfg, streams, r, cuda)
    pr.reset_launch_counts()
    for name, edges, mask, inv_deg, x0, kmat in steps:
        for dst, src in ((bufs.edges, edges), (bufs.mask, mask),
                         (bufs.inv_deg, inv_deg), (bufs.x0, x0),
                         (bufs.kmat, kmat)):
            dst.copy_(src)
        got = {}
        for plan in ("narrow", "wide"):
            # this plan, whatever the rule would pick
            monkeypatch.setattr(pr, "conv_head_plan",
                                lambda s, wide, plan=plan: plan)
            win = windows.clone()
            coords = torch.empty(streams, r, 3, device=cuda)
            pr.conv_head(bufs, weights, cfg, None, win, coords)
            got[plan] = (coords, win)
        win_p = windows.clone()
        want = pr.conv_head_plain(x0, kmat, edges, mask, inv_deg, weights,
                                  cfg, None, win_p)
        torch.cuda.synchronize()
        assert torch.equal(got["wide"][0], got["narrow"][0]), name
        assert torch.equal(got["wide"][1], got["narrow"][1]), name
        head_out = (want - residual_prior(cfg, windows)).abs().max().item()
        ulp = torch.finfo(torch.float32).eps * want.abs().max().item()
        tol_head = 1e-2 * head_out + 2 * ulp
        assert tol_head < 0.1 * head_out, name
        assert (got["narrow"][0] - want).abs().max().item() <= tol_head, name
        assert torch.equal(got["narrow"][1][:, :-1], win_p[:, :-1]), name
    assert pr.launch_counts()["conv_head"] == 2 * len(steps)
    assert pr.launch_counts()["conv_head_wide"] == len(steps)


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [1, 2, 4, 8])
def test_conv_head_picks_its_plan_by_the_streams_on_the_card(cuda, streams):
    """Left to itself conv_head goes wide at 1, 2 and 4 streams at the
    flagship's shapes and stays narrow at 8: an H100 holds fewer than 8
    clusters of 16 blocks (a cluster lies within one GPC)."""
    cfg, weights, windows, steps = _conv_head_steps("flagship", streams,
                                                    cuda)
    wide = pr.wide_clusters(28, 64, 224, torch.bfloat16, cuda)
    assert 4 <= wide < 8
    bufs = pr.alloc_buffers(cfg, streams, 28, cuda)
    _, edges, mask, inv_deg, x0, kmat = steps[0]
    for dst, src in ((bufs.edges, edges), (bufs.mask, mask),
                     (bufs.inv_deg, inv_deg), (bufs.x0, x0),
                     (bufs.kmat, kmat)):
        dst.copy_(src)
    coords = torch.empty(streams, 28, 3, device=cuda)
    pr.reset_launch_counts()
    pr.conv_head(bufs, weights, cfg, None, windows.clone(), coords)
    torch.cuda.synchronize()
    assert pr.launch_counts()["conv_head"] == 1
    assert pr.launch_counts()["conv_head_wide"] == (1 if streams < 8 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [224, 672, 896, 1792, 20000])
def test_edge_mlp_tilings_match_plain_on_the_card(cuda, m):
    """The bench widths at 1, 3, 4 and 8 streams' rows: each row count takes
    another tiling of the tensor-core kernel (672 is no multiple of 128);
    20,000 rows (a ragged last band) take the persistent plan of the
    large-system step, whose rows are the small plans' to the bit."""
    ef, mlp, row_mask = _mlp_operands(9, torch.bfloat16, m, 1024, 4096, cuda)
    h1 = torch.empty(m, 1024, dtype=torch.bfloat16, device=cuda)
    h2, out = torch.empty_like(h1), torch.empty(
        m, 4096, dtype=torch.bfloat16, device=cuda)
    em.edge_mlp_stack(ef, mlp, row_mask, h1, h2, out)
    a = ef
    for i, (layer, got) in enumerate(zip(mlp, (h1, h2, out))):
        rm = row_mask if i == 2 else None
        want = em.edge_mlp_plain(a, layer["w"], layer["b"], i < 2, rm)
        alone = em.edge_mlp(a, layer["w"], layer["b"], i < 2, rm)
        torch.cuda.synchronize()
        scale = max(1.0, want.float().abs().max().item())
        # one flipped bf16 rounding of the output, 2^-8 relative
        assert (alone.float() - want.float()).abs().max().item() <= 2.0 ** -7 * scale
        # the stack ran the same kernels on its own previous layer
        assert (got.float() - want.float()).abs().max().item() <= 3 * 2.0 ** -7 * scale
        a = want
    assert not out[row_mask == 0].any()
    # a stream's rows do not depend on how many streams share the launch
    first = torch.empty(224, 4096, dtype=torch.bfloat16, device=cuda)
    em.edge_mlp_stack(ef[:224].contiguous(), mlp, row_mask[:224].contiguous(),
                      torch.empty_like(h1[:224]), torch.empty_like(h1[:224]),
                      first)
    torch.cuda.synchronize()
    assert torch.equal(first, out[:224])


@pytest.mark.gpu
def test_edge_mlp_raises_on_a_misaligned_view_on_the_card(cuda):
    ef, mlp, row_mask = _mlp_operands(9, torch.bfloat16, 224, 64, 64, cuda)
    h1 = em.edge_mlp(ef, mlp[0]["w"], mlp[0]["b"], True)
    shifted = torch.empty(224 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(224, 64)
    shifted.copy_(h1)
    pr.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        em.edge_mlp(shifted, mlp[1]["w"], mlp[1]["b"], True)
    with pytest.raises(ValueError, match="16-byte"):
        em.edge_mlp(h1, mlp[1]["w"], mlp[1]["b"], True, out=shifted)
    assert pr.launch_counts()["edge_mlp"] == 0


@pytest.mark.gpu
def test_kernel_rollout_matches_plain_rollout_on_the_card(cuda):
    cfg, params, aa, windows = _setup("float32", 1, cuda)
    pr.reset_launch_counts()
    got, final, diags = pr.make_persistent_rollout_fn(cfg, 8, clip=100.0)(
        params, aa, windows[0])
    want, want_final, _ = make_rollout_fn(cfg, 8, clip=100.0)(
        params, aa, windows[0])
    # f32 sums in another order, fed back through the window for 8 steps
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    torch.testing.assert_close(final, want_final, rtol=0, atol=1e-3)
    assert pr.launch_counts() == {"graph_encode": 8, "edge_mlp": 24,
                                  "conv_head": 8, "conv_head_wide": 0}


def _train_conv_operands(seed, cd, device, b=6, r=12, w=16, e=128, real=90,
                         graph=None):
    """Seeded operands of the training conv stack, (x0, kt, edges, mask,
    inv_deg, root1, bias1, root2, bias2, g_out): ``e - real`` padded slots
    (src = dst = 0, kt rows zero) at the end, or the edge list ``graph``
    ((edges, mask) numpy arrays) instead."""
    rng = np.random.default_rng(seed)
    if graph is None:
        mask = np.zeros((b, e), np.float32)
        mask[:, :real] = 1.0
        edges = (rng.integers(0, r, size=(b, 2, e))
                 * mask[:, None, :]).astype(np.int32)
    else:
        edges, mask = graph
    kt = (rng.normal(size=(b, e, w * w)) * 0.3 * mask[..., None])
    bound = 1.0 / np.sqrt(w)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    edges_t = torch.as_tensor(edges, device=device)
    return (t(rng.normal(size=(b, r, w))), t(kt).to(cd), edges_t, t(mask),
            sparse_inv_degree(edges_t, t(mask), r),
            t(rng.uniform(-bound, bound, (w, w))),
            t(rng.uniform(-bound, bound, w)),
            t(rng.uniform(-bound, bound, (w, w))),
            t(rng.uniform(-bound, bound, w)),
            t(rng.normal(size=(b, r, w))))


# x0, kt, root1, bias1, root2, bias2 among train_conv's operands
TRAIN_GRAD_SLOTS = (0, 1, 5, 6, 7, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_train_conv_kernels_match_the_plain_version_on_the_card(cuda, cd):
    *ops, g_out = _train_conv_operands(7, cd, cuda)
    grad_slots = TRAIN_GRAD_SLOTS
    leaves = [t.clone().requires_grad_(i in grad_slots)
              for i, t in enumerate(ops)]
    ref_leaves = [t.clone().requires_grad_(i in grad_slots)
                  for i, t in enumerate(ops)]
    tc.reset_launch_counts()
    out = tc.train_conv(*leaves, 2)
    want = tc.train_conv_plain(*ref_leaves, 2)
    (out * g_out).sum().backward()
    (want * g_out).sum().backward()
    torch.cuda.synchronize()
    assert tc.launch_counts() == {"train_conv_fwd": 1, "train_conv_bwd": 1}
    # f32: sums in another order; bf16: now and then a flipped rounding,
    # 2^-8 of a value, carried through 4 layers
    tol = 1e-4 if cd == torch.float32 else 2.0 ** -6
    for got, ref in [(out, want)] + [(leaves[i].grad, ref_leaves[i].grad)
                                     for i in grad_slots]:
        scale = ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("streams", [1, 3])
def test_graph_encode_with_dh_matches_plain_on_the_card(cuda, cd, streams):
    cfg = ModelConfig(**SMALL, compute_dtype=cd, electrostatics="dh")
    _, _, aa, windows = _setup(cd, streams, cuda)
    params = gkn_init(cfg, seed=0, device=cuda)
    weights = pr.rollout_weights(params, cfg, aa, cuda)
    bufs = pr.alloc_buffers(cfg, streams, 12, cuda)
    pr.reset_launch_counts()
    pr.graph_encode(windows, weights, 8.0, bufs)
    edges, mask, count, over, inv_deg, ef, x0 = pr.graph_encode_plain(
        windows, weights, 8.0, cfg.max_edges, bufs.ef.dtype)
    torch.cuda.synchronize()
    assert pr.launch_counts()["graph_encode"] == 1
    # the contact test does not read the potential: the graph stays exact
    for got, want in ((bufs.edges, edges), (bufs.mask, mask),
                      (bufs.count.long(), count), (bufs.inv_deg, inv_deg),
                      (bufs.ef, ef)):
        assert torch.equal(got, want)
    # expf, sqrtf and the division round in the last place unlike
    # PyTorch's, and the 11 sources are summed in another order
    torch.testing.assert_close(bufs.x0, x0, rtol=1e-5, atol=1e-5)
    no_q = dict(weights, charges=torch.zeros_like(weights["charges"]))
    x0_no_q = pr.graph_encode_plain(windows, no_q, 8.0, cfg.max_edges,
                                    bufs.ef.dtype)[-1]
    assert (x0_no_q - x0).abs().max().item() > 1e-3


def _encoder_case(r, cd, dh, streams, max_edges, device, frames=10):
    """The flagship encoder (width 64, window 10, seeded weights) at r
    residues: (weights, windows (streams, frames, r, 3), buffers)."""
    cfg = ModelConfig(width=64, ker_width=64, depth=1, window_size=frames,
                      num_residues=r, max_edges=max_edges,
                      graph_mode="sparse", predict_delta=True,
                      compute_dtype=cd,
                      electrostatics="dh" if dh else "none")
    traj = synthetic_trajectory(num_frames=frames + 8 * streams,
                                num_residues=r, seed=6)
    windows = torch.as_tensor(np.stack(
        [traj.positions[8 * i:8 * i + frames] for i in range(streams)]),
        device=device)
    params = gkn_init(cfg, seed=0, device=device)
    aa = torch.as_tensor(traj.aminoacids, device=device)
    return (pr.rollout_weights(params, cfg, aa, device), windows,
            pr.alloc_buffers(cfg, streams, r, device))


def _hold_encoder(weights, windows, bufs, max_edges):
    """The kernel's outputs against the plain version's: the graph exact,
    x0 within 1e-5 of its scale (the transcendentals and, with dh, the
    potential's sum over the sources round unlike PyTorch's). Returns the
    plain count."""
    pr.reset_launch_counts()
    bufs.overflow.zero_()
    pr.graph_encode(windows, weights, 8.0, bufs)
    edges, mask, count, over, inv_deg, ef, x0 = pr.graph_encode_plain(
        windows, weights, 8.0, max_edges, bufs.ef.dtype)
    torch.cuda.synchronize()
    assert pr.launch_counts()["graph_encode"] == 1
    for got, want in ((bufs.edges, edges), (bufs.mask, mask),
                      (bufs.count.long(), count), (bufs.inv_deg, inv_deg),
                      (bufs.ef, ef)):
        assert torch.equal(got, want)
    assert bool(bufs.overflow[0]) == bool(over.any())
    scale = max(1.0, x0.abs().max().item())
    assert (bufs.x0 - x0).abs().max().item() <= 1e-5 * scale
    return count


@pytest.mark.gpu
@pytest.mark.parametrize("r", [12, 28, 80, 129, 512])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [False, True], ids=["plain", "dh"])
@pytest.mark.parametrize("streams", [1, 8])
def test_graph_encode_matches_plain_at_any_size_on_the_card(cuda, r, cd, dh,
                                                            streams):
    """12 slots a residue: no synthetic frame has that many contacts."""
    weights, windows, bufs = _encoder_case(r, cd, dh, streams, 12 * r, cuda)
    count = _hold_encoder(weights, windows, bufs, 12 * r)
    assert bool((count <= 12 * r).all()) and bool((count > r).all())


@pytest.mark.gpu
@pytest.mark.parametrize("r", [28, 129, 512])
@pytest.mark.parametrize("dh", [False, True], ids=["plain", "dh"])
def test_graph_encode_overflow_matches_plain_on_the_card(cuda, r, dh):
    """As many slots as residues: every frame overflows; the slots past E
    are dropped and the count still counts them."""
    weights, windows, bufs = _encoder_case(r, "bfloat16", dh, 3, r, cuda)
    count = _hold_encoder(weights, windows, bufs, r)
    assert bool((count > r).all()) and bool(bufs.overflow[0])


@pytest.mark.gpu
@pytest.mark.parametrize("r,message", [
    (1024, "bytes of shared memory for a window of 10 frames of 1024 "
           "residues"),
    (1056, "at most 1024 residues")])
def test_graph_encode_refuses_a_shape_past_its_limits_before_launch(
        cuda, r, message):
    """Past shared memory (at T = 10 a window of 1,024 residues with its
    bit matrix needs more than an H100 block holds) or past 32 contact
    words a row, the wrapper raises before any launch."""
    weights, windows, bufs = _encoder_case(r, "float32", False, 1, 64, cuda)
    pr.reset_launch_counts()
    with pytest.raises(ValueError, match=message):
        pr.graph_encode(windows, weights, 8.0, bufs)
    assert pr.launch_counts()["graph_encode"] == 0
    plan = pr.graph_encode_plan(10, 1024, 4, 64, False)
    assert plan["smem"] > plan["max_smem"]
    # the flagship's longest window at 512 residues still fits
    assert pr.graph_encode_plan(28, 512, 4, 64, True)["smem"] <= plan[
        "max_smem"]


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("graph", ["random", "hub", "full"])
@pytest.mark.parametrize("w,depth", [(16, 2), (64, 2), (64, 1)])
def test_fused_kernel_matches_its_plain_version_on_the_card(cuda, cd, graph,
                                                            w, depth):
    """Width 64 in bf16 takes the conv stack's tensor-core body, every other
    case the CUDA-core body; 12 nodes leave some of a cluster's 8 blocks
    with one node or none, and a depth of 1 is two layers, the fewest."""
    cfg = ModelConfig(**{**SMALL, "width": w, "depth": depth},
                      compute_dtype=cd)
    params = gkn_init(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    s, r, e = 3, 12, 128
    mask = torch.zeros(s, e, device=cuda)
    mask[:, :90] = 1.0
    edges = torch.as_tensor(rng.integers(0, r, (s, 2, e)), dtype=torch.int32,
                            device=cuda)
    edges[:, :, 90:] = 0
    if graph != "random":
        _, edges, mask = dict(
            (g[0], g) for g in _stress_graphs(5, s, r, e, 90, 60, cuda))[graph]
    cdt = torch.float32 if cd == "float32" else torch.bfloat16
    ef = torch.as_tensor(rng.normal(size=(s, e, 6)).astype(np.float32),
                         device=cuda).to(cdt)
    x0 = torch.as_tensor(rng.normal(size=(s, r, w)).astype(np.float32),
                         device=cuda)
    ops = (ef, mask, edges, sparse_inv_degree(edges, mask, r), x0,
           *fg.fused_weights(params, cfg), depth)
    before = profiling.counters().get("fused_edge_conv_stack", 0)
    got = fg.fused_edge_conv_stack(*ops)
    want = fg.fused_edge_conv_stack_plain(*ops)
    torch.cuda.synchronize()
    assert profiling.counters()["fused_edge_conv_stack"] == before + 1
    # f32: sums in another order; bf16: now and then a flipped rounding
    tol = 1e-4 if cd == "float32" else 2.0 ** -6
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale


def _train_graph(kind, seed, b, r=12, e=128, real=90):
    """(edges (b, 2, e) int32, mask (b, e) f32) with numpy: a random graph
    with its padded slots at the end; the stress graphs of the rollout
    kernels (a hub of in-degree 60 beside a node without incoming edges,
    every slot taken); the hub turned into a source of 60 edges, which is
    what the backward deals by; and examples without any real edge."""
    if kind == "random":
        rng = np.random.default_rng(seed)
        mask = np.zeros((b, e), np.float32)
        mask[:, :real] = 1.0
        edges = (rng.integers(0, r, (b, 2, e)) * mask[:, None]).astype(np.int32)
        return edges, mask
    if kind == "empty":
        return np.zeros((b, 2, e), np.int32), np.zeros((b, e), np.float32)
    graphs = {name: (ed.numpy(), mk.numpy())
              for name, ed, mk in _stress_graphs(seed, b, r, e, real, 60, "cpu")}
    if kind == "hub_out":
        edges, mask = graphs["hub"]
        return np.ascontiguousarray(edges[:, ::-1]), mask
    return graphs[kind]


def _train_conv_check(ops, g_out, depth, tol):
    """Both training kernels against their plain versions: the stack layer
    by layer (the backward runs on the plain version's stack, so that both
    take the relu mask from the same activations), all six gradients and
    the dK rows of padded slots, each within ``tol`` of its scale."""
    out, stack = tc.train_conv_forward(*ops, depth)
    out_p, stack_p = tc.train_conv_forward_plain(*ops, depth)
    x0, kt, edges, mask, inv_deg, root1, _, root2, _ = ops
    bwd = (g_out, stack_p, kt, edges, mask, inv_deg, root1, root2, depth)
    got = tc.train_conv_backward(*bwd)
    want = tc.train_conv_backward_plain(*bwd)
    torch.cuda.synchronize()
    assert torch.equal(out, stack[:, -1]) and torch.equal(stack[:, 0], x0)

    def close(a, b, what):
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * scale, (what, err, scale)

    for layer in range(1, 2 * depth + 1):
        close(stack[:, layer], stack_p[:, layer], f"stack {layer}")
    for name, a, b in zip(("dx0", "dkt", "droot1", "dbias1", "droot2",
                           "dbias2"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert bool(torch.isfinite(a).all()), name
        close(a, b, name)
    pad = mask == 0
    if bool(pad.any()):
        close(got[1][pad], want[1][pad], "dkt of padded slots")
    return out, stack, got


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 17])
@pytest.mark.parametrize("depth", [1, 2, 6])
@pytest.mark.parametrize("graph", ["random", "hub", "hub_out", "full",
                                   "empty"])
@pytest.mark.parametrize("cd,w", [(torch.bfloat16, 64), (torch.float32, 64),
                                  (torch.bfloat16, 16), (torch.float32, 16)])
def test_training_kernels_hold_against_their_plain_versions_on_the_card(
        cuda, cd, w, graph, depth, b):
    """bf16 at width 64 runs the tensor-core bodies, every other case the
    CUDA-core ones; B = 17 is not a multiple of the clusters the card
    holds at once. f32: sums in another order; bf16: now and then a
    flipped rounding, 2^-8 of a value, carried through the layers."""
    ops = _train_conv_operands(11, cd, cuda, b=b, w=w,
                               graph=_train_graph(graph, 3, b))
    tol = 1e-4 if cd == torch.float32 else 2.0 ** -6
    _train_conv_check(ops[:-1], ops[-1], depth, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_an_example_gives_the_same_bits_at_any_batch_position(cuda, cd):
    """Example 0 of a batch of 17 is example 16 too: its six outputs, its
    stack and its output are equal to the bit at both positions and over
    two runs."""
    ops = list(_train_conv_operands(13, cd, cuda, b=17, w=64,
                                    graph=_train_graph("random", 5, 17)))
    for i, t in enumerate(ops):
        if i not in (5, 6, 7, 8):  # all but the shared weights
            t[16] = t[0]
    runs = []
    for _ in range(2):
        out, stack = tc.train_conv_forward(*ops[:-1], 6)
        x0, kt, edges, mask, inv_deg, root1, _, root2, _ = ops[:-1]
        grads = tc.train_conv_backward(ops[-1], stack, kt, edges, mask,
                                       inv_deg, root1, root2, 6)
        torch.cuda.synchronize()
        runs.append([out, stack, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for t in runs[0]:
        assert torch.equal(t[0], t[16])


@pytest.mark.gpu
def test_train_conv_clusters_and_width_checks_on_the_card(cuda):
    n = tc.train_conv_clusters(28, 64, 256, 6, torch.bfloat16)
    assert set(n) == {"train_conv_fwd", "train_conv_bwd"}
    assert all(v >= 1 for v in n.values())
    ops = _train_conv_operands(3, torch.float32, cuda, b=2, w=16)
    x0, kt, edges, mask, inv_deg, root1, _, root2, _, g_out = ops
    # past the CUDA-core bodies' 128 columns in f32: refused by the plan,
    # before any launch
    tc.reset_launch_counts()
    stack = torch.zeros(2, 5, 12, 136, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8 and at most 128"):
        tc.train_conv_backward(torch.zeros(2, 12, 136, device=cuda), stack,
                               torch.zeros(2, 128, 136 * 136, device=cuda),
                               edges, mask, inv_deg, root1, root2, 2)
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}
    # a kt that starts off a 16-byte boundary raises
    flat = torch.zeros(2 * 128 * 256 + 2, device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        tc.train_conv_forward(x0, flat[2:].view(2, 128, 256), edges, mask,
                              inv_deg, *ops[5:9], 2)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [60, 72, 96])
def test_any_width_trains_on_the_training_kernels_on_the_card(cuda, width):
    """Widths past the tensor-core body's 64, and one that is not a
    multiple of 8 (padded to 64), with ``train_conv_impl="pallas"`` on the
    card: one launch of each training kernel, and the output, loss and
    every gradient agree with the CPU run of the same inputs (the kernel's
    plain version) to the training tolerance of the CPU tests, rtol 2e-4 /
    atol 1e-5 in f32."""
    cfg = ModelConfig(**{**SMALL, "width": width,
                         "train_conv_impl": "pallas",
                         "compute_dtype": "float32"})
    traj = synthetic_trajectory(num_frames=32, num_residues=12, seed=4)
    ds = WindowDataset(traj, window_size=4, graph_mode="sparse",
                       max_edges=128)
    batch = ds.get_batch(np.arange(5))
    params = gkn_init(cfg, seed=0, device="cpu")
    res = {}
    for dev in ("cpu", cuda):
        tb = loop.featurize_batch(cfg, {k: torch.as_tensor(v, device=dev)
                                        for k, v in batch.items()})
        tc.reset_launch_counts()
        (l2, (_, out)), grads = loop.loss_and_grads(
            tree_map(lambda t: t.to(dev), params), cfg, tb)
        torch.cuda.synchronize()
        n = int(dev != "cpu")
        assert tc.launch_counts() == {"train_conv_fwd": n,
                                      "train_conv_bwd": n}
        res[str(dev)] = (float(l2), out.cpu(),
                         [g.cpu() for g in tree_leaves(grads)])
    (l_c, out_c, g_c), (l_g, out_g, g_g) = res["cpu"], res["cuda"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c)
    torch.testing.assert_close(out_g, out_c, rtol=2e-4, atol=1e-5)
    assert len(g_c) == len(g_g) == 21
    for got, want in zip(g_g, g_c):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


@pytest.mark.gpu
def test_a_width_past_the_training_kernels_raises_before_any_launch(cuda):
    """Width 136 in f32 is past the CUDA-core bodies' 128 columns: the
    forward asks both kernels' plans first, so the model raises
    ``ValueError`` with the limit and launches nothing."""
    cfg = ModelConfig(**{**SMALL, "width": 136, "train_conv_impl": "pallas",
                         "compute_dtype": "float32"})
    traj = synthetic_trajectory(num_frames=32, num_residues=12, seed=4)
    ds = WindowDataset(traj, window_size=4, graph_mode="sparse",
                       max_edges=128)
    tb = loop.featurize_batch(cfg, {
        k: torch.as_tensor(v, device=cuda)
        for k, v in ds.get_batch(np.arange(2)).items()})
    params = gkn_init(cfg, seed=0, device=cuda)
    tc.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 8 and at most 128"):
        loop.loss_and_grads(params, cfg, tb)
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("grad_steps,backward", [(None, 2), (1, 1)],
                         ids=["full-bptt", "grad_steps-1"])
def test_a_curriculum_step_runs_the_training_kernels_on_the_card(
        cuda, grad_steps, backward, monkeypatch):
    """A K = 2 curriculum loss on the kernel path in f32: two forward
    launches and one backward launch per supervised step, the same rebuilt
    edge lists as the CPU run of the same inputs (the kernel's plain
    version), and the loss, MSE and every gradient within the training
    tolerance of the CPU tests, rtol 2e-4 / atol 1e-5."""
    cfg = ModelConfig(**{**SMALL, "train_conv_impl": "pallas",
                         "compute_dtype": "float32"})
    traj = synthetic_trajectory(num_frames=32, num_residues=12, seed=4)
    ds = WindowDataset(traj, window_size=4, graph_mode="sparse",
                       max_edges=128)
    batch = ds.get_batch(np.arange(5), rollout_horizon=2)
    params = gkn_init(cfg, seed=0, device="cpu")
    graphs, build = [], curriculum._build_graph

    def recording(cfg_x, frame, threshold):
        graph, ov = build(cfg_x, frame, threshold)
        graphs.append(graph.edges.cpu())
        return graph, ov

    monkeypatch.setattr(curriculum, "_build_graph", recording)
    res = {}
    for dev in ("cpu", cuda):
        tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        graphs.clear()
        tc.reset_launch_counts()
        (loss, (m, ov)), grads = loop.value_and_grad(
            lambda p: curriculum.curriculum_loss_batched(
                p, cfg, loop.featurize_batch(cfg, tb), tb["y_seq"],
                coord_clip=1000.0, loss_space="delta", return_overflow=True,
                grad_steps=grad_steps),
            tree_map(lambda t: t.to(dev), params))
        torch.cuda.synchronize()
        on_card = dev != "cpu"
        assert tc.launch_counts() == {
            "train_conv_fwd": 2 * on_card,
            "train_conv_bwd": backward * on_card}
        res[str(dev)] = (float(loss), float(m), bool(ov), list(graphs),
                         [g.cpu() for g in tree_leaves(grads)])
    (l_c, m_c, ov_c, gr_c, g_c), (l_g, m_g, ov_g, gr_g, g_g) = (
        res["cpu"], res["cuda"])
    assert len(gr_c) == len(gr_g) == 1 and torch.equal(gr_c[0], gr_g[0])
    assert ov_c == ov_g
    assert abs(l_g - l_c) <= 2e-4 * abs(l_c)
    assert abs(m_g - m_c) <= 2e-4 * abs(m_c)
    assert len(g_c) == len(g_g) == 21
    for got, want in zip(g_g, g_c):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)
