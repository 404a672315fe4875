"""The port's CUDA kernel wrappers (ops/cuda/persistent_rollout.py,
ops/cuda/train_conv.py and ops/cuda/fused_gkn.py).

On the CPU a wrapper runs its kernel's plain version; those tests run
everywhere. The tests marked ``gpu`` launch the kernels and hold each
against its plain version on the card; they skip without a CUDA card
(CUDA kernels have no CPU mode). ``python3 chip_smoke.py`` runs the same
comparisons at the bench shapes.
"""

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    residual_prior,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    fused_gkn as fg,
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
    out = pr.edge_mlp(a, layer["w"], layer["b"], True)
    assert torch.equal(out, pr.edge_mlp_plain(a, layer["w"], layer["b"],
                                              True))
    assert pr.launch_counts() == {"graph_encode": 0, "edge_mlp": 0,
                                  "conv_head": 0}


def test_edge_mlp_plain_masks_rows_and_keeps_dtype():
    g = torch.Generator().manual_seed(0)
    a = torch.randn(5, 8, generator=g).to(torch.bfloat16)
    w = torch.randn(8, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, generator=g)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0, 1.0])
    out = pr.edge_mlp_plain(a, w, b, False, mask)
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
        got = pr.edge_mlp(a, layer["w"], layer["b"], i < 2, rm)
        want = pr.edge_mlp_plain(a, layer["w"], layer["b"], i < 2, rm)
        # f32: ulp-level order differences; bf16: one flipped rounding
        # of the output, 2^-8 relative
        tol = 1e-5 if cd == "float32" else 2.0 ** -7
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale
        a = want

    for dst, src in ((bufs.edges, edges), (bufs.mask, mask),
                     (bufs.inv_deg, inv_deg), (bufs.x0, x0), (bufs.kmat, a)):
        dst.copy_(src)
    win_k, win_p = windows.clone(), windows.clone()
    coords = torch.empty(streams, 12, 3, device=cuda)
    pr.conv_head(bufs, weights, cfg, 100.0, win_k, coords)
    want = pr.conv_head_plain(x0, a, edges, mask, inv_deg, weights, cfg,
                              100.0, win_p)
    torch.cuda.synchronize()
    # held on the head's own output, the coordinates minus the prior: f32
    # ulp-level sums; bf16 a message rounding flipped by one unit (2^-8
    # relative), averaged over edges and layers. The output is rounded
    # into f32 coordinates after the prior is added: 2 ulps on top.
    head_out = (want - residual_prior(cfg, windows)).abs().max().item()
    ulp = torch.finfo(torch.float32).eps * want.abs().max().item()
    tol = (1e-4 if cd == "float32" else 1e-2) * head_out + 2 * ulp
    assert tol < 0.1 * head_out
    assert (coords - want).abs().max().item() <= tol
    assert torch.equal(win_k[:, :-1], win_p[:, :-1])


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
                                  "conv_head": 8}


def _train_conv_operands(seed, cd, device, b=6, r=12, w=16, e=128, real=90):
    """Seeded operands of the training conv stack with ``e - real`` padded
    slots (src = dst = 0, kt rows zero) at the end."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, e), np.float32)
    mask[:, :real] = 1.0
    edges = (rng.integers(0, r, size=(b, 2, e))
             * mask[:, None, :]).astype(np.int32)
    kt = (rng.normal(size=(b, e, w * w)) * 0.3 * mask[..., None])
    bound = 1.0 / np.sqrt(w)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    edges_t = torch.as_tensor(edges, device=device)
    return (t(rng.normal(size=(b, r, w))), t(kt).to(cd), edges_t,
            sparse_inv_degree(edges_t, t(mask), r),
            t(rng.uniform(-bound, bound, (w, w))),
            t(rng.uniform(-bound, bound, w)),
            t(rng.uniform(-bound, bound, (w, w))),
            t(rng.uniform(-bound, bound, w)),
            t(rng.normal(size=(b, r, w))))


@pytest.mark.gpu
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_train_conv_kernels_match_the_plain_version_on_the_card(cuda, cd):
    *ops, g_out = _train_conv_operands(7, cd, cuda)
    grad_slots = (0, 1, 4, 5, 6, 7)  # x0, kt, root1, bias1, root2, bias2
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


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_fused_kernel_matches_its_plain_version_on_the_card(cuda, cd):
    cfg = ModelConfig(**SMALL, compute_dtype=cd)
    params = gkn_init(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    s, r, e, w = 3, 12, 128, 16
    mask = torch.zeros(s, e, device=cuda)
    mask[:, :90] = 1.0
    edges = torch.as_tensor(rng.integers(0, r, (s, 2, e)), dtype=torch.int32,
                            device=cuda)
    edges[:, :, 90:] = 0
    cdt = torch.float32 if cd == "float32" else torch.bfloat16
    ef = torch.as_tensor(rng.normal(size=(s, e, 6)).astype(np.float32),
                         device=cuda).to(cdt)
    x0 = torch.as_tensor(rng.normal(size=(s, r, w)).astype(np.float32),
                         device=cuda)
    ops = (ef, mask, edges, sparse_inv_degree(edges, mask, r), x0,
           *fg.fused_weights(params, cfg), 2)
    fg.fused_edge_conv_stack.launches = 0
    got = fg.fused_edge_conv_stack(*ops)
    want = fg.fused_edge_conv_stack_plain(*ops)
    torch.cuda.synchronize()
    assert fg.fused_edge_conv_stack.launches == 1
    # f32: sums in another order; bf16: now and then a flipped rounding
    tol = 1e-4 if cd == "float32" else 2.0 ** -6
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= tol * scale
