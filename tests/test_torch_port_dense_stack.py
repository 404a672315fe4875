"""The dense tied conv stack with its hand-written backward
(``ops/conv_stack.py::dense_tied_stack``) against plain autograd through
the per-layer ``ops/edge_conv.py::edge_conv_dense`` loop it replaces, and
the rule by which ``models/gkn.py::gkn_apply_single`` takes it.

On the CPU, in f32: the stack's output, dx0, droot and dbias are the
per-layer loop's to the bit (the same products in the same order); dK is
one f32 sum over the layer axis where autograd adds the layers' outer
products one at a time, so it is held to 2 * L * 2**-24 of the sum of
the terms' magnitudes (L = 2 * depth terms), which the test records
from the per-layer loop itself. ``gkn_apply_single`` takes the stack
only where its products run on bf16 tensor cores, so on the CPU it runs
the per-layer loop and the counter ``dense_tied_stack`` stays at 0; with
that rule forced, the tied configurations take the stack and the others
do not.

The tests marked ``gpu`` skip without a card and run on it with
``python -m pytest --noconftest tests/test_torch_port_dense_stack.py``:
at villin's widths (R = 35, w = 64, depth 6) in bf16 the forward is the
per-layer ``_DenseAggregate`` path's to the bit, dK lies no farther from
the f32 path's than the per-layer dK does, dx0, droot and dbias lie
within 2**-8 of the per-layer path's, a CUDA-graph capture and replay of
the forward and backward is the eager call, and a graphed K = 4
curriculum step counts four stacks. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    contact_map,
    degree_from_adjacency,
    dense_edge_features,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn, gkn_init
from molecular_dynamics_neural_operator_tpu_torch.ops import (
    conv_stack,
    edge_conv,
    mlp,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import graphs
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

F32_EPS = 2.0 ** -24
BF16_STEP = 2.0 ** -8
COUNTER = "dense_tied_stack"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: bf16 tensor-core products")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def dense_stack_args(seed, lead, r, w, dtype=torch.float32, device="cpu"):
    """(x0, base, inv_deg, convs): x0 (*lead, R, w); base the masked
    kernel tensor as stored, [j, w, i, v] in ``dtype`` (its [j, i, w, v]
    view is what the layers take); about half the pairs adjacent, self
    loops kept; conv1's and conv2's root and bias."""
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randn(lead + (r, w), generator=gen)
    kernels = torch.randn(lead + (r, r, w, w), generator=gen) / w
    adj = (torch.rand(lead + (r, r), generator=gen) < 0.5).float()
    adj = torch.clamp(adj + torch.eye(r), max=1.0)
    masked = edge_conv.masked_dense_kernels(kernels, adj, dtype)
    inv_deg = 1.0 / degree_from_adjacency(adj)
    convs = [edge_conv.edge_conv_init(gen, w) for _ in range(2)]
    base = masked.transpose(-3, -2).contiguous()
    to = (lambda t: t.to(device))
    return (to(x0), to(base), to(inv_deg),
            [{k: to(v) for k, v in c.items()} for c in convs])


def per_layer(depth, x0, masked, inv_deg, convs, cd):
    """The loop ``gkn_apply_single`` runs outside the stack."""
    x = x0
    for conv in [convs[0]] * depth + [convs[1]] * depth:
        x = torch.relu(edge_conv.edge_conv_dense(conv, x, masked, inv_deg,
                                                 cd))
    return x


def the_stack(depth, x0, masked, inv_deg, convs, cd):
    return conv_stack.dense_tied_stack(
        depth, x0, masked, inv_deg, convs[0]["root"], convs[0]["bias"],
        convs[1]["root"], convs[1]["bias"])


def grads(stack, depth, x0, base, inv_deg, convs, cd, g):
    """(out, dx0, dK as stored, droot1, dbias1, droot2, dbias2) of
    ``stack`` under the cotangent g."""
    x0 = x0.clone().requires_grad_(True)
    base = base.clone().requires_grad_(True)
    convs = [{k: v.clone().requires_grad_(True) for k, v in c.items()}
             for c in convs]
    out = stack(depth, x0, base.transpose(-3, -2), inv_deg, convs, cd)
    leaves = (x0, base, convs[0]["root"], convs[0]["bias"],
              convs[1]["root"], convs[1]["bias"])
    return (out.detach(),) + torch.autograd.grad(out, leaves, g)


def dk_magnitudes(monkeypatch, depth, x0, base, inv_deg, convs, g):
    """sum over the layers of |row| (x) |cotangent| of the per-layer
    loop's products, (..., R*w, R*w): what the f32 sums of dK round a
    share of."""
    rows, cots = [], []
    real = edge_conv._row_product

    def spy(row, op, cd):
        out = real(row, op, cd)
        rows.append(row.detach())
        out.register_hook(cots.append)
        return out

    monkeypatch.setattr(edge_conv, "_row_product", spy)
    grads(per_layer, depth, x0, base, inv_deg, convs, None, g)
    monkeypatch.undo()
    # the backward meets the layers last first
    return sum(r.abs().double().transpose(-1, -2) @ c.abs().double()
               for r, c in zip(rows, reversed(cots)))


@pytest.mark.parametrize("lead", [(3,), (2, 2)], ids=["batch", "two-axes"])
@pytest.mark.parametrize("depth", [1, 6])
def test_the_stack_is_the_per_layer_loop_in_f32(monkeypatch, depth, lead):
    r, w = 5, 4
    x0, base, inv_deg, convs = dense_stack_args(depth, lead, r, w)
    g = torch.randn(x0.shape, generator=torch.Generator().manual_seed(9))
    before = profiling.counters().get(COUNTER, 0)
    got = grads(the_stack, depth, x0, base, inv_deg, convs, None, g)
    assert profiling.counters()[COUNTER] == before + 1
    want = grads(per_layer, depth, x0, base, inv_deg, convs, None, g)
    for i in (0, 1, 3, 4, 5, 6):
        assert torch.equal(got[i], want[i]), i
    mags = dk_magnitudes(monkeypatch, depth, x0, base, inv_deg, convs, g)
    dk = [t.reshape(mags.shape).double() for t in (got[2], want[2])]
    bound = 2 * (2 * depth) * F32_EPS * mags + 1e-30
    assert ((dk[0] - dk[1]).abs() <= bound).all()
    assert torch.count_nonzero(got[2]) > 0


def test_the_stack_keeps_no_gradient_where_none_is_asked():
    """Under ``no_grad`` the stack is its forward alone: the per-layer
    loop's output, and no graph to differentiate."""
    x0, base, inv_deg, convs = dense_stack_args(2, (2,), 5, 4)
    masked = base.transpose(-3, -2).requires_grad_(False)
    with torch.no_grad():
        got = the_stack(2, x0, masked, inv_deg, convs, None)
        want = per_layer(2, x0, masked, inv_deg, convs, None)
    assert got.grad_fn is None and torch.equal(got, want)


def _dense_cfg(**kw):
    opts = dict(width=8, ker_width=16, depth=2, window_size=4,
                num_residues=9, graph_mode="dense", predict_delta=True,
                kernel_init_scale=0.1)
    opts.update(kw)
    return ModelConfig(**opts)


def _dense_inputs(cfg, device="cpu", batch=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    r, t = cfg.num_residues, cfg.window_size
    walk = torch.cumsum(torch.randn(batch, t, r, 3, generator=gen), dim=-2)
    window = (3.0 * walk / 3 ** 0.5).to(device)
    aa = torch.randint(0, 20, (r,), generator=gen).to(device)
    pos = window[:, -1]
    graph = gkn.DenseGraph(adj=contact_map(pos, 8.0),
                           edge_feats=dense_edge_features(pos))
    return aa, window, graph


def _apply(cfg, params, aa, window, graph):
    """(out, gradient of every leaf) of one dense forward."""
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _flat(params).items()}
    out = gkn.gkn_apply_single(_unflat(leaves), cfg, aa, window, graph)
    g = torch.cos(torch.arange(out.numel(), dtype=out.dtype,
                               device=out.device)).reshape(out.shape)
    return out.detach(), dict(zip(leaves, torch.autograd.grad(
        out, list(leaves.values()), g, allow_unused=True)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def test_a_dense_forward_on_the_cpu_takes_the_per_layer_loop():
    cfg = _dense_cfg(compute_dtype="bfloat16")
    params = gkn_init(cfg, seed=0)
    aa, window, graph = _dense_inputs(cfg)
    before = profiling.counters().get(COUNTER, 0)
    out, _ = _apply(cfg, params, aa, window, graph)
    assert torch.isfinite(out).all()
    assert profiling.counters().get(COUNTER, 0) == before


@pytest.mark.parametrize(
    "opts, takes",
    [({}, True),
     ({"fused_conv_vjp": False}, False),
     ({"tie_edge_kernel": False}, False),
     ({"legacy_no_lstm": True}, False),
     ({"depth": 0}, False)],
    ids=["tied", "no-fused-vjp", "untied", "legacy", "depth-0"])
def test_the_rule_that_takes_the_dense_stack(monkeypatch, opts, takes):
    """With the bf16 rule forced on the CPU's f32 products, the tied
    stack is taken once a forward, and forward and gradients are the
    per-layer loop's (dK's f32 sum in another order: 1e-6)."""
    cfg = _dense_cfg(compute_dtype="float32", **opts)
    params = gkn_init(cfg, seed=1)
    aa, window, graph = _dense_inputs(cfg, seed=1)
    want = _apply(cfg, params, aa, window, graph)
    monkeypatch.setattr(gkn, "_bf16_product", lambda op: True)
    before = profiling.counters().get(COUNTER, 0)
    got = _apply(cfg, params, aa, window, graph)
    assert profiling.counters().get(COUNTER, 0) == before + int(takes)
    assert torch.equal(got[0], want[0])
    for name, dw in want[1].items():
        if dw is None:
            assert got[1][name] is None, name
            continue
        scale = float(dw.abs().max()) + 1e-30
        gap = float((got[1][name] - dw).abs().max())
        assert gap <= 1e-6 * scale, (name, gap / scale)


# ---- on the card ---------------------------------------------------------

VILLIN = dict(r=35, w=64, depth=6)


def _villin_stack(device, seed=3, batch=2):
    x0, base, inv_deg, convs = dense_stack_args(
        seed, (batch,), VILLIN["r"], VILLIN["w"], torch.bfloat16, device)
    g = torch.randn(x0.shape, device=device)
    return x0, base, inv_deg, convs, g


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.gpu
def test_the_bf16_stack_on_the_card_is_the_per_layer_path(cuda):
    """Villin's widths in bf16: the forward is the per-layer
    ``_DenseAggregate`` path's to the bit; dK, one f32 sum rounded once,
    lies no farther from the f32 path's dK (the same bf16 kernel tensor
    in f32, f32 operands and products) than the per-layer path's 12
    roundings and 11 bf16 adds; dx0, droot and dbias take the per-layer
    path's products and lie within 2**-8 of it."""
    depth = VILLIN["depth"]
    x0, base, inv_deg, convs, g = _villin_stack(cuda)
    cd = torch.bfloat16
    before = profiling.counters().get(COUNTER, 0)
    got = grads(the_stack, depth, x0, base, inv_deg, convs, cd, g)
    assert profiling.counters()[COUNTER] == before + 1
    want = grads(per_layer, depth, x0, base, inv_deg, convs, cd, g)
    with mlp.exact_products():
        exact = grads(per_layer, depth, x0, base.float(), inv_deg, convs,
                      torch.float32, g)
    assert profiling.counters()[COUNTER] == before + 1
    assert torch.equal(got[0], want[0])
    assert got[2].dtype == want[2].dtype == cd
    assert _rel(got[2], exact[2]) <= _rel(want[2], exact[2])
    for i in (1, 3, 4, 5, 6):
        gap = (got[i] - want[i]).abs()
        bound = BF16_STEP * want[i].abs() + F32_EPS * want[i].abs().max()
        assert (gap <= bound).all(), (i, float((gap / bound).max()))


@pytest.mark.gpu
def test_a_captured_stack_replays_the_eager_call(cuda):
    """One CUDA-graph capture of the forward and backward at villin's
    widths: a replay gives the eager call's output and gradients to the
    bit, and adds 1 to ``dense_tied_stack`` as the eager call does."""
    depth = VILLIN["depth"]
    x0, base, inv_deg, convs, g = _villin_stack(cuda, seed=4)
    want = grads(the_stack, depth, x0, base, inv_deg, convs, None, g)

    def body():
        return grads(the_stack, depth, x0, base, inv_deg, convs, None, g)

    captured, static = graphs.capture(body, "dense_tied_stack", body)
    before = profiling.counters().get(COUNTER, 0)
    captured.replay()
    torch.cuda.synchronize()
    assert profiling.counters()[COUNTER] == before + 1
    for a, b in zip(static, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_a_graphed_k4_curriculum_step_counts_four_stacks(cuda):
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        TrainState,
        make_curriculum_train_step,
        make_optimizer,
    )

    cfg = _dense_cfg(compute_dtype="bfloat16", num_residues=12)
    params = gkn_init(cfg, seed=2, device=cuda)
    gen = torch.Generator().manual_seed(5)
    frames = torch.cumsum(torch.randn(cfg.window_size + 4, 12, 3,
                                      generator=gen), dim=-2) * 1.7
    b = 2
    window = frames[None, :cfg.window_size].expand(b, -1, -1, -1)
    y_seq = frames[None, cfg.window_size:].expand(b, -1, -1, -1)
    batch = {"aa": torch.randint(0, 20, (12,), generator=gen),
             "window": window, "y": y_seq[:, 0], "y_seq": y_seq,
             "adj": contact_map(window[:, -1], 8.0)}
    batch = {k: v.contiguous().to(cuda) for k, v in batch.items()}
    tx, _ = make_optimizer(lr=1e-4)
    step = make_curriculum_train_step(cfg, tx, 4, loss_space="delta")
    state = TrainState(params, tx.init(params), 0, 0)
    state, _ = step(state, batch)
    before = profiling.counters().get(COUNTER, 0)
    for _ in range(3):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert profiling.counters()[COUNTER] == before + 12
    assert np.isfinite(float(metrics["rel_l2"]))
