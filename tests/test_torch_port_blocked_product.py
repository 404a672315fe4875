"""The blocked conv layer as one product a node
(``ops/edge_conv.py::_blocked_aggregate``), the edge MLP on tensor
cores (``ops/mlp.py::_on_tensor_cores``) and the kernel tensor from the
hand-written edge-MLP kernels (``ops/edge_conv.py::hand_mlp``).

On the CPU, without JAX (``tests/test_torch_port_ops.py`` holds the same
layer against the JAX package): the folded layer against the form it
replaced, a message a slot summed per node, forward and gradients, in
f32 and on bf16-rounded operands; an int8 kernel tensor, whose scale
rides on the mask, keeps that form to the bit; the rule that puts a
linear layer on tensor cores; the rule that sends the kernel tensor to
the hand-written MLP, the operator's plain form against ``mlp_apply``
at the 10,000-atom cell's widths, a training-shaped call that keeps its
gradient, an exported step that keeps the operator; and the program
counters stay at 0 on the CPU.

The tests marked ``gpu`` skip without a card and run on it with
``python -m pytest --noconftest tests/test_torch_port_blocked_product.py``:
the bf16 product against the exact f32 path on the same rounded
operands, the hand-written MLP and a few steps at the 10,000-atom cell's
widths against ``exact_products()``, the counters a step, and a bf16
bundle exported on the card against the in-process rollout.

Tolerances. The folded and the per-slot form add the same f32 products
in another order: at most gamma_K = K * 2**-24 of the sum of the
products' magnitudes for sums of K terms (K = D * w here), so the forward
is held to 2 * K * 2**-24 of |row| @ |K| elementwise. Where a gradient
is rounded to bf16 after such a sum, a reordered f32 sum can move the
rounding by one bf16 step: dx is held to 2**-8 of its terms' magnitudes
plus the f32 bound. On the CPU dK is one product an element, rounded
once, on both sides: equal to the bit. The card's bound is in its
test.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.ops import edge_conv, mlp
from molecular_dynamics_neural_operator_tpu_torch.rollout import scan
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

COUNTERS = ("plain_tc_linear", "blocked_bf16_aggregate", "fused_edge_mlp",
            "edge_mlp")
F32_EPS = 2.0 ** -24
BF16_STEP = 2.0 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: bf16 tensor-core products")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def blocked_layer(seed, r=64, d=8, w=16, device="cpu", kernel_dtype=None):
    """A cell-list block layout: slot n*d + k targets node n; about 60 %
    of the slots are real, the padded ones interleaved with them and
    naming node 0. Returns (conv, x, kernels, edges, mask, inv_deg)."""
    gen = torch.Generator().manual_seed(seed)
    e = r * d
    mask = (torch.rand(e, generator=gen) < 0.6).float()
    src = torch.randint(0, r, (e,), generator=gen) * mask.long()
    dst = torch.arange(r).repeat_interleave(d)
    edges = torch.stack([src, dst]).to(torch.int32)
    x = torch.randn(r, w, generator=gen)
    kernels = torch.randn(e, w, w, generator=gen) / w ** 0.5
    if kernel_dtype is not None:
        kernels = kernels.to(kernel_dtype)
    conv = edge_conv.edge_conv_init(gen, w)
    inv_deg = edge_conv.sparse_inv_degree(edges, mask, r, "blocked")
    to = (lambda t: t.to(device))
    return ({k: to(v) for k, v in conv.items()}, to(x), to(kernels),
            to(edges), to(mask), to(inv_deg))


def per_slot_layer(conv, x, kernels, edges, mask, inv_deg, cd):
    """The blocked layer as it was written before the fold: a message a
    slot in f32 from the rounded operands, masked, summed per node."""
    r = x.shape[-2]
    xs = torch.take_along_dim(x, edges[0].long()[:, None], dim=-2)
    m = torch.einsum("ew,ewv->ev", mlp.round_to(xs, cd),
                     mlp.round_to(kernels, cd))
    m = m * mask[:, None]
    agg = m.reshape(r, -1, m.shape[-1]).sum(dim=-2) * inv_deg[:, None]
    root = mlp.round_to(x, cd) @ mlp.round_to(conv["root"], cd)
    return agg + root + conv["bias"]


def magnitudes(x, kernels, edges, mask, inv_deg, cd):
    """|row| @ |op| per node, times inv_deg: what an f32 sum's rounding is
    a share of."""
    r = x.shape[-2]
    xs = torch.take_along_dim(x, edges[0].long()[:, None], dim=-2)
    row = (mlp.round_to(xs, cd) * mask[:, None]).abs().double()
    m = torch.einsum("ew,ewv->ev", row,
                     mlp.round_to(kernels, cd).abs().double())
    return m.reshape(r, -1, m.shape[-1]).sum(dim=-2) * inv_deg[:, None]


def grads(layer, conv, x, kernels, edges, mask, inv_deg, cd, g):
    """(out, dx, dK) of ``layer`` under the cotangent g."""
    x = x.clone().requires_grad_(True)
    k = kernels.clone().requires_grad_(True)
    out = layer(conv, x, k, edges, mask, inv_deg, cd)
    dx, dk = torch.autograd.grad(out, (x, k), g)
    return out.detach(), dx, dk


def folded_layer(conv, x, kernels, edges, mask, inv_deg, cd):
    return edge_conv.edge_conv_sparse(conv, x, kernels, edges, mask, inv_deg,
                                      "blocked", cd)


def dx_magnitudes(conv, x, kernels, edges, mask, inv_deg, cd, g):
    """dx with every term's magnitude: the gradient is linear in the
    kernels, the root weight and the cotangent."""
    absolute = {"root": conv["root"].abs(), "bias": conv["bias"]}
    return grads(per_slot_layer, absolute, x, kernels.abs(), edges, mask,
                 inv_deg, cd, g.abs())[1].double()


def assert_close(got, want, mags, k, rounding=0.0):
    """|got - want| within an f32 sum's reordering of K terms, plus
    ``rounding`` of the magnitudes for the bf16 roundings it can move."""
    bound = (rounding + 2 * k * F32_EPS) * mags + 1e-30
    gap = (got.double() - want.double()).abs()
    assert (gap <= bound).all(), float((gap / bound).max())


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_folded_layer_is_the_per_slot_form(seed, cd):
    """Forward, dx and dK of the folded layer against the form it
    replaced, on the same rounded operands (the kernel tensor in the
    compute dtype, as ``gkn_apply_single`` makes it)."""
    conv, x, kernels, edges, mask, inv_deg = blocked_layer(
        seed, kernel_dtype=cd)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(7))
    got = grads(folded_layer, conv, x, kernels, edges, mask, inv_deg, cd, g)
    want = grads(per_slot_layer, conv, x, kernels, edges, mask, inv_deg, cd,
                 g)
    d, w = kernels.shape[0] // x.shape[0], x.shape[-1]
    mags = magnitudes(x, kernels, edges, mask, inv_deg, cd)
    root = (mlp.round_to(x, cd) @ mlp.round_to(conv["root"], cd)).abs()
    assert_close(got[0], want[0], mags + root.double(), d * w)
    # dx: a sum over w a slot, rounded to cd, then the slots into their
    # sources
    assert_close(got[1], want[1],
                 dx_magnitudes(conv, x, kernels, edges, mask, inv_deg, cd,
                               g), w * d,
                 0.0 if cd == torch.float32 else BF16_STEP)
    assert torch.equal(got[2], want[2])
    # a padded slot's kernel gets no gradient, a real one does
    pad = mask == 0
    assert torch.count_nonzero(got[2][pad]) == 0
    assert torch.count_nonzero(got[2][~pad]) > 0


def test_an_int8_kernel_tensor_keeps_the_per_slot_form_to_the_bit():
    """The int8 kernel tensor's per-slot scale rides on the mask, which
    is then not 0/1: the layer stays a message a slot."""
    conv, x, kernels, edges, mask, inv_deg = blocked_layer(3)
    k8, scale = edge_conv.quantize_kernels_int8(kernels)
    scaled = mask * scale
    for cd in (torch.float32, torch.bfloat16):
        got = folded_layer(conv, x, k8, edges, scaled, inv_deg, cd)
        want = per_slot_layer(conv, x, k8, edges, scaled, inv_deg, cd)
        assert torch.equal(got, want)


def test_a_batch_of_graphs_is_each_graph_alone():
    """Leading axes: two graphs at once give each graph's layer."""
    layers = [blocked_layer(s, r=16, d=4, w=8) for s in (4, 5)]
    conv = layers[0][0]
    stacked = [torch.stack([lay[i] for lay in layers]) for i in range(1, 6)]
    got = edge_conv.edge_conv_sparse(conv, *stacked, "blocked")
    for b, lay in enumerate(layers):
        want = edge_conv.edge_conv_sparse(conv, *lay[1:], "blocked")
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def _cell_cfg(r, **kw):
    """The 10,000-atom cell's widths (``portbench/configs/
    solvated_10k.json``) at r atoms."""
    opts = dict(width=64, ker_width=1024, depth=6, window_size=4,
                num_residues=r, graph_mode="sparse", max_edges=r * 48,
                compute_dtype="bfloat16", predict_delta=True,
                kernel_init_scale=1.0 / 48, electrostatics="dh",
                neighbor_impl="cell_list", max_degree=48, cell_capacity=32,
                num_cells=65536)
    opts.update(kw)
    return ModelConfig(**opts)


def _grid_window(r, t, device, spacing=4.4, seed=0):
    """r atoms on a cubic grid of ``spacing`` A, t frames that jitter by
    0.05 A: 26 neighbours an atom at 8 A, none of them near 8 A."""
    gen = torch.Generator().manual_seed(seed)
    side = int(np.ceil(r ** (1 / 3)))
    idx = torch.arange(r)
    base = torch.stack([idx % side, (idx // side) % side,
                        idx // side ** 2], dim=-1).float() * spacing
    frames = base + 0.05 * torch.randn(t, r, 3, generator=gen)
    return frames.to(device)


def _step_args(cfg, device, seed=0):
    params = gkn_init(cfg, seed=seed, device=device)
    params["fc2"]["b"] = torch.zeros_like(params["fc2"]["b"])
    aa = torch.randint(0, 20, (cfg.num_residues,),
                       generator=torch.Generator().manual_seed(seed))
    return params, aa.to(device), _grid_window(cfg.num_residues,
                                               cfg.window_size, device,
                                               seed=seed)


@pytest.mark.parametrize(
    "is_cuda, compute_dtype, rows, exact, want",
    [(True, torch.bfloat16, 64, False, True),
     (True, torch.bfloat16, 8, False, True),
     (False, torch.bfloat16, 64, False, False),
     (True, torch.float32, 64, False, False),
     (True, None, 64, False, False),
     (True, torch.bfloat16, 6, False, False),
     (True, torch.bfloat16, 64, True, False)],
    ids=["cuda-bf16", "cuda-bf16-8-rows", "cpu", "f32", "no-dtype",
         "6-rows", "exact-products"])
def test_the_tensor_core_rule(is_cuda, compute_dtype, rows, exact, want):
    """A CUDA bf16 product whose weight has a multiple of 8 rows, outside
    ``exact_products()``: the rule decides from what it is given alone."""
    x = SimpleNamespace(is_cuda=is_cuda, shape=(5, rows))
    w = SimpleNamespace(is_cuda=is_cuda, shape=(rows, 64))
    with mlp.exact_products() if exact else contextlib.nullcontext():
        assert mlp._on_tensor_cores(x, w, compute_dtype) is want
    assert not mlp.products_exact()


def test_the_counters_stay_at_zero_on_the_cpu():
    """A bf16 cell-list rollout past 512 atoms takes the blocked layer
    and a bf16 edge MLP; on the CPU neither engages."""
    cfg = _cell_cfg(520, width=8, ker_width=16, depth=1,
                    electrostatics="none", num_cells=1024)
    assert scan.rebuilt_scatter_hint(cfg, 520) == "blocked"
    params, aa, window = _step_args(cfg, "cpu")
    before = profiling.counters()
    out, _, diag = scan.rollout_scan(params, cfg, aa, window, 2)
    after = profiling.counters()
    assert torch.isfinite(out).all() and not bool(diag["edge_overflow"])
    for name in COUNTERS:
        assert after.get(name, 0) == before.get(name, 0), name


def _edge_mlp(f, kw, width, seed=0, requires_grad=False):
    params = mlp.mlp_init(torch.Generator().manual_seed(seed),
                          [f, kw, kw, width * width])
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_(requires_grad)
    return params


@pytest.mark.parametrize(
    "is_cuda, cd, f, kw, width, exact, grad, want",
    [(True, torch.bfloat16, 6, 1024, 64, False, "off", True),
     (True, torch.bfloat16, 16, 64, 8, False, "off", True),
     (True, torch.bfloat16, 6, 1024, 64, False, "on, no operand", True),
     (True, torch.bfloat16, 6, 1024, 64, False, "on, weights", False),
     (True, torch.bfloat16, 6, 1024, 64, False, "on, features", False),
     (True, torch.bfloat16, 6, 1024, 64, True, "off", False),
     (True, torch.float32, 6, 1024, 64, False, "off", False),
     (True, None, 6, 1024, 64, False, "off", False),
     (True, torch.bfloat16, 6, 96, 64, False, "off", False),
     (True, torch.bfloat16, 6, 1024, 12, False, "off", False),
     (True, torch.bfloat16, 17, 1024, 64, False, "off", False),
     (False, torch.bfloat16, 6, 1024, 64, False, "off", False)],
    ids=["cuda-bf16", "narrowest", "grad-on-no-operand", "grad-on-weights",
         "grad-on-features", "exact-products", "f32", "no-dtype",
         "ker-width-96", "width-12", "17-features", "cpu"])
def test_the_hand_mlp_rule(is_cuda, cd, f, kw, width, exact, grad, want):
    """The kernel tensor goes through the hand-written MLP only where
    nothing will differentiate it and the shapes take the narrow and the
    wgmma kernel: the rule decides from what the call can observe."""
    params = _edge_mlp(f, kw, width, requires_grad=grad == "on, weights")
    ef = SimpleNamespace(is_cuda=is_cuda,
                         requires_grad=grad == "on, features")
    with contextlib.ExitStack() as stack:
        if exact:
            stack.enter_context(mlp.exact_products())
        if grad == "off":
            stack.enter_context(torch.no_grad())
        assert edge_conv.hand_mlp(params, ef, width, cd) is want
    assert not mlp.products_exact()


def test_the_rule_wants_three_layers():
    params = mlp.mlp_init(torch.Generator().manual_seed(0), [6, 64, 256])
    ef = SimpleNamespace(is_cuda=True, requires_grad=False)
    with torch.no_grad():
        assert not edge_conv.hand_mlp(params, ef, 16, torch.bfloat16)


def _cell_edge_features(r=1000, seed=0):
    """The edge features of the cell-list graph of ``r`` atoms at the
    10,000-atom cell's settings: (r * 48, 6) f32 and the mask."""
    cfg = _cell_cfg(r)
    graph, overflow = scan._build_graph(
        cfg, _grid_window(r, 1, "cpu", seed=seed)[-1], 8.0)
    assert not bool(overflow)
    return graph.edge_feats, graph.mask


def test_the_hand_mlp_plain_form_is_the_kernel_tensor_at_the_cell_widths():
    """1,000 atoms x 48 slots at the cell's widths (6 -> 1024 -> 1024 ->
    4096, bf16): the operator's plain form (``edge_mlp_plain`` layer by
    layer, what the hand-written kernels compute) against
    ``edge_kernel_matrices`` by ``mlp_apply``. Both round the same
    operands at the same points and sum the same f32 products; on the
    CPU they add them in the same order, so the bits are equal."""
    ef, mask = _cell_edge_features()
    assert ef.shape == (48000, 6) and 0 < int(mask.sum()) < 48000
    params = _edge_mlp(6, 1024, 64, seed=3)
    bf16 = torch.bfloat16
    weights = [t for i in range(3) for t in (
        params[f"layer_{i}"]["w"].to(bf16), params[f"layer_{i}"]["b"])]
    before = profiling.counters()
    want = edge_conv.edge_kernel_matrices(params, ef, 64, bf16)
    middle = profiling.counters()
    got = torch.ops.mdno.edge_mlp_stack(ef.to(bf16), *weights)
    after = profiling.counters()
    assert want.dtype == got.dtype == bf16 and want.shape == (48000, 64, 64)
    assert torch.equal(got.reshape(want.shape), want)
    assert middle.get("fused_edge_mlp", 0) == before.get("fused_edge_mlp", 0)
    assert after["fused_edge_mlp"] == middle.get("fused_edge_mlp", 0) + 1


def test_a_training_shaped_call_keeps_its_gradient():
    """Grad on with weights that require it, as every training step
    makes the kernel tensor: the rule says no even on the card, and the
    kernel tensor carries a gradient into every layer."""
    params = _edge_mlp(6, 64, 16, seed=5, requires_grad=True)
    ef = torch.randn(96, 6, generator=torch.Generator().manual_seed(6))
    cuda_like = SimpleNamespace(is_cuda=True, requires_grad=False)
    assert not edge_conv.hand_mlp(params, cuda_like, 16, torch.bfloat16)
    k = edge_conv.edge_kernel_matrices(params, ef, 16, torch.bfloat16)
    assert k.requires_grad and k.dtype == torch.bfloat16
    k.float().square().sum().backward()
    for layer in params.values():
        for t in layer.values():
            assert t.grad is not None and torch.count_nonzero(t.grad) > 0


def test_an_exported_step_keeps_the_hand_mlp_operator(tmp_path, monkeypatch):
    """With the rule forced on the CPU (where the operator runs its plain
    form), a bundle's exported step holds ``mdno::edge_mlp_stack`` and its
    step loop gives the in-process eager loop's bits; each step of each
    counts one call."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.export import (
        load_bundle,
        save_bundle,
    )

    monkeypatch.setattr(edge_conv, "hand_mlp", lambda *a: True)
    cfg = ModelConfig(width=8, ker_width=64, depth=1, window_size=4,
                      num_residues=12, max_edges=128, graph_mode="sparse",
                      predict_delta=True, compute_dtype="bfloat16")
    params = gkn_init(cfg, seed=0)
    aa = torch.randint(0, 20, (12,),
                       generator=torch.Generator().manual_seed(0))
    window = _grid_window(12, 4, "cpu", spacing=3.8)
    bundle = load_bundle(save_bundle(tmp_path / "b", params, cfg, 3,
                                     clip=100.0), device="cpu")
    ops = {str(n.target) for n in bundle.program.graph.nodes
           if n.op == "call_function"}
    assert "mdno.edge_mlp_stack.default" in ops
    before = profiling.counters().get("fused_edge_mlp", 0)
    with torch.no_grad():
        want = make_rollout_fn(cfg, 3, clip=100.0, device="cpu").eager(
            params, aa, window)
    middle = profiling.counters()["fused_edge_mlp"]
    got = bundle.eager(aa, window)
    assert middle == before + 3
    assert profiling.counters()["fused_edge_mlp"] == middle + 3
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- on the card ---------------------------------------------------------

@pytest.mark.gpu
def test_the_bf16_layer_on_the_card_is_the_exact_f32_path(cuda):
    """The 10,000-atom cell's layer widths (D = 48, w = 64) at 256 nodes:
    the bf16 product (``torch.bmm`` with an f32 result) against the
    exact f32 path and the per-slot form on the same rounded operands.
    The product's cotangent is g * inv_deg, which ``_DenseAggregate``
    rounds to bf16 (2**-9 of each term) where the f32 paths take it
    unrounded: dx, an f32 sum rounded to bf16, lies within 2**-8 of its
    terms' magnitudes plus the f32 bound; dK, one product an element
    rounded once to bf16 on each side, within 3 * 2**-9 of the element,
    held to 2**-7."""
    cd = torch.bfloat16
    conv, x, kernels, edges, mask, inv_deg = blocked_layer(
        11, r=256, d=48, w=64, device=cuda, kernel_dtype=cd)
    g = torch.randn(x.shape, device=cuda).to(cd).float()
    before = profiling.counters().get("blocked_bf16_aggregate", 0)
    got = grads(folded_layer, conv, x, kernels, edges, mask, inv_deg, cd, g)
    assert profiling.counters()["blocked_bf16_aggregate"] == before + 1
    with mlp.exact_products():
        exact = grads(folded_layer, conv, x, kernels, edges, mask, inv_deg,
                      cd, g)
        per_slot = grads(per_slot_layer, conv, x, kernels, edges, mask,
                         inv_deg, cd, g)
    assert profiling.counters()["blocked_bf16_aggregate"] == before + 1
    k = 48 * 64
    mags = magnitudes(x, kernels, edges, mask, inv_deg, cd)
    root = (mlp.round_to(x, cd) @ mlp.round_to(conv["root"], cd)).abs()
    dx_mags = dx_magnitudes(conv, x, kernels, edges, mask, inv_deg, cd, g)
    for want in (exact, per_slot):
        assert_close(got[0], want[0], mags + root.double(), k)
        assert_close(got[1], want[1], dx_mags, k, BF16_STEP)
        assert_close(got[2], want[2], want[2].abs().double(), 0,
                     2 * BF16_STEP)


@pytest.mark.gpu
def test_cell_shaped_steps_on_tensor_cores_follow_the_exact_products(cuda):
    """Three steps at the 10,000-atom cell's widths (bf16, dh, the cell
    list at D = 48) on 1,000 atoms: the tensor-core step against the
    same step under ``exact_products()``. The two add the same f32
    products in another order; a last-bit change flips some bf16
    roundings of the next layer's operands, each 2**-8 of an element.
    The frames are held to 1 % of the largest step (the benchmark holds
    this configuration to 6 % against its reference), and each step's
    contact graph must be the same."""
    cfg = _cell_cfg(1000)
    params, aa, window = _step_args(cfg, cuda)
    with torch.no_grad():
        got, _, diag = scan.rollout_scan(params, cfg, aa, window, 3,
                                         collect="both")
        with mlp.exact_products():
            want, _, wdiag = scan.rollout_scan(params, cfg, aa, window, 3,
                                               collect="both")
    assert not bool(diag["edge_overflow"]) and not bool(wdiag["edge_overflow"])
    assert torch.equal(got[1], want[1])
    moved = (want[0] - torch.cat([window[-1:], want[0][:-1]])).abs().max()
    gap = (got[0] - want[0]).abs().max() / moved
    assert moved > 1e-3 and gap <= 0.01, float(gap)


@pytest.mark.gpu
def test_the_hand_mlp_on_the_card_follows_the_exact_products(cuda):
    """The kernel tensor of 1,000 atoms x 48 slots at the cell's widths:
    the hand-written kernels (three launches, one ``fused_edge_mlp``)
    against ``mlp_apply`` under ``exact_products()`` (none). Both round
    h1, h2 and the output to bf16 at the same points and add the same
    f32 products in another order; a last-bit change flips some bf16
    roundings of the next layer's operands, each 2**-8 of an element.
    Held, as the cell-shaped steps are, to 1 % of the largest element."""
    ef, _ = _cell_edge_features()
    ef = ef.to(cuda)
    params = _edge_mlp(6, 1024, 64, seed=3)
    params = {k: {n: t.to(cuda) for n, t in v.items()}
              for k, v in params.items()}
    bf16 = torch.bfloat16
    before = profiling.counters()
    with torch.no_grad():
        got = edge_conv.edge_kernel_matrices(params, ef, 64, bf16)
        middle = profiling.counters()
        with mlp.exact_products():
            want = edge_conv.edge_kernel_matrices(params, ef, 64, bf16)
    after = profiling.counters()
    assert [middle.get(n, 0) - before.get(n, 0) for n in COUNTERS] == \
        [0, 0, 1, 3]
    assert [after.get(n, 0) - middle.get(n, 0) for n in COUNTERS] == \
        [0, 0, 0, 0]
    assert got.dtype == want.dtype == bf16 and got.shape == want.shape
    scale = want.float().abs().max()
    gap = (got.float() - want.float()).abs().max() / scale
    assert scale > 0 and gap <= 0.01, float(gap)


@pytest.mark.gpu
def test_an_eager_cell_step_counts_one_hand_mlp_and_twelve_layers(cuda):
    """A step makes its kernel tensor through the hand-written MLP (one
    ``fused_edge_mlp``, three ``edge_mlp`` launches, no linear layer on
    ``_TensorCoreMatmul``) and runs its 12 blocked layers as bf16
    products; under ``exact_products()`` none of the four counts."""
    cfg = _cell_cfg(600)
    params, aa, window = _step_args(cfg, cuda)
    with torch.no_grad():
        scan.rollout_scan(params, cfg, aa, window, 1)
        before = profiling.counters()
        scan.rollout_scan(params, cfg, aa, window, 2)
        after = profiling.counters()
        with mlp.exact_products():
            scan.rollout_scan(params, cfg, aa, window, 1)
    last = profiling.counters()
    assert [after.get(n, 0) - before.get(n, 0) for n in COUNTERS] == \
        [0, 24, 2, 6]
    assert [last.get(n, 0) - after.get(n, 0) for n in COUNTERS] == \
        [0, 0, 0, 0]


@pytest.mark.gpu
def test_a_bf16_bundle_exported_on_the_card_is_the_in_process_rollout(
        cuda, tmp_path):
    """``torch.export`` of the step keeps the hand-written edge MLP: the
    bundle's step loop runs it (one ``fused_edge_mlp`` a step, as the
    eager loop does) and equals ``make_rollout_fn``'s eager loop to the
    bit."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.export import (
        load_bundle,
        save_bundle,
    )

    cfg = ModelConfig(width=16, ker_width=64, depth=2, window_size=4,
                      num_residues=12, max_edges=128, graph_mode="sparse",
                      predict_delta=True, compute_dtype="bfloat16")
    params = gkn_init(cfg, seed=0, device=cuda)
    aa = torch.randint(0, 20, (12,), device=cuda)
    window = _grid_window(12, 4, cuda, spacing=3.8)
    bundle = load_bundle(save_bundle(tmp_path / "b", params, cfg, 6,
                                     clip=100.0), device=cuda)
    before = profiling.counters()
    with torch.no_grad():
        want = make_rollout_fn(cfg, 6, clip=100.0, device=cuda).eager(
            params, aa, window)
    middle = profiling.counters()
    got = bundle.eager(aa, window)
    after = profiling.counters()
    for a, b in ((before, middle), (middle, after)):
        assert [b.get(n, 0) - a.get(n, 0) for n in COUNTERS] == \
            [0, 0, 6, 18]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
