"""The port's tied conv stack (ops/conv_stack.py) and the plain version of
its training kernel (ops/cuda/train_conv.py) against the JAX package's
``tied_conv_stack`` and ``pallas_tied_conv_stack`` (interpret mode), on
the CPU. The CUDA kernels themselves are held against the plain version on
the card by ``tests/test_torch_port_kernels.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.ops.conv_stack import (
    tied_conv_stack as jax_tied_conv_stack,
)
from molecular_dynamics_neural_operator_tpu.ops.pallas import (
    train_conv as jtc,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.conv_stack import (
    tied_conv_stack,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
    train_conv as tc,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    edge_conv_sparse,
    sparse_inv_degree,
)

R, W, E, DEPTH = 12, 16, 128, 2
# x0, kt, root1, bias1, root2, bias2 among train_conv's operands
GRAD_SLOTS = (0, 1, 5, 6, 7, 8)
# f32: sums over <= 16 products, <= 12 edges per node and 4 layers taken in
# another order by torch than by XLA, and by the TPU kernel's node-first
# reduction; the bound the JAX package's own kernel test uses
RTOL, ATOL = 2e-4, 1e-5
NAMES = ("x0", "k", "root1", "bias1", "root2", "bias2")


def _inputs(seed, batch=None, real_edges=90, pads="end"):
    """Seeded operands with ``E - real_edges`` padded slots (src = dst = 0,
    mask 0): at the end, as the datasets pad, or (``pads="scattered"``) in
    random slots; ``pads="none"`` makes every slot real."""
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    edges = rng.integers(0, R, size=lead + (2, E)).astype(np.int32)
    mask = np.zeros(lead + (E,), np.float32)
    mask[..., :real_edges] = 1.0
    if pads == "scattered":
        mask = mask[..., rng.permutation(E)]
    elif pads == "none":
        mask[...] = 1.0
    edges = (edges * mask[..., None, :].astype(np.int32))
    bound = 1.0 / np.sqrt(W)
    return dict(
        x0=rng.normal(size=lead + (R, W)).astype(np.float32),
        k=(rng.normal(size=lead + (E, W, W)) * 0.3).astype(np.float32),
        edges=edges, mask=mask,
        root1=rng.uniform(-bound, bound, (W, W)).astype(np.float32),
        bias1=rng.uniform(-bound, bound, W).astype(np.float32),
        root2=rng.uniform(-bound, bound, (W, W)).astype(np.float32),
        bias2=rng.uniform(-bound, bound, W).astype(np.float32),
        g_out=rng.normal(size=lead + (R, W)).astype(np.float32),
    )


def _inv_deg(d):
    return sparse_inv_degree(torch.as_tensor(d["edges"]),
                             torch.as_tensor(d["mask"]), R)


def _leaves(d):
    return {n: torch.as_tensor(d[n]).requires_grad_(True) for n in NAMES}


def _port_stack(d, t, cd=torch.float32):
    return tied_conv_stack(DEPTH, cd, t["x0"], t["k"].to(cd),
                           torch.as_tensor(d["edges"]),
                           torch.as_tensor(d["mask"]), _inv_deg(d),
                           t["root1"], t["bias1"], t["root2"], t["bias2"])


def _jax_stack_single(d, cd=jnp.float32):
    """(out, grads) of the JAX tied_conv_stack on one example."""
    nodes = jnp.arange(R)
    g1h = (jnp.asarray(d["edges"][0])[:, None] == nodes).astype(cd)
    d1h = (jnp.asarray(d["edges"][1])[:, None] == nodes).astype(cd)
    inv_deg = jnp.asarray(_inv_deg(d).numpy())

    def fn(x0, k, root1, bias1, root2, bias2):
        out = jax_tied_conv_stack(DEPTH, cd, x0, k.astype(cd), g1h, d1h,
                                  jnp.asarray(d["mask"]), inv_deg, root1,
                                  bias1, root2, bias2)
        return jnp.sum(out * jnp.asarray(d["g_out"])), out

    args = [jnp.asarray(d[n]) for n in NAMES]
    (_, out), grads = jax.value_and_grad(fn, argnums=tuple(range(6)),
                                         has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_tied_conv_stack_matches_jax_output_and_all_six_gradients():
    d = _inputs(0)
    want, want_grads = _jax_stack_single(d)
    t = _leaves(d)
    out = _port_stack(d, t)
    (out * torch.as_tensor(d["g_out"])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, RTOL, ATOL)
    for name, g in zip(NAMES, want_grads):
        np.testing.assert_allclose(t[name].grad.numpy(), g, RTOL, ATOL,
                                   err_msg=name)
    # a padded slot's dK row is zero here: the stack applies the mask
    assert not t["k"].grad[100:].any()


def test_tied_conv_stack_matches_autograd_through_the_per_layer_loop():
    d = _inputs(1, batch=3)
    t, u = _leaves(d), _leaves(d)
    out = _port_stack(d, t)
    x = u["x0"]
    edges, mask = torch.as_tensor(d["edges"]), torch.as_tensor(d["mask"])
    for layer in range(2 * DEPTH):
        conv = ({"root": u["root1"], "bias": u["bias1"]} if layer < DEPTH
                else {"root": u["root2"], "bias": u["bias2"]})
        x = torch.relu(edge_conv_sparse(conv, x, u["k"], edges, mask,
                                        _inv_deg(d)))
    # the forward is the same arithmetic in the same order
    assert torch.equal(out, x)
    g_out = torch.as_tensor(d["g_out"])
    (out * g_out).sum().backward()
    (x * g_out).sum().backward()
    for name in NAMES:
        np.testing.assert_allclose(t[name].grad.numpy(), u[name].grad.numpy(),
                                   RTOL, ATOL, err_msg=name)


def test_tied_conv_stack_bf16_rounds_where_jax_rounds():
    """bf16: both round x, the messages, dz, dm and dxs to bf16 and sum in
    f32; a sum taken in another order may land on the other side of a
    rounding boundary, one bf16 unit (2^-8) of that value, so 2^-6 of the
    tensor's scale over 4 layers."""
    d = _inputs(2)
    want, want_grads = _jax_stack_single(d, jnp.bfloat16)
    t = _leaves(d)
    out = _port_stack(d, t, torch.bfloat16)
    (out * torch.as_tensor(d["g_out"])).sum().backward()
    for name, got, ref in [("out", out.detach().numpy(), want)] + [
            (n, t[n].grad.numpy(), g) for n, g in zip(NAMES, want_grads)]:
        scale = np.abs(ref).max()
        assert np.abs(got - ref.astype(np.float32)).max() <= scale * 2.0 ** -6, name


def _pallas(d, cd_str="float32"):
    """(out, stack, vjp) of pallas_tied_conv_stack in interpret mode on a
    batch, with K in the kernel's tile layout."""
    cd = jnp.float32 if cd_str == "float32" else jnp.bfloat16
    b = d["x0"].shape[0]
    perm = jtc.kernel_permutation(W)
    nodes = jnp.arange(R)
    edges = jnp.asarray(d["edges"])
    g1h = (edges[:, 0, :, None] == nodes).astype(cd)
    d1h = (edges[:, 1, :, None] == nodes).astype(cd)
    inv_deg = jnp.asarray(_inv_deg(d).numpy())[..., None]
    kt = (jnp.asarray(d["k"]).reshape(b, E, W * W)
          * jnp.asarray(d["mask"])[..., None]).astype(cd)

    def fn(x0, kt, root1, bias1, root2, bias2):
        return jtc.pallas_tied_conv_stack(
            DEPTH, cd_str, True, True, x0, kt[..., perm], g1h, d1h, inv_deg,
            root1, bias1, root2, bias2)

    args = [jnp.asarray(d["x0"]), kt] + [jnp.asarray(d[n]) for n in NAMES[2:]]
    out, vjp = jax.vjp(fn, *args)
    _, res = jtc._fwd(DEPTH, cd_str, True, True, args[0], kt[..., perm], g1h,
                      d1h, inv_deg, *args[2:])
    return np.asarray(out), np.asarray(res[0]), vjp(jnp.asarray(d["g_out"]))


def _plain_operands(d, cd=torch.float32):
    """(x0, kt, edges, mask, inv_deg, root1, bias1, root2, bias2), kt
    pre-masked, as ``train_conv`` takes them."""
    b = d["x0"].shape[0]
    kt = (torch.as_tensor(d["k"]).reshape(b, E, W * W)
          * torch.as_tensor(d["mask"])[..., None]).to(cd)
    return (torch.as_tensor(d["x0"]), kt, torch.as_tensor(d["edges"]),
            torch.as_tensor(d["mask"]), _inv_deg(d),
            *(torch.as_tensor(d[n]) for n in NAMES[2:]))


@pytest.mark.parametrize("pads", ["end", "scattered", "none"])
def test_train_conv_plain_matches_the_pallas_kernel_in_interpret_mode(pads):
    d = _inputs(3, batch=5, pads=pads)
    want_out, want_stack, want_grads = _pallas(d)
    ops = _plain_operands(d)
    out, stack = tc.train_conv_forward(*ops, DEPTH)  # CPU: the plain version
    np.testing.assert_allclose(out.numpy(), want_out, RTOL, ATOL)
    np.testing.assert_allclose(stack.numpy(), want_stack, RTOL, ATOL)
    x0, kt, edges, mask, inv_deg, root1, _, root2, _ = ops
    got = tc.train_conv_backward(torch.as_tensor(d["g_out"]), stack, kt,
                                 edges, mask, inv_deg, root1, root2, DEPTH)
    dx0, dkt, dr1, db1, dr2, db2 = got
    assert dr1.shape == (5, W, W) and db1.shape == (5, W)
    for name, g, ref in zip(
            ("dx0", "dkt", "droot1", "dbias1", "droot2", "dbias2"),
            (dx0, dkt, dr1.sum(0), db1.sum(0), dr2.sum(0), db2.sum(0)),
            want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), RTOL, ATOL,
                                   err_msg=name)
    # kt is pre-masked and the mask only marks padded slots: their dK rows
    # are xs (x) dm of node 0, as the TPU kernel gives them
    padded = mask == 0
    if pads == "none":
        assert not padded.any()
    else:
        assert dkt[padded].abs().max() > 0


def test_train_conv_on_cpu_tensors_is_the_plain_version_under_autograd():
    d = _inputs(4, batch=2)
    _, _, want_grads = _pallas(d)
    tc.reset_launch_counts()
    ops = [t.clone().requires_grad_(i in GRAD_SLOTS)
           for i, t in enumerate(_plain_operands(d))]
    out = tc.train_conv(*ops, DEPTH)
    (out * torch.as_tensor(d["g_out"])).sum().backward()
    for i, ref in zip(GRAD_SLOTS, want_grads):
        np.testing.assert_allclose(ops[i].grad.numpy(), np.asarray(ref),
                                   RTOL, ATOL)
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}


def test_train_conv_plain_bf16_against_the_pallas_kernel():
    """bf16: the TPU body rounds every product x * K and the per-node
    partial sums to bf16 where the port rounds the summed message, so the
    two differ by a few bf16 units (2^-8 each) per layer: 2^-4 of each
    tensor's scale over 4 layers and the reverse sweep."""
    d = _inputs(5, batch=3)
    want_out, want_stack, want_grads = _pallas(d, "bfloat16")
    ops = _plain_operands(d, torch.bfloat16)
    out, stack = tc.train_conv_forward(*ops, DEPTH)
    x0, kt, edges, mask, inv_deg, root1, _, root2, _ = ops
    got = tc.train_conv_backward(torch.as_tensor(d["g_out"]), stack, kt,
                                 edges, mask, inv_deg, root1, root2, DEPTH)
    assert got[1].dtype == torch.bfloat16
    pairs = [("out", out, want_out), ("stack", stack, want_stack),
             ("dx0", got[0], want_grads[0]), ("dkt", got[1], want_grads[1])]
    pairs += [(n, g.sum(0), r) for n, g, r in zip(
        ("droot1", "dbias1", "droot2", "dbias2"), got[2:], want_grads[2:])]
    for name, g, ref in pairs:
        ref = np.asarray(ref).astype(np.float32)
        err = np.abs(g.float().numpy() - ref).max()
        assert err <= np.abs(ref).max() * 2.0 ** -4, (name, err)


def test_train_conv_refuses_depth_zero_and_wrong_shapes():
    ops = _plain_operands(_inputs(6, batch=2))
    with pytest.raises(ValueError, match="depth >= 1"):
        tc.train_conv(*ops, 0)
    with pytest.raises(ValueError, match="depth >= 1"):
        tc.train_conv_plain(*ops, 0)
    bad = list(ops)
    bad[1] = bad[1][:, :, :-1]
    with pytest.raises(ValueError, match="kt has shape"):
        tc.train_conv(*bad, DEPTH)
    with pytest.raises(ValueError, match="no kernel"):
        tc.train_conv(*(t.to("meta") for t in ops), DEPTH)


@pytest.mark.parametrize("pads", ["end", "none"])
def test_train_conv_with_the_mask_equals_the_plain_version_on_cpu(pads):
    """``train_conv`` on CPU tensors, mask operand and all, gives the plain
    version's output and all six gradients, padded dK rows included."""
    d = _inputs(7, batch=3, pads=pads)
    g_out = torch.as_tensor(d["g_out"])
    got = [t.clone().requires_grad_(i in GRAD_SLOTS)
           for i, t in enumerate(_plain_operands(d))]
    ref = [t.clone().requires_grad_(i in GRAD_SLOTS)
           for i, t in enumerate(_plain_operands(d))]
    out = tc.train_conv(*got, DEPTH)
    want = tc.train_conv_plain(*ref, DEPTH)
    (out * g_out).sum().backward()
    (want * g_out).sum().backward()
    assert torch.equal(out, want)
    for i in GRAD_SLOTS:
        assert torch.equal(got[i].grad, ref[i].grad), i
    padded = torch.as_tensor(d["mask"]) == 0
    assert bool(padded.any()) == (pads == "end")


def test_train_conv_refuses_a_mask_of_the_wrong_shape_or_dtype():
    ops = _plain_operands(_inputs(8, batch=2))
    x0, kt, edges, mask, inv_deg, root1, _, root2, _ = ops
    g_out = torch.zeros_like(x0)
    stack = torch.zeros(2, 2 * DEPTH + 1, R, W)
    for bad, match in ((mask[:, :-1], "mask has shape"),
                       (mask[:1], "mask has shape"),
                       (mask.double(), "mask has dtype"),
                       (mask.bool(), "mask has dtype")):
        args = list(ops)
        args[3] = bad
        for fn in (tc.train_conv, tc.train_conv_plain, tc.train_conv_forward):
            with pytest.raises(ValueError, match=match):
                fn(*args, DEPTH)
        with pytest.raises(ValueError, match=match):
            tc.train_conv_backward(g_out, stack, kt, edges, bad, inv_deg,
                                   root1, root2, DEPTH)


def _operands_at_width(seed, width, batch=3, real_edges=90):
    """Seeded ``train_conv`` operands (kt pre-masked) at any width."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, R, size=(batch, 2, E)).astype(np.int32)
    mask = np.zeros((batch, E), np.float32)
    mask[:, :real_edges] = 1.0
    edges = edges * mask[:, None, :].astype(np.int32)
    bound = 1.0 / np.sqrt(width)
    kt = (rng.normal(size=(batch, E, width * width)) * 0.3).astype(np.float32)
    kt = kt * mask[..., None]
    d = dict(edges=edges, mask=mask)
    return [torch.as_tensor(rng.normal(size=(batch, R, width))
                            .astype(np.float32)),
            torch.as_tensor(kt), torch.as_tensor(edges),
            torch.as_tensor(mask), _inv_deg(d),
            *(torch.as_tensor(rng.uniform(-bound, bound, shape)
                              .astype(np.float32))
              for shape in ((width, width), (width,)) * 2)]


@pytest.mark.parametrize("width", [12, 20, 60])
def test_width_padded_to_a_multiple_of_8_gives_the_unpadded_result(width):
    """On the card ``train_conv`` pads a width that is not a multiple of 8
    with zero columns of x0, K, the roots and the biases, and cuts the
    output and gradients back (``_TrainConv``). Through the plain versions
    on CPU tensors that path gives the unpadded output and all six
    gradients: a zero column stays zero and adds exactly zero to every
    real sum, so only the order of f32 sums may differ."""
    g_out = torch.as_tensor(np.random.default_rng(1).normal(
        size=(3, R, width)).astype(np.float32))
    got = [t.requires_grad_(i in GRAD_SLOTS)
           for i, t in enumerate(_operands_at_width(9, width))]
    ref = [t.detach().clone().requires_grad_(i in GRAD_SLOTS)
           for i, t in enumerate(got)]
    tc.reset_launch_counts()
    out = tc._TrainConv.apply(*got, DEPTH)
    want = tc.train_conv_plain(*ref, DEPTH)
    assert out.shape == want.shape == (3, R, width)
    (out * g_out).sum().backward()
    (want * g_out).sum().backward()

    def err(a, b):  # of b's scale: a few f32 units of the largest value
        return ((a - b).abs().max() / b.abs().max().clamp(min=1.0)).item()

    assert err(out.detach(), want.detach()) <= 1e-6
    for i in GRAD_SLOTS:
        assert got[i].grad.shape == ref[i].grad.shape, i
        assert err(got[i].grad, ref[i].grad) <= 1e-6, i
    assert tc.launch_counts() == {"train_conv_fwd": 0, "train_conv_bwd": 0}
