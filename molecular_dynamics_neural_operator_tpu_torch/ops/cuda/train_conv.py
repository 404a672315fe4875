"""The training conv stack on hand-written Hopper kernels, forward and
backward.

Port of the TPU kernel
``molecular_dynamics_neural_operator_tpu/ops/pallas/train_conv.py``
(``pallas_tied_conv_stack``, a custom VJP whose forward and backward are
one kernel each). ``train_conv`` is a ``torch.autograd.Function`` whose
forward launches ``csrc/train_conv_fwd.cu`` and saves the activation
stack, and whose backward launches ``csrc/train_conv_bwd.cu`` and returns
gradients for x0, kt, root1, bias1, root2 and bias2 (none for the edges,
the mask and the inverse degrees). The kernels take the int32 edge list
and gather and scatter by index; the TPU kernel's one-hot operands, its
tile layout of K and its column permutation are not carried over. Both
run one example on one cluster of the rollout conv stack's frame
(``csrc/conv_stack.cuh``): the edge mask tells them a padded slot (mask
0, src = dst = 0), which they skip, from node 0's real self-loop.

Beside it stands the plain PyTorch version ``train_conv_plain`` with the
same signature: ``ops/conv_stack.tied_conv_stack`` with a mask of ones
(kt is pre-masked), so that a padded slot's dK row is what the TPU kernel
gives it, xs (x) dm of node 0; the caller's ``kt * mask`` zeroes it. The
wrapper runs the plain version for CPU tensors only; for CUDA tensors it
launches the kernels or raises. Each launch is counted under its
kernel's name in the program counters (``utils/profiling.py::count``);
``launch_counts()`` reads them.

The kernels take widths that are a multiple of 8, up to 128 in f32 and 256
in bf16, and shapes whose buffers fit a block's shared memory (their C
``plan``). ``train_conv`` pads any other width with zero columns up to a
multiple of 8: a zero column of x0, the roots, the biases and K stays zero
through every layer and adds exactly zero to every real sum, and the
gradients are cut back to the width. A shape the plan refuses raises
``ValueError`` before any launch, forward or backward.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from molecular_dynamics_neural_operator_tpu_torch.ops.conv_stack import (
    conv_stack_backward,
    conv_stack_forward,
    tied_conv_stack,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._launch import (
    cd_flag,
    check_operand,
    current_stream,
    kernel_fn,
    on_cpu,
    raise_on,
    register_kernel,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import (
    count,
    counters,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
register_kernel("train_conv_fwd", "mdno_train_conv_fwd",
                [_P] * 11 + [_I] * 6 + [_P])
register_kernel("train_conv_bwd", "mdno_train_conv_bwd",
                [_P] * 15 + [_I] * 6 + [_P])
register_kernel("train_conv_fwd_clusters", "mdno_train_conv_fwd_clusters",
                [_I] * 4 + [ctypes.POINTER(ctypes.c_int)],
                source="train_conv_fwd")
register_kernel("train_conv_bwd_clusters", "mdno_train_conv_bwd_clusters",
                [_I] * 5 + [ctypes.POINTER(ctypes.c_int),
                            ctypes.POINTER(ctypes.c_longlong)],
                source="train_conv_bwd")

# the C plans' refusals (cudaError_t)
_BAD_WIDTH, _NO_FIT = 1, 9

_LAUNCHES = ("train_conv_fwd", "train_conv_bwd")


def launch_counts() -> dict:
    now = counters()
    return {name: now.get(name, 0) for name in _LAUNCHES}


def reset_launch_counts() -> None:
    for name, n in launch_counts().items():
        count(name, -n)


def _shapes(x0, kt):
    b, r, w = x0.shape
    e = kt.shape[1]
    if kt.shape != (b, e, w * w):
        raise ValueError(f"kt has shape {tuple(kt.shape)}, expected "
                         f"{(b, e, w * w)}")
    return b, r, w, e


def _ones_mask(kt):
    return torch.ones(kt.shape[:2], device=kt.device)


def _check_mask(mask, kt) -> None:
    """The edge mask is (B, E) f32, 1 for a real slot and 0 for a padded
    one, beside kt (B, E, w*w)."""
    if mask.dtype != torch.float32:
        raise ValueError(f"mask has dtype {mask.dtype}, expected "
                         f"torch.float32")
    if tuple(mask.shape) != tuple(kt.shape[:2]):
        raise ValueError(f"mask has shape {tuple(mask.shape)}, expected "
                         f"{tuple(kt.shape[:2])}")


_plans: dict = {}


def train_conv_plan(num_nodes: int, width: int, max_edges: int, depth: int,
                    cd) -> dict:
    """Both kernels' launch plans at these shapes on the current card, read
    once per shape: ``train_conv_fwd`` and ``train_conv_bwd``, the clusters
    (one an example) the card holds at once, and ``hist``, the floats of
    device memory the backward's CUDA-core body needs an example (0 for the
    tensor-core body). A shape either plan refuses raises ``ValueError``,
    so a caller that asks first launches nothing it cannot finish."""
    key = (num_nodes, width, max_edges, depth, cd,
           torch.cuda.current_device())
    if key in _plans:
        return _plans[key]
    fwd, bwd = ctypes.c_int(0), ctypes.c_int(0)
    hist = ctypes.c_longlong(0)
    for name, rc, n in (
            ("train_conv_fwd", kernel_fn("train_conv_fwd_clusters")(
                num_nodes, width, max_edges, cd_flag(cd), ctypes.byref(fwd)),
             fwd),
            ("train_conv_bwd", kernel_fn("train_conv_bwd_clusters")(
                num_nodes, width, max_edges, depth, cd_flag(cd),
                ctypes.byref(bwd), ctypes.byref(hist)), bwd)):
        if rc == _BAD_WIDTH:
            raise ValueError(
                f"{name} takes a width that is a multiple of 8 and at most "
                f"{512 // torch.empty((), dtype=cd).element_size()} in {cd} "
                f"(train_conv pads other widths to a multiple of 8), got "
                f"{width}")
        if rc == _NO_FIT or (rc == 0 and n.value < 1):
            raise ValueError(
                f"{name}: {num_nodes} nodes, width {width}, {max_edges} edge "
                f"slots, depth {depth} in {cd} need more shared memory than "
                f"a block of this card holds")
        raise_on(rc, f"{name}_clusters")
    _plans[key] = {"train_conv_fwd": fwd.value, "train_conv_bwd": bwd.value,
                   "hist": hist.value}
    return _plans[key]


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """The kernels read kt and the stack 16 bytes at a time: a view that
    starts elsewhere raises; no other kernel takes its place."""
    if t.data_ptr() % 16:
        raise ValueError(f"train_conv: {name} must start on a 16-byte "
                         f"boundary (offset {t.data_ptr() % 16})")


def train_conv_plain(x0, kt, edges, mask, inv_deg, root1, bias1, root2,
                     bias2, depth: int):
    """Plain version of ``train_conv``: the same function through
    ``tied_conv_stack``, differentiable in the same six operands. The mask
    is checked and, kt being pre-masked, computed with as ones."""
    if depth < 1:
        raise ValueError("train_conv requires depth >= 1")
    b, r, w, e = _shapes(x0, kt)
    _check_mask(mask, kt)
    return tied_conv_stack(depth, kt.dtype, x0, kt.reshape(b, e, w, w), edges,
                           _ones_mask(kt), inv_deg, root1, bias1, root2,
                           bias2)


def train_conv_forward_plain(x0, kt, edges, mask, inv_deg, root1, bias1,
                             root2, bias2, depth: int):
    """(out, stack) of the plain forward sweep, as the forward kernel
    writes them."""
    b, r, w, e = _shapes(x0, kt)
    _check_mask(mask, kt)
    return conv_stack_forward(depth, kt.dtype, x0, kt.reshape(b, e, w, w), edges,
                              _ones_mask(kt), inv_deg, root1, bias1, root2,
                              bias2)


def train_conv_backward_plain(g_out, stack, kt, edges, mask, inv_deg, root1,
                              root2, depth: int):
    """(dx0, dkt, droot1, dbias1, droot2, dbias2) of the plain reverse
    sweep, droot and dbias per example, as the backward kernel writes
    them; a padded slot's dkt row is xs (x) dm of node 0."""
    b, e = kt.shape[:2]
    w = stack.shape[-1]
    _check_mask(mask, kt)
    dx, dk, dr1, db1, dr2, db2 = conv_stack_backward(
        depth, kt.dtype, g_out, stack, kt.reshape(b, e, w, w), edges,
        _ones_mask(kt), inv_deg, root1, root2)
    return dx, dk.reshape(kt.shape), dr1, db1, dr2, db2


def train_conv_forward(x0, kt, edges, mask, inv_deg, root1, bias1, root2,
                       bias2, depth: int):
    """Launch the forward kernel: (out (B, R, w), stack (B, 2*depth+1, R, w)),
    both f32. x0 (B, R, w) f32; kt (B, E, w*w) f32 or bf16, pre-masked;
    edges (B, 2, E) int32; mask (B, E) f32, 0 for a padded slot; inv_deg
    (B, R) f32; roots (w, w) and biases (w,) f32 (the roots are rounded to
    kt's dtype here, outside the kernel)."""
    if depth < 1:
        raise ValueError("train_conv requires depth >= 1")
    if on_cpu(x0):
        return train_conv_forward_plain(x0, kt, edges, mask, inv_deg, root1,
                                        bias1, root2, bias2, depth)
    b, r, w, e = _shapes(x0, kt)
    dev, f32, cd = x0.device, torch.float32, kt.dtype
    _check_mask(mask, kt)
    _check_aligned(kt, "kt")
    train_conv_plan(r, w, e, depth, cd)
    out = torch.empty(b, r, w, device=dev)
    stack = torch.empty(b, 2 * depth + 1, r, w, device=dev)
    root1, root2 = root1.to(cd), root2.to(cd)
    args = [
        check_operand(x0, "x0", f32, (b, r, w), dev),
        check_operand(kt, "kt", cd, (b, e, w * w), dev),
        check_operand(edges, "edges", torch.int32, (b, 2, e), dev),
        check_operand(mask, "mask", f32, (b, e), dev),
        check_operand(inv_deg, "inv_deg", f32, (b, r), dev),
        check_operand(root1, "root1", cd, (w, w), dev),
        check_operand(bias1, "bias1", f32, (w,), dev),
        check_operand(root2, "root2", cd, (w, w), dev),
        check_operand(bias2, "bias2", f32, (w,), dev),
        out.data_ptr(), stack.data_ptr(),
        b, r, w, e, depth, cd_flag(cd), current_stream(),
    ]
    raise_on(kernel_fn("train_conv_fwd")(*args), "train_conv_fwd")
    count("train_conv_fwd")
    return out, stack


def train_conv_backward(g_out, stack, kt, edges, mask, inv_deg, root1,
                        root2, depth: int):
    """Launch the backward kernel: (dx0 (B, R, w) f32, dkt like kt, droot1
    (B, w, w), dbias1 (B, w), droot2, dbias2), the last four per example;
    a padded slot's dkt row is xs (x) dm of node 0, as the plain version's."""
    if on_cpu(g_out):
        return train_conv_backward_plain(g_out, stack, kt, edges, mask,
                                         inv_deg, root1, root2, depth)
    b, e = kt.shape[:2]
    _, _, r, w = stack.shape
    dev, f32, cd = g_out.device, torch.float32, kt.dtype
    _check_mask(mask, kt)
    _check_aligned(kt, "kt")
    _check_aligned(stack, "stack")
    hist = torch.empty(b * train_conv_plan(r, w, e, depth, cd)["hist"],
                       device=dev)
    dx0 = torch.empty(b, r, w, device=dev)
    dkt = torch.empty_like(kt)
    droot = [torch.empty(b, w, w, device=dev) for _ in range(2)]
    dbias = [torch.empty(b, w, device=dev) for _ in range(2)]
    root1, root2 = root1.to(cd), root2.to(cd)
    args = [
        check_operand(g_out, "g_out", f32, (b, r, w), dev),
        check_operand(stack, "stack", f32, (b, 2 * depth + 1, r, w), dev),
        check_operand(kt, "kt", cd, (b, e, w * w), dev),
        check_operand(edges, "edges", torch.int32, (b, 2, e), dev),
        check_operand(mask, "mask", f32, (b, e), dev),
        check_operand(inv_deg, "inv_deg", f32, (b, r), dev),
        check_operand(root1, "root1", cd, (w, w), dev),
        check_operand(root2, "root2", cd, (w, w), dev),
        dx0.data_ptr(), dkt.data_ptr(), droot[0].data_ptr(),
        dbias[0].data_ptr(), droot[1].data_ptr(), dbias[1].data_ptr(),
        hist.data_ptr() if hist.numel() else None,
        b, r, w, e, depth, cd_flag(cd), current_stream(),
    ]
    raise_on(kernel_fn("train_conv_bwd")(*args), "train_conv_bwd")
    count("train_conv_bwd")
    return dx0, dkt, droot[0], dbias[0], droot[1], dbias[1]


def _pad_width(x0, kt, root1, bias1, root2, bias2):
    """The operands with zero columns up to a width that is a multiple of
    8 (as they are when it is one already)."""
    b, r, w, e = _shapes(x0, kt)
    p = -w % 8
    if p == 0:
        return x0, kt, root1, bias1, root2, bias2
    square = (0, p, 0, p)
    kt = F.pad(kt.reshape(b, e, w, w), square).reshape(b, e, (w + p) ** 2)
    return (F.pad(x0, (0, p)), kt, F.pad(root1, square), F.pad(bias1, (0, p)),
            F.pad(root2, square), F.pad(bias2, (0, p)))


class _TrainConv(torch.autograd.Function):
    """The kernels at any width: padded to a multiple of 8 on the way in,
    cut back on the way out (see the module's note)."""

    @staticmethod
    def forward(ctx, x0, kt, edges, mask, inv_deg, root1, bias1, root2, bias2,
                depth):
        w = x0.shape[-1]
        x0, kt, root1, bias1, root2, bias2 = _pad_width(x0, kt, root1, bias1,
                                                        root2, bias2)
        out, stack = train_conv_forward(x0, kt, edges, mask, inv_deg, root1,
                                        bias1, root2, bias2, depth)
        ctx.save_for_backward(stack, kt, edges, mask, inv_deg, root1, root2)
        ctx.depth, ctx.width = depth, w
        return out if out.shape[-1] == w else out[..., :w].contiguous()

    @staticmethod
    def backward(ctx, g_out):
        stack, kt, edges, mask, inv_deg, root1, root2 = ctx.saved_tensors
        w, wp = ctx.width, stack.shape[-1]
        g_out = F.pad(g_out, (0, wp - w)).contiguous()
        dx0, dkt, dr1, db1, dr2, db2 = train_conv_backward(
            g_out, stack, kt, edges, mask, inv_deg, root1, root2, ctx.depth)
        if wp != w:
            b, e = kt.shape[:2]
            dx0 = dx0[..., :w]
            dkt = dkt.reshape(b, e, wp, wp)[:, :, :w, :w].reshape(b, e, w * w)
            dr1, dr2 = dr1[:, :w, :w], dr2[:, :w, :w]
            db1, db2 = db1[:, :w], db2[:, :w]
        # per-example partial sums of the shared parameters, added over the
        # batch by one deterministic reduction each
        return (dx0, dkt, None, None, None, dr1.sum(0), db1.sum(0),
                dr2.sum(0), db2.sum(0), None)


def train_conv(x0, kt, edges, mask, inv_deg, root1, bias1, root2, bias2,
               depth: int):
    """Batched tied conv stack: relu(conv1)^depth then relu(conv2)^depth
    against one pre-masked kernel tensor per example. Shapes as
    ``train_conv_forward`` at any width; returns (B, R, w) f32. CUDA
    tensors go through the kernels, forward and backward (a width that is
    not a multiple of 8 padded to one); CPU tensors through the plain
    version."""
    if depth < 1:
        raise ValueError("train_conv requires depth >= 1")
    if on_cpu(x0):
        return train_conv_plain(x0, kt, edges, mask, inv_deg, root1, bias1,
                                root2, bias2, depth)
    return _TrainConv.apply(x0, kt, edges, mask, inv_deg, root1, bias1,
                            root2, bias2, depth)


def train_conv_clusters(num_nodes: int, width: int, max_edges: int,
                        depth: int, cd) -> dict:
    """How many clusters (one an example) of each training kernel the card
    holds at once at these shapes: a batch of B runs in ceil(B / that)
    waves."""
    plan = train_conv_plan(num_nodes, width, max_edges, depth, cd)
    return {name: plan[name] for name in _LAUNCHES}
