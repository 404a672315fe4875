"""Plain PyTorch version of a stage that several kernels share: the
2*depth tied conv layers. Built from the port's XLA-path modules, so it
rounds where ``gkn_apply_single`` rounds. The plain edge-MLP layer is
``ops/cuda/edge_mlp.py::edge_mlp_plain``."""

from __future__ import annotations

import torch

from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
    edge_conv_sparse,
)


def conv_stack_plain(x0, kmat, edges, mask, inv_deg, conv1, conv2,
                     depth: int):
    """2*depth tied conv layers with ReLU: x0 (S, R, w) f32, kmat
    (S*E, w*w) in the compute dtype, edges (S, 2, E), mask (S, E),
    inv_deg (S, R); conv1/conv2 hold ``root`` and ``bias``. Returns
    (S, R, w) f32."""
    s, e = mask.shape
    w = x0.shape[-1]
    kernels = kmat.reshape(s, e, w, w)
    x = x0
    for layer in range(2 * depth):
        conv = conv1 if layer < depth else conv2
        x = torch.relu(edge_conv_sparse(conv, x, kernels, edges, mask,
                                        inv_deg, "onehot", kmat.dtype))
    return x
