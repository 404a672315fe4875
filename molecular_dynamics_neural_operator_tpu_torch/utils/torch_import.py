"""Reference KernelNN checkpoints into the port's parameter tree
(``molecular_dynamics_neural_operator_tpu/utils/torch_import.py``).

Maps the reference's ``state_dict`` layout (``graph_kernel.py:245-275``,
optionally under DataParallel's ``module.`` prefix and the training
script's ``model_state_dict`` wrapper, ``:633-639``) weight for weight:

- ``lstm.weight_ih_l0`` (4h, in) -> transposed ``lstm/w_ih`` (torch packs
  the gates [i, f, g, o], the port's LSTM takes the same order),
- ``lstm_fc`` / ``fc1`` / ``fc2`` Linear weights transposed ((out, in) ->
  (in, out)),
- ``emb.weight`` as it is,
- ``convN.root`` as it is (the reference stores it (in, out) and applies
  ``torch.mm(x, root)``, ``graph_kernel.py:177,206``),
- ``conv1.net.layers.{0,2,4}`` -> ``edge_kernel/layer_{0,1,2}`` (the
  DenseNet puts ReLU modules at the odd indices). conv2 shares conv1's
  net in the reference, so its entries are ignored under
  ``tie_edge_kernel=True`` and become ``edge_kernel2`` otherwise.

The older no-LSTM layout (``bba_analysis.ipynb`` cell 8: embedding, fc1,
one conv stack, fc2) imports into a ``legacy_no_lstm=True`` model. Every
function returns f32 tensors on ``device``, ``cuda`` unless the caller
asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)


def _strip_prefixes(sd: dict) -> dict:
    """Keys without DataParallel's ``module.``; values as numpy arrays."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _t(a: np.ndarray) -> np.ndarray:
    """A (out, in) torch weight as the port's (in, out), row-major."""
    return np.ascontiguousarray(a.T)


def _lin(sd: dict, prefix: str) -> dict:
    return {"w": _t(sd[f"{prefix}.weight"]), "b": sd[f"{prefix}.bias"]}


def _kernel_net(sd: dict, prefix: str) -> dict:
    return {f"layer_{i}": _lin(sd, f"{prefix}.layers.{j}")
            for i, j in enumerate((0, 2, 4))}


def _conv(sd: dict, name: str) -> dict:
    return {"root": sd[f"{name}.root"], "bias": sd[f"{name}.bias"]}


def import_reference_state_dict(sd: dict, cfg, device=None) -> dict:
    """A reference state_dict (tensors or arrays) -> the port's GKN
    parameters."""
    dev = resolve_device(device)
    sd = _strip_prefixes(sd)
    params = {
        "emb": sd["emb.weight"],
        "lstm": {
            "w_ih": _t(sd["lstm.weight_ih_l0"]),
            "w_hh": _t(sd["lstm.weight_hh_l0"]),
            "b_ih": sd["lstm.bias_ih_l0"],
            "b_hh": sd["lstm.bias_hh_l0"],
        },
        "lstm_fc": _lin(sd, "lstm_fc"),
        "fc1": _lin(sd, "fc1"),
        "fc2": _lin(sd, "fc2"),
        "conv1": _conv(sd, "conv1"),
        "conv2": _conv(sd, "conv2"),
        "edge_kernel": _kernel_net(sd, "conv1.net"),
    }
    if not cfg.tie_edge_kernel:
        params["edge_kernel2"] = _kernel_net(sd, "conv2.net")
    return params_from_jax(params, dev)


def is_legacy_state_dict(sd: dict) -> bool:
    """True for the older no-LSTM KernelNN layout: ``conv1.root``
    without ``lstm.weight_ih_l0``."""
    keys = {k[len("module."):] if k.startswith("module.") else k
            for k in sd}
    return "conv1.root" in keys and "lstm.weight_ih_l0" not in keys


def import_legacy_state_dict(sd: dict, cfg, device=None) -> dict:
    """An older no-LSTM KernelNN state_dict -> the parameters of a
    ``ModelConfig(legacy_no_lstm=True)`` model (no lstm, lstm_fc or
    conv2)."""
    dev = resolve_device(device)
    if not getattr(cfg, "legacy_no_lstm", False):
        raise ValueError(
            "this checkpoint is the older no-LSTM KernelNN variant "
            "(bba_analysis.ipynb cell 8); build the model with "
            "ModelConfig(legacy_no_lstm=True, window_size=1)")
    sd = _strip_prefixes(sd)
    return params_from_jax({
        "emb": sd["emb.weight"],
        "fc1": _lin(sd, "fc1"),
        "fc2": _lin(sd, "fc2"),
        "conv1": _conv(sd, "conv1"),
        "edge_kernel": _kernel_net(sd, "conv1.net"),
    }, dev)


def import_reference_checkpoint(path, cfg, device=None) -> dict:
    """Load a reference ``best.pt`` (``torch.save`` of {model_state_dict,
    ...} or a bare state_dict) and convert it, the older no-LSTM layout
    included. The file is unpickled in full (``weights_only=False``, as
    the reference wrote it): load only files you trust."""
    device = resolve_device(device)
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    if is_legacy_state_dict(obj):
        return import_legacy_state_dict(obj, cfg, device)
    return import_reference_state_dict(obj, cfg, device)
