"""The port's GKN parameters in the reference (PyTorch) state_dict layout
(``molecular_dynamics_neural_operator_tpu/utils/torch_export.py``).

The exact inverse of ``utils/torch_import.py``: the key set of the
reference ``KernelNN``'s ``state_dict()`` (``graph_kernel.py:245-275``),
so a model trained by the port loads into the reference's model (or
``tools/torch_replica.py``) and the two are compared rollout against
rollout on the same weights. Linear, LSTM and kernel-MLP weights
transpose to torch's (out, in); ``convN.root`` stays (in, out);
``conv2.net.*`` repeats ``conv1.net.*`` when the edge kernel is tied
(the reference shares one DenseNet between both conv stacks, so both key
prefixes exist). A ``legacy_no_lstm`` model exports the older layout:
embedding, fc1, one conv stack, fc2.
"""

from __future__ import annotations

import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32).clone()


def _lin(prefix: str, node) -> dict:
    return {f"{prefix}.weight": _t(node["w"]).T.contiguous(),
            f"{prefix}.bias": _t(node["b"])}


def _kernel_net(prefix: str, node) -> dict:
    out = {}
    for i, j in enumerate((0, 2, 4)):
        out.update(_lin(f"{prefix}.layers.{j}", node[f"layer_{i}"]))
    return out


def _conv(name: str, node) -> dict:
    return {f"{name}.root": _t(node["root"]), f"{name}.bias": _t(node["bias"])}


def export_reference_state_dict(params, cfg) -> dict:
    """GKN parameters -> a state_dict of CPU f32 tensors in the
    reference's key layout."""
    if getattr(cfg, "legacy_no_lstm", False):
        return {"emb.weight": _t(params["emb"]), **_lin("fc1", params["fc1"]),
                **_conv("conv1", params["conv1"]),
                **_kernel_net("conv1.net", params["edge_kernel"]),
                **_lin("fc2", params["fc2"])}
    lstm = params["lstm"]
    sd = {
        "emb.weight": _t(params["emb"]),
        "lstm.weight_ih_l0": _t(lstm["w_ih"]).T.contiguous(),
        "lstm.weight_hh_l0": _t(lstm["w_hh"]).T.contiguous(),
        "lstm.bias_ih_l0": _t(lstm["b_ih"]),
        "lstm.bias_hh_l0": _t(lstm["b_hh"]),
        **_lin("lstm_fc", params["lstm_fc"]),
        **_lin("fc1", params["fc1"]),
        **_lin("fc2", params["fc2"]),
        **_conv("conv1", params["conv1"]),
        **_conv("conv2", params["conv2"]),
        **_kernel_net("conv1.net", params["edge_kernel"]),
    }
    sd.update(_kernel_net("conv2.net",
                          params.get("edge_kernel2", params["edge_kernel"])))
    return sd


def save_reference_checkpoint(path, params, cfg, epoch: int = 0) -> None:
    """Write a reference-compatible ``best.pt`` ({epoch,
    model_state_dict}), which the reference's notebook loads
    (``bba_analysis.ipynb`` cells 6-7)."""
    torch.save({"epoch": epoch,
                "model_state_dict": export_reference_state_dict(params, cfg)},
               path)
