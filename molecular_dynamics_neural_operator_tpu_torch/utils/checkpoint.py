"""Parameter saving and loading (``molecular_dynamics_neural_operator_tpu/utils/checkpoint.py``).

The JAX package saves a pytree as one ``.npz`` whose keys are the leaf
paths joined with ``/`` (``"edge_kernel/layer_0/w"``). The port reads the
same files into nested dicts of f32 tensors. Every leaf is cast to f32 on
load, as the JAX package's restore casts to its f32 template: the
committed ``tools/bench_ckpt.npz`` stores its leaves as float16.
``save_checkpoint`` writes that format with the JSON sidecar the JAX
package's ``restore_checkpoint`` reads, so a model trained by either
package is rolled out by the other. Parameters only: the optimizer state,
``restore_subtree`` and ``BestCheckpointer`` are not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device


def params_from_jax(tree, device=None):
    """Nested dict of array-likes (numpy or JAX arrays, as the JAX
    package's params) -> the same nesting of f32 tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, dtype=np.float32), device=dev)


def load_params_npz(path, device=None):
    """Read a flat ``/``-keyed npz into the nested parameter dict."""
    nested: dict = {}
    with np.load(Path(path)) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = nested
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params_from_jax(nested, device)


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dict of tensors -> {"a/b/c": numpy array}, in tree order."""
    if not isinstance(tree, dict):
        return {prefix: tree.detach().cpu().numpy()}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def save_checkpoint(path, tree, metadata: Optional[dict] = None) -> None:
    """Write the parameter tree to ``path`` (.npz, flat ``/``-joined keys)
    with a ``path``.json sidecar holding the keys and ``metadata``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    np.savez(path, **flat)
    side = {"keys": list(flat), "treedef": "dict",
            "metadata": metadata or {}}
    path.with_suffix(path.suffix + ".json").write_text(
        json.dumps(side, indent=2))
