"""Parameter saving and loading (``molecular_dynamics_neural_operator_tpu/utils/checkpoint.py``).

The JAX package saves a pytree as one ``.npz`` whose keys are the leaf
paths joined with ``/`` (``"edge_kernel/layer_0/w"``). The port reads the
same files into nested dicts of f32 tensors. Every leaf is cast to f32 on
load, as the JAX package's restore casts to its f32 template: the
committed ``tools/bench_ckpt.npz`` stores its leaves as float16.
``save_checkpoint`` writes that format with the JSON sidecar the JAX
package's ``restore_checkpoint`` reads, so a model trained by either
package is rolled out by the other. ``restore_subtree`` reads the
parameters out of a bare-params npz or out of a TrainState npz of the JAX
package into a template's structure. Parameters only: the optimizer state
and ``BestCheckpointer`` are not ported yet.
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


def restore_subtree(path, like, prefix: str, device=None):
    """(tree, metadata): the leaves stored under ``prefix`` restored into
    the structure of the template ``like`` (nested dicts of tensors, e.g.
    ``gkn_init(cfg)``), as f32 tensors on ``device``.

    ``restore_subtree(path, gkn_init(cfg), ".params")`` reads the
    parameters of a TrainState checkpoint (keys ``.params/fc1/w``) without
    rebuilding the optimizer the run used, and equally a params-only
    checkpoint with bare keys (``fc1/w``, e.g. ``tools/bench_ckpt.npz``).
    A leaf whose shape differs from the template's is named in the error:
    the model flags must match training."""
    dev = resolve_device(device)
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    side_path = path.with_suffix(path.suffix + ".json")
    side = json.loads(side_path.read_text()) if side_path.exists() else {}

    def restore(node, bare: str, data):
        if isinstance(node, dict):
            return {k: restore(v, f"{bare}/{k}" if bare else str(k), data)
                    for k, v in node.items()}
        key = f"{prefix}/{bare}" if bare else prefix
        if key not in data:
            if not bare or bare not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            key = bare
        arr = data[key]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(
                f"checkpoint leaf {key} has shape {tuple(arr.shape)} but "
                f"the template expects {tuple(node.shape)}: model config "
                "mismatch (width/depth/electrostatics flags must match "
                "training)")
        return torch.as_tensor(np.array(arr, dtype=np.float32), device=dev)

    with np.load(path) as data:
        tree = restore(like, "", data)
    return tree, side.get("metadata", {})


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
