"""Checkpoints in the JAX package's format
(``molecular_dynamics_neural_operator_tpu/utils/checkpoint.py``).

The JAX package saves a pytree as one ``.npz`` whose keys are the leaf
paths joined with ``/`` (``"edge_kernel/layer_0/w"``), with a
``<name>.npz.json`` sidecar holding the keys and the metadata. The port
reads and writes the same files: a parameter tree (nested dicts of
tensors) or a whole ``TrainState``, so a run of either package resumes,
or rolls out, in the other. Parameters are read as f32 (the committed
``tools/bench_ckpt.npz`` stores float16).

A ``TrainState`` is written in the key layout the JAX package's optax
state has for the same optimizer chain, so that package's
``restore_checkpoint(path, like)``, which reads by the template's key
paths, restores a port run unchanged; ``restore_checkpoint`` here reads
that layout back into a port ``TrainState``. ``<A>`` is the Adam state's
prefix, ``<i>`` its index in the chain:

| chain (``OptState.chain``) | keys |
|---|---|
| plain | ``<A>`` = ``.opt_state/1``: ``<A>/.count``, ``<A>/.mu/<leaf>``, ``<A>/.nu/<leaf>``; the schedule's ``.opt_state/2/.count`` |
| ``clip`` (``grad_clip_norm > 0``) | the indices move to 2 and 3 |
| ``skip_nonfinite`` | the chain moves under ``.opt_state/.inner_state/``; beside it ``.opt_state/.notfinite_count``, ``.last_finite``, ``.total_notfinite`` |
| ``accum > 1`` | the chain moves under ``<M>/.inner_opt_state/``, beside it ``<M>/.mini_step``, ``<M>/.gradient_step`` and ``<M>/.acc_grads/<leaf>`` (the running mean of the micro-batch gradients); ``<M>`` is ``.opt_state`` or, with ``skip_nonfinite``, ``.opt_state/.inner_state`` |

Both counts (Adam's and the schedule's) are the port's ``OptState.count``.
``.params/<leaf>`` and ``.step`` (int32) read as they are. ``.rng`` is a
JAX key, uint32[2]; the port's ``TrainState.rng`` is the integer seed of
its noise generator. The port writes the seed ``s`` as
``[s >> 32, s & 0xffffffff]``, which for ``s < 2**32`` is the JAX
package's ``PRNGKey(s)``, and reads a key ``[hi, lo]`` back as
``hi << 32 | lo``: a round trip is exact, and a JAX key becomes a seed
whose noise is the port's own (the two generators differ in any case).

A key that the template needs and the file lacks raises ``KeyError``
naming it, and so does an optimizer key in the file that the template's
chain has no place for: a checkpoint is never filled in silently, and a
resume needs the optimizer chain the run trained with.
``restore_subtree`` reads the parameters alone, out of a TrainState or a
bare-params file, without that chain.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from molecular_dynamics_neural_operator_tpu_torch.device import resolve_device
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    COUNTERS,
    OptState,
    counter,
)
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
)


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


def _int32(t) -> np.int32:
    """A 0-d counter tensor (or int) as the JAX layout's int32 scalar."""
    return np.int32(int(t))


def _opt_prefixes(opt: OptState):
    """(finiteness guard's prefix or None, accumulator's prefix or None,
    Adam's prefix, the schedule's prefix) of the JAX layout of
    ``opt.chain``."""
    top, guard, accum = ".opt_state", None, None
    if opt.chain.skip_nonfinite:
        guard, top = top, f"{top}/.inner_state"
    if opt.chain.accum > 1:
        accum, top = top, f"{top}/.inner_opt_state"
    i = 2 if opt.chain.clip else 1
    return guard, accum, f"{top}/{i}", f"{top}/{i + 1}"


def _train_state_flat(state: TrainState) -> dict:
    """A TrainState as the JAX package's flat keys, in its order."""
    opt = state.opt_state
    guard, accum, adam, sched = _opt_prefixes(opt)
    flat = _flatten(state.params, ".params")
    if guard is not None:
        flat[f"{guard}/.notfinite_count"] = _int32(opt.notfinite_count)
        flat[f"{guard}/.last_finite"] = np.bool_(bool(opt.last_finite))
        flat[f"{guard}/.total_notfinite"] = _int32(opt.total_notfinite)
    if accum is not None:
        flat[f"{accum}/.mini_step"] = _int32(opt.mini_step)
        flat[f"{accum}/.gradient_step"] = _int32(opt.gradient_step)
    flat[f"{adam}/.count"] = _int32(opt.count)
    flat.update(_flatten(opt.mu, f"{adam}/.mu"))
    flat.update(_flatten(opt.nu, f"{adam}/.nu"))
    flat[f"{sched}/.count"] = _int32(opt.count)
    if accum is not None:
        flat.update(_flatten(opt.acc, f"{accum}/.acc_grads"))
    seed = int(state.rng)
    flat[".step"] = np.int32(state.step)
    flat[".rng"] = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    return flat


def save_checkpoint(path, tree, metadata: Optional[dict] = None) -> None:
    """Write ``tree`` to ``path`` (.npz, flat ``/``-joined keys) with a
    ``path``.json sidecar holding the keys and ``metadata``. ``tree`` is
    a parameter tree or a ``TrainState`` (the JAX layout of the module
    docstring)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    is_state = isinstance(tree, TrainState)
    flat = _train_state_flat(tree) if is_state else _flatten(tree)
    np.savez(path, **flat)
    side = {"keys": list(flat), "treedef": "TrainState" if is_state
            else "dict", "metadata": metadata or {}}
    path.with_suffix(path.suffix + ".json").write_text(
        json.dumps(side, indent=2))


def restore_checkpoint(path, like: TrainState):
    """(state, metadata): a ``TrainState`` checkpoint of either package
    restored into the structure, optimizer chain and device of the
    template ``like`` (e.g. ``create_train_state``'s state). Raises
    ``KeyError`` for a key one side has and the other lacks, and
    ``ValueError`` for a leaf whose shape differs from the template's."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(".npz")
    side_path = path.with_suffix(path.suffix + ".json")
    side = json.loads(side_path.read_text()) if side_path.exists() else {}
    opt = like.opt_state
    guard, accum, adam, sched = _opt_prefixes(opt)
    with np.load(path) as data:
        used = set()

        def get(key):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            used.add(key)
            return data[key]

        def tree(node, prefix):
            if isinstance(node, dict):
                return {k: tree(v, f"{prefix}/{k}") for k, v in node.items()}
            arr = get(prefix)
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(
                    f"checkpoint leaf {prefix} has shape {tuple(arr.shape)} "
                    f"but the template expects {tuple(node.shape)}: model "
                    "config mismatch")
            return torch.as_tensor(np.array(arr, dtype=np.float32),
                                   device=node.device)

        params = tree(like.params, ".params")
        dev = opt.count.device

        def count_of(key, dtype=torch.int32):
            return counter(get(key).item(), dev, dtype)

        count = int(get(f"{adam}/.count"))
        if int(get(f"{sched}/.count")) != count:
            raise ValueError(f"{sched}/.count differs from {adam}/.count")
        # counters of its own: an update writes into them
        new = opt._replace(**{k: getattr(opt, k).clone() for k in COUNTERS})
        new = new._replace(
            count=count_of(f"{adam}/.count"), mu=tree(opt.mu, f"{adam}/.mu"),
            nu=tree(opt.nu, f"{adam}/.nu"))
        if guard is not None:
            new = new._replace(
                notfinite_count=count_of(f"{guard}/.notfinite_count"),
                last_finite=count_of(f"{guard}/.last_finite", torch.bool),
                total_notfinite=count_of(f"{guard}/.total_notfinite"))
        if accum is not None:
            new = new._replace(
                mini_step=count_of(f"{accum}/.mini_step"),
                gradient_step=count_of(f"{accum}/.gradient_step"),
                acc=tree(opt.acc, f"{accum}/.acc_grads"))
        step = int(get(".step"))
        key = np.asarray(get(".rng")).astype(np.uint64).reshape(-1)
        if key.shape != (2,):
            raise ValueError(f".rng has shape {key.shape}, expected (2,)")
        rng = int(key[0]) << 32 | int(key[1])
        extra = sorted(k for k in data.files
                       if k.startswith(".opt_state/") and k not in used)
        if extra:
            raise KeyError(
                f"checkpoint leaf {extra[0]} (and {len(extra) - 1} more) "
                "has no place in the template's optimizer chain "
                f"{opt.chain}: resume with the chain the run trained with")
    return TrainState(params, new, step, rng), side.get("metadata", {})


class BestCheckpointer:
    """Tracks the best validation loss and writes ``best.npz`` on
    improvement, plus ``last.npz`` every ``save_last_every`` epochs for
    resume, as the JAX package's.

    With ``resume=True`` ``best_loss`` is seeded from an existing
    ``best.npz.json``, so a worse epoch after a restart cannot overwrite
    the run's best; a fresh run reusing a run directory (``resume=False``)
    treats a stale ``best.npz`` as beatable."""

    def __init__(self, run_dir, save_last_every: int = 1,
                 resume: bool = False):
        self.run_dir = Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.best_loss = float("inf")
        self.save_last_every = max(1, save_last_every)
        if resume:
            side = self.run_dir / "best.npz.json"
            if side.exists():
                try:
                    meta = json.loads(side.read_text()).get("metadata", {})
                    self.best_loss = float(
                        meta.get("valid_loss", float("inf")))
                except (ValueError, OSError):
                    pass

    def update(self, epoch: int, valid_loss: float, state) -> bool:
        """Returns True if this epoch was the new best."""
        improved = valid_loss < self.best_loss
        meta = {"epoch": epoch, "valid_loss": float(valid_loss)}
        if improved:
            self.best_loss = float(valid_loss)
            save_checkpoint(self.run_dir / "best.npz", state, meta)
        if epoch % self.save_last_every == 0:
            save_checkpoint(self.run_dir / "last.npz", state, meta)
        return improved
