"""Serving bundles (``molecular_dynamics_neural_operator_tpu/serving/export.py``):
trace the rollout once, ship a self-contained directory.

A bundle is a directory:

    bundle/
      rollout.pt2        a ``torch.export`` program of ONE rollout step
      params.npz         weights (``utils/checkpoint.py``'s flat npz)
      bundle.json        the config, the rollout signature, provenance

The program is one step, not the whole rollout: exporting the rollout
would unroll its Python step loop into the graph (about 650 nodes a step
at the flagship width, so a 100-step signature would take over a minute
to export and load). GKN: ``(params, aa (R,), window (T, R, 3) or
(C, T, R, 3)) -> (window', collected_t, overflow_t)``, where
``collected_t`` is the step's coordinates, its contact map or both, as
``collect`` asks. FNO: ``(params, channels (R, R, T)) -> channels'``.
``ServingBundle.__call__`` runs the step ``num_steps`` times and returns
what ``rollout/scan.py::make_rollout_fn`` returns (``fno_rollout_scan``
for the FNO): the collected outputs stacked on the step axis, the final
window, and ``{"edge_overflow": ...}``, the steps' flags OR-ed. With
``stream_chunk=C`` the program is exported at C streams and the bundle
runs the chunks in sequence, as ``rollout_scan_chunked`` does. On the
card the loop replays CUDA graphs of the step, so the whole rollout runs
as the JAX bundle's one program does, without Python between the steps;
``ServingBundle.eager`` calls the step from Python, the graphs' oracle.

The parameters are inputs of the program, not constants baked into it:
``bundle(aa, window, params=other)`` serves another checkpoint of the
same shapes without a new export. ``bundle.json`` has the JAX bundle's
keys (``format_version``, ``operator``, ``model_config``, ``rollout``,
``platforms``), with ``torch_version`` in place of ``jax_version`` and
the device the program was traced on (``traced_on``); the JAX package's
``configs._from_dict`` reads its ``model_config``.

``platforms`` names devices, not XLA backends: ``cpu`` and ``cuda``.
``export_rollout`` traces on the device of the parameters; the bundle
runs on any device type it names (by default the one it was traced on)
and ``load_bundle`` refuses any other. A program traced on one device is
moved to another by ``torch.export.passes.move_to_device_pass``, which
rewrites the devices the trace baked into the graph; so is a program
whose tensor constants lie on another device than the bundle's.

The two packages' programs do not cross: the port cannot read a JAX
``rollout.jaxexport`` (serialized StableHLO), and the JAX package cannot
read a ``rollout.pt2``. The weights and the config do cross, both ways.

Refused as in the JAX package: ``conv_impl="pallas"`` (the hand-written
kernels are ctypes calls, which an exported program cannot hold; they
serve in process, as the Pallas kernels do), an FNO with ``streams`` > 0,
and a ``format_version`` other than this build's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Any, Optional, Sequence

import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import (
    FNOConfig,
    ModelConfig,
    _from_dict,
)
from molecular_dynamics_neural_operator_tpu_torch.device import (
    device_of,
    resolve_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
    fno_init,
    fno_rollout_step,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    StepGraphs,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
    COLLECT_MODES,
    _cat_parts,
    _step,
    collected,
    collected_outputs,
    stacked_outputs,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    tree_leaves,
    tree_map,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    restore_subtree,
    save_checkpoint,
)

_MODULE_FILE = "rollout.pt2"
_PARAMS_FILE = "params.npz"
_META_FILE = "bundle.json"
_FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")


def _operator_name(cfg) -> str:
    return "fno" if isinstance(cfg, FNOConfig) else "gkn"


def _rollout_kwargs(num_steps, threshold, graph_frame, collect, clip,
                    streams, stream_chunk) -> dict:
    return {
        "num_steps": int(num_steps),
        "threshold": float(threshold),
        "graph_frame": graph_frame,
        "collect": collect,
        "clip": None if clip is None else float(clip),
        "streams": int(streams),
        "stream_chunk": None if stream_chunk is None else int(stream_chunk),
    }


def _check_platforms(platforms) -> tuple:
    names = tuple(platforms)
    for name in names:
        if name not in PLATFORMS:
            raise ValueError(
                f"platform {name!r} is not one the PyTorch port runs on "
                f"(it takes {', '.join(PLATFORMS)}); a TPU program is the "
                "JAX package's rollout.jaxexport")
    return names


class _GKNStep(torch.nn.Module):
    """One step of ``rollout_scan``: the graph rebuilt from the window,
    the forward, the clip and the slide, and what ``collect`` keeps."""

    def __init__(self, cfg: ModelConfig, kw: dict):
        super().__init__()
        self.cfg, self.kw = cfg, kw

    def forward(self, params, aa, window):
        kw = self.kw
        window, out, overflow = _step(params, self.cfg, aa, window,
                                      kw["threshold"], kw["graph_frame"],
                                      kw["clip"])
        return window, collected(
            collected_outputs(out, kw["collect"], kw["threshold"]),
            kw["collect"]), overflow


class _FNOStep(torch.nn.Module):
    def __init__(self, cfg: FNOConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, params, channels):
        return fno_rollout_step(params, self.cfg, channels)


def _example_inputs(cfg, kw: dict, device):
    """Zeros of the program's input shapes (the trace reads no value)."""
    r = cfg.num_residues
    if _operator_name(cfg) == "fno":
        return (torch.zeros((r, r, cfg.in_channels), device=device),)
    streams = kw["stream_chunk"] or kw["streams"]
    t = cfg.window_size
    shape = (t, r, 3) if streams == 0 else (streams, t, r, 3)
    return (torch.zeros((r,), dtype=torch.int32, device=device),
            torch.zeros(shape, device=device))


def _canonical(tree, device):
    """A parameter tree with its keys sorted at every level (the order of
    the program's input spec, whatever order a checkpoint or an init gave
    them), as f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _canonical(tree[k], device) for k in sorted(tree)}
    return torch.as_tensor(tree, dtype=torch.float32, device=device)


def export_rollout(
    params,
    cfg,
    num_steps: int,
    *,
    threshold: float = 8.0,
    graph_frame: str = "last",
    collect: str = "coords",
    clip: Optional[float] = None,
    streams: int = 0,
    stream_chunk: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
):
    """Export one rollout step of this signature; returns
    ``(torch.export.ExportedProgram, platforms)``.

    The step is traced on the device of ``params``. ``streams=0`` is the
    single-stream signature, ``streams=S`` the batched one, exported at
    ``stream_chunk`` streams when that is given. ``platforms`` (``cpu``,
    ``cuda``) names the devices the bundle may run on; None names the
    device it was traced on."""
    if _operator_name(cfg) == "fno" and streams:
        raise ValueError(
            "FNO bundles export the single-stream (R, R, T) signature; "
            "batch streams at the caller before exporting")
    if getattr(cfg, "conv_impl", "xla") == "pallas":
        raise ValueError(
            "conv_impl='pallas' runs the hand-written CUDA kernels through "
            "ctypes, which an exported program cannot hold; export with "
            "conv_impl='xla' (the kernel rollout likewise serves in "
            "process only)")
    if collect not in COLLECT_MODES:
        raise ValueError(f"unknown collect mode: {collect}")
    if graph_frame not in ("last", "first"):
        raise ValueError(f"unknown graph_frame: {graph_frame!r} "
                         "(expected 'last' or 'first')")
    if stream_chunk is not None:
        if not streams:
            raise ValueError("stream_chunk only applies to streams > 0 "
                             "(single-stream has no stream axis)")
        if streams % stream_chunk:
            raise ValueError(f"stream count {streams} not divisible by "
                             f"stream_chunk {stream_chunk}")
    dev = device_of(params)
    platforms = _check_platforms(platforms or (dev.type,))
    kw = _rollout_kwargs(num_steps, threshold, graph_frame, collect, clip,
                         streams, stream_chunk)
    step = _FNOStep(cfg) if _operator_name(cfg) == "fno" \
        else _GKNStep(cfg, kw)
    params = _canonical(params, dev)
    with torch.no_grad():
        program = torch.export.export(
            step, (params,) + _example_inputs(cfg, kw, dev))
    # the example inputs hold the weights: params.npz keeps them once
    program.example_inputs = None
    return program, platforms


def save_bundle(
    path,
    params,
    cfg,
    num_steps: int,
    *,
    threshold: float = 8.0,
    graph_frame: str = "last",
    collect: str = "coords",
    clip: Optional[float] = None,
    streams: int = 0,
    stream_chunk: Optional[int] = None,
    platforms: Optional[Sequence[str]] = None,
    extra_meta: Optional[dict] = None,
) -> Path:
    """Export the rollout step and write the bundle directory."""
    program, platforms = export_rollout(
        params, cfg, num_steps, threshold=threshold, graph_frame=graph_frame,
        collect=collect, clip=clip, streams=streams,
        stream_chunk=stream_chunk, platforms=platforms)
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path / _MODULE_FILE)
    save_checkpoint(path / _PARAMS_FILE, params)
    meta = {
        "format_version": _FORMAT_VERSION,
        "operator": _operator_name(cfg),
        "model_config": dataclasses.asdict(cfg),
        "rollout": _rollout_kwargs(num_steps, threshold, graph_frame,
                                   collect, clip, streams, stream_chunk),
        "platforms": list(platforms),
        "traced_on": str(device_of(params)),
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta["extra"] = extra_meta
    (path / _META_FILE).write_text(json.dumps(meta, indent=2))
    return path


def _graphed_step(module, operator: str, params):
    """``ops/cuda/graphs.py::StepGraphs``' step of the exported step
    ``module`` reading the weights ``params``: ``((aa,), window) ->
    (window', collected as a tuple, overflow)`` for a GKN,
    ``((), channels) -> (channels', (its last channel,), None)`` for an
    FNO."""
    if operator == "fno":
        def step(inputs, channels):
            channels = module(params, channels)
            return channels, (channels[..., -1],), None
        return step

    def step(inputs, window):
        window, out, overflow = module(params, inputs[0], window)
        return window, out if isinstance(out, tuple) else (out,), overflow
    return step


@dataclasses.dataclass(frozen=True)
class ServingBundle:
    """A loaded bundle on ``device``: ``bundle(aa, window)`` for GKN
    bundles, ``bundle(channels0)`` for FNO ones (``bundle.operator`` says
    which). ``params=`` serves other weights of the same shapes.

    On the card a call replays CUDA graphs of the exported step, the
    counterpart of the JAX bundle's one program for the whole rollout:
    blocks of ``GRAPH_BLOCK`` steps over static weights, a static window
    and static blocks of outputs, and a tail graph (``ops/cuda/graphs.py
    ::StepGraphs``), one graph set per window shape, captured at its
    first call and kept for the bundle's lifetime. Each call first copies
    the weights it serves (the bundle's own or ``params=``) into the
    static weights. Calls from several threads take turns: a lock holds
    each from its copy of the weights to its copy of the outputs, and
    each call's work on the card waits for the last call's, whatever
    stream issued it. ``eager`` is the step loop issued from Python, the
    graphs' oracle and the loop on the CPU."""

    program: Any
    step: Any  # program.module(): the exported step as a callable
    params: Any
    cfg: Any
    meta: dict
    device: torch.device
    # the card's graphs and their static weights, made at the first call
    graphed: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)
    lock: Any = dataclasses.field(default_factory=threading.Lock,
                                  init=False, repr=False, compare=False)

    @property
    def operator(self) -> str:
        return self.meta.get("operator", "gkn")

    @property
    def platforms(self) -> tuple:
        return tuple(self.meta.get("platforms", ()))

    @property
    def rollout(self) -> dict:
        return dict(self.meta["rollout"])

    def _params(self, params):
        return self.params if params is None \
            else _canonical(params, self.device)

    def __call__(self, *args, params=None):
        if self.device.type != "cuda":
            return self.eager(*args, params=params)
        params = self._params(params)
        with self.lock:
            return self._replay(args, params)

    def _replay(self, args, params):
        if not self.graphed:
            static = tree_map(torch.clone, self.params)
            graphs = StepGraphs(
                _graphed_step(self.step, self.operator, static),
                f"serving bundle ({self.operator})")
            self.graphed.update(params=static, graphs=graphs,
                                done=torch.cuda.Event())
        static = self.graphed["params"]
        if tree_map(lambda t: t.shape, params) != \
                tree_map(lambda t: t.shape, static):
            raise ValueError("params= must have the bundle's keys and "
                             "shapes")
        done = self.graphed["done"]
        # the last call's replay and copies, on whatever stream, come first
        torch.cuda.current_stream(self.device).wait_event(done)
        # both trees are key-sorted (_canonical): their leaves pair up
        torch._foreach_copy_(tree_leaves(static), tree_leaves(params))
        result = self._replay_graphs(args)
        done.record(torch.cuda.current_stream(self.device))
        return result

    def _replay_graphs(self, args):
        graphs = self.graphed["graphs"]
        n = self.rollout["num_steps"]
        with torch.no_grad():
            if self.operator == "fno":
                outs, channels, _ = graphs((), self._channels(args[0]), n)
                return outs[0], channels
            collect = self.rollout["collect"]

            def run(aa, window0):
                outs, window, overflow = graphs((aa,), window0, n)
                return collected(outs, collect), window, {
                    "edge_overflow": overflow}

            return self._gkn(run, args[0], args[1])

    def eager(self, *args, params=None):
        """The rollout ``__call__`` returns, with the exported step called
        ``num_steps`` times from Python: the graphs' oracle, and the loop
        off the card."""
        params = self._params(params)
        n = self.rollout["num_steps"]
        with torch.no_grad():
            if self.operator == "fno":
                return self._fno(params, args[0], n)
            return self._gkn(lambda aa, w: self._run(params, aa, w, n),
                             args[0], args[1])

    def _channels(self, channels0):
        return torch.as_tensor(channels0, dtype=torch.float32,
                               device=self.device)

    def _fno(self, params, channels0, n: int):
        channels = self._channels(channels0)
        first, preds = channels, []
        for _ in range(n):
            channels = self.step(params, channels)
            preds.append(channels[..., -1])
        if not preds:
            return first.new_zeros(first.shape[:-3] + (0,)
                                   + first.shape[-3:-1]), channels
        return torch.stack(preds, dim=first.dim() - 3), channels

    def _gkn(self, run, aa, window0):
        """``run(aa, window0)`` of each ``stream_chunk`` of the streams,
        joined."""
        kw = self.rollout
        window0 = torch.as_tensor(window0, dtype=torch.float32,
                                  device=self.device)
        aa = torch.as_tensor(aa, device=self.device).to(torch.int32)
        want = 4 if kw["streams"] else 3
        if window0.dim() != want:
            raise ValueError(
                f"window0 must be {'(S, T, R, 3)' if want == 4 else '(T, R, 3)'}"
                f", got {tuple(window0.shape)}")
        chunk = kw["stream_chunk"]
        if chunk is None:
            return run(aa, window0)
        return _cat_parts([run(aa, window0[i:i + chunk])
                           for i in range(0, window0.shape[0], chunk)])

    def _run(self, params, aa, window0, n: int):
        window = window0
        overflowed = torch.zeros(window0.shape[:-3], dtype=torch.bool,
                                 device=window0.device)
        ys = []
        for _ in range(n):
            window, out, overflow = self.step(params, aa, window)
            overflowed = overflowed | overflow
            ys.append(out if isinstance(out, tuple) else (out,))
        return stacked_outputs(ys, self.rollout["collect"],
                               window0.dim() - 3), window, {
            "edge_overflow": overflowed}


def load_bundle(path, device=None) -> ServingBundle:
    """Read a bundle directory onto ``device`` (``cuda`` unless the
    caller asks for the CPU). Refuses a device type the bundle does not
    name in its ``platforms``; moves a program traced on another device.
    The weights restore against a fresh template of the config, shapes
    checked."""
    dev = resolve_device(device)
    path = Path(path)
    meta = json.loads((path / _META_FILE).read_text())
    if meta.get("format_version") != _FORMAT_VERSION:
        raise ValueError(
            f"unsupported bundle format_version {meta.get('format_version')}"
            f" (this build reads {_FORMAT_VERSION})")
    platforms = tuple(meta.get("platforms", ()))
    if dev.type not in platforms:
        raise ValueError(
            f"this bundle runs on {', '.join(platforms)}, not on "
            f"{dev.type}; export it again with that platform named")
    if meta.get("operator", "gkn") == "fno":
        cfg = _from_dict(FNOConfig, meta["model_config"])
        template = fno_init(cfg, seed=0, device=dev)
    else:
        cfg = _from_dict(ModelConfig, meta["model_config"])
        template = gkn_init(cfg, seed=0, device=dev)
    params, _ = restore_subtree(path / _PARAMS_FILE, template, ".params",
                                device=dev)
    params = _canonical(params, dev)
    program = torch.export.load(path / _MODULE_FILE)
    traced = torch.device(meta.get("traced_on", "cpu"))
    # a trace keeps the tensor constants it made (the FNO's DFT matrices)
    # on the host, and the program copies them to the card at every step:
    # a copy that a CUDA graph cannot capture
    astray = [t for t in program.constants.values()
              if isinstance(t, torch.Tensor) and t.device.type != dev.type]
    if (traced.type, traced.index or 0) != (dev.type, dev.index or 0) \
            or astray:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, str(dev))
    return ServingBundle(program=program, step=program.module(),
                         params=params, cfg=cfg, meta=meta, device=dev)


def bundle_bytes(path) -> dict:
    """{file name: bytes} of a bundle directory."""
    return {f.name: f.stat().st_size for f in sorted(Path(path).iterdir())}


__all__ = ["PLATFORMS", "ServingBundle", "bundle_bytes", "export_rollout",
           "load_bundle", "save_bundle"]
