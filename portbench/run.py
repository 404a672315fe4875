"""Run one cell of ``BENCHMARK.json`` once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (``configs/<name>.json``: the model's
sizes, its weights' recipe, its source, the limits of its comparison) and
a traffic mix (``traffic/<mix>.json``), which names the program entry
that serves it (``entries/<entry>.py``). A run builds the inputs and
weights from the seed, sets the program up and warms up every shape the
mix uses (``setup_s`` runs from the start of this module to the first
timed call), measures for ``--seconds``, checks that nothing of JAX is
loaded, frees the program and judges its outputs against the plain
reference. With ``--trace 0`` the last line of standard output carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
each read by ``metrics/<name>.py`` from the profiler's trace of the
window and the program's counters.

Exits 2, printing no result, without a card (or with fewer than the
cell asks for) and where a module of JAX is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "molecular_dynamics_neural_operator_tpu")
PORT = "molecular_dynamics_neural_operator_tpu_torch"
CACHE = HERE / ".cache"


class Refused(RuntimeError):
    """A run that must print no result."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise Refused(f"missing {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.exists():
        raise Refused(f"missing {path}")
    return json.loads(path.read_text())


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What one run knows: the cell, its configuration and mix, the
    program's state while it lives, its outputs, and what the metrics
    read."""

    def __init__(self, bench: dict, cell: dict, seed: int, seconds: float,
                 trace: bool, device, root: Path = ROOT, rank=None,
                 world=None, rdzv=None):
        self.bench, self.cell, self.seed = bench, cell, int(seed)
        # a rank the process that prints spawned: its rank, the world and
        # the rendezvous file (None in the process that prints)
        self.rank, self.world, self.rdzv = rank, world, rdzv
        self.root = root
        self.memory_peak = self.busy_s = None   # set across ranks
        self.seconds, self.trace_on, self.device = seconds, trace, device
        cfg_entry = next(c for c in bench["configs"]
                         if c["name"] == cell["config"])
        self.config = load_json(root / cfg_entry["file"])
        self.mix = load_json(root / HERE.name / "traffic"
                             / f"{cell['traffic']}.json")
        self.model = dict(self.config["model"], **self.mix.get("model", {}))
        self.chips = int(cell["chips"])
        self.state = None          # the program's objects, while they live
        self.outputs = []          # what the timed path produced
        self.attempted = self.failed = 0
        self.window_s = None
        self.counters = {}         # the program's counters over the window
        self.work = {}             # what the metrics count, after the run
        self.trace = None


def per_layer_for(bench: dict, name: str, reported: set) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out


def end_to_end_for(bench: dict, name: str) -> list:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or name in m["workloads"]]


def execute(args, root: Path = ROOT, require_cuda: bool = True,
            device: str = "cuda") -> dict:
    """One run; returns the result line's object."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(CACHE / "inductor"))
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        raise Refused(f"no cell {args.workload!r} in BENCHMARK.json")
    import torch

    if getattr(args, "rank", None) is not None:
        require_cuda = args.device == "cuda"
        device = f"cuda:{args.rank}" if require_cuda else "cpu"
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < int(cell["chips"])):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise Refused(f"the cell needs {cell['chips']} CUDA device(s); "
                      f"this machine has {have}")
    dev = torch.device(device)
    run = Run(bench, cell, args.seed, float(args.seconds), bool(args.trace),
              dev, root, getattr(args, "rank", None),
              getattr(args, "world", None), getattr(args, "rdzv", None))
    entry = load_module(HERE / "entries" / f"{run.mix['entry']}.py",
                        f"portbench.entries.{run.mix['entry']}")
    entry.setup(run)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    prof = None
    if run.trace_on:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    from portbench.trace import WINDOW

    with torch.profiler.record_function(WINDOW):
        t0 = time.perf_counter()
        entry.window(run, t0 + run.seconds)
        if cuda:
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    run.memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX loaded in the run: {found}")
    entry.release(run)
    if cuda:
        torch.cuda.empty_cache()

    checks = entry.judge(run)
    correct = bool(checks) and all(ok for _, _, _, ok in checks)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": run.chips,
        "memory_peak_bytes": int(run.memory_peak),
    }
    result = {"correct": correct, "attempted": int(run.attempted),
              "failed": int(run.failed)}
    e2e = entry.end_to_end(run)
    e2e["setup_s"] = setup_s
    cell_e2e = end_to_end_for(bench, cell["name"])
    if not run.trace_on:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell_e2e}
    else:
        from portbench.trace import Trace

        run.trace = Trace(prof) if cuda else None
        entry.work(run)
        metrics = {}
        for m in per_layer_for(bench, cell["name"],
                               {x["name"] for x in cell_e2e}):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"portbench.metrics.{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        if run.trace is not None:
            device_info["busy_s"] = (run.busy_s if run.busy_s is not None
                                     else run.trace.busy_s)
            device_info["window_s"] = run.trace.window_s
            result["breakdown"] = {"device_ops": run.trace.device_ops(),
                                   "idle_gaps": run.trace.idle_gaps()}
    if hasattr(entry, "finish"):
        entry.finish(run)
    device_info["memory_peak_bytes"] = int(run.memory_peak)
    result["device"] = device_info
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit, _ in checks}
    for name, value, limit, ok in checks:
        print(f"check {name}: {value!r} against {limit!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank that a multi-rank cell's process spawns; it prints no result
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.device != "cuda" and args.rank is None:
        p.error("--device is a spawned rank's")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    try:
        result = execute(args)
    except Refused as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    if args.rank is not None:
        return 0
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
