"""The 10,000-atom rollout step's products on the card, at the shapes of
the ``solvated10k.rollout`` cell (``portbench/configs/solvated_10k.json``,
its traffic ``rollout_8_fresh`` and its seeded weights).

- The kernel tensor of the step's 480,000 slots (6 -> 1024 -> 1024 ->
  4096, ``ops/edge_conv.py::edge_kernel_matrices``) three ways: f32
  products of bf16-rounded operands; bf16 tensor cores
  (``ops/mlp.py::_TensorCoreMatmul``) with the f32 bias adds, ReLUs and
  casts between them; and the hand-written edge-MLP kernels
  (``hand_mlp``: bias, ReLU and the bf16 rounding on the accumulators),
  each layer of these also timed alone. Time, TFLOP/s, share of the
  bound (operations at 989 TFLOP/s), peak memory, and the gap between
  the hand kernels and the tensor-core form.
- One blocked conv layer's aggregation in three forms: a message a slot
  from an f32 copy of the kernel tensor, masked and summed per node (the
  form before the fold); one bf16 product a node over its D slots
  (``ops/edge_conv.py::_blocked_aggregate``); one bf16 product a slot.
- Eager 8-step calls of ``make_rollout_fn`` as the cell makes them, with
  the MLP in each form and the folded aggregation on and off, and the
  program counters of a step.
- The graphed dense bf16 and f32 scan step of ``bba_1fme_sparse`` on the
  dense graph, with the MLP in each form.

    python3 tools/port_blocked_step_profile.py [--seed 2100000101]
        [--calls 4] [--out chiprun_out/blocked_step.json]

Times are CUDA events (parts) and host clocks around synchronised calls
(steps); every number is printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from molecular_dynamics_neural_operator_tpu_torch.configs import (  # noqa: E402
    ModelConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.models import (  # noqa: E402
    gkn_init,
)
from molecular_dynamics_neural_operator_tpu_torch.ops import (  # noqa: E402
    edge_conv,
    mlp,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (  # noqa: E402
    edge_mlp as em,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (  # noqa: E402
    make_rollout_fn,
    scan,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import (  # noqa: E402
    profiling,
)
from portbench import weights  # noqa: E402
from portbench.traffic import generate  # noqa: E402

CONFIGS = ROOT / "portbench" / "configs"
TRAFFIC = ROOT / "portbench" / "traffic"
PEAK_BF16 = 989e12


def model_config(model: dict) -> ModelConfig:
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in names})


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def event_ms(fn, n: int = 5, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def peak_gb(fn) -> float:
    """Device memory that one call of fn allocates beyond what is held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def per_slot_aggregate(xs, kernels, mask, num_nodes, cd):
    """The blocked layer's sum as it was before the fold: a message a
    slot from the rounded operands in f32, masked, summed per node."""
    m = torch.einsum("...ew,...ewv->...ev", mlp.round_to(xs, cd),
                     mlp.round_to(kernels, cd))
    m = m * mask[..., None]
    return m.reshape(m.shape[:-2] + (num_nodes, -1, m.shape[-1])).sum(-2)


def per_edge_aggregate(xs, kernels, mask, num_nodes, cd):
    """One bf16 product a slot, (E, 1, w) @ (E, w, w) with an f32
    result, then the mask and the per-node sum."""
    m = torch.bmm((xs * mask[..., None]).to(kernels.dtype)[:, None, :],
                  kernels, out_dtype=torch.float32)[:, 0, :]
    return m.reshape(num_nodes, -1, m.shape[-1]).sum(-2)


def cell_inputs(seed: int):
    cfg_doc = json.loads((CONFIGS / "solvated_10k.json").read_text())
    mix = json.loads((TRAFFIC / "rollout_8_fresh.json").read_text())
    model = cfg_doc["model"]
    inputs = generate.make(mix, model, seed, 20.0)
    params = weights.make(model, cfg_doc["weights"],
                          generate.seeds(seed)[0], torch.device("cuda"))
    aa = torch.as_tensor(inputs["aa"], device="cuda")
    return model, mix, inputs, params, aa


def parts(model, inputs, params, aa) -> dict:
    """The kernel tensor and one layer's aggregation, each form timed
    alone on the first window's graph."""
    cfg = model_config(model)
    cd = torch.bfloat16
    window = torch.as_tensor(inputs["windows"][0][0], device="cuda")
    graph, _ = scan._build_graph(cfg, window[-1], model["threshold"])
    ef = graph.edge_feats
    e, w, r = ef.shape[0], cfg.width, cfg.num_residues
    sizes = [ef.shape[-1], cfg.ker_width, cfg.ker_width, w * w]
    mlp_flop = 2 * e * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    out = {"slots": e, "real_slots": int(graph.mask.sum().item()),
           "mlp_bound_ms": 1e3 * mlp_flop / PEAK_BF16}

    def kernel_tensor():
        return edge_conv.edge_kernel_matrices(params["edge_kernel"], ef, w,
                                              cd)

    with torch.no_grad():
        for name, form in (("mlp_f32", "f32"), ("mlp_tc", "tc"),
                           ("mlp_hand", "hand"), ("mlp_tc_again", "tc"),
                           ("mlp_hand_again", "hand")):
            with Halves(form, True):
                ms = event_ms(kernel_tensor, n=3)
                out[f"{name}_peak_gb"] = peak_gb(kernel_tensor)
            out[f"{name}_ms"] = ms
            out[f"{name}_tflops"] = mlp_flop / ms / 1e9
            out[f"{name}_bound_share"] = out["mlp_bound_ms"] / ms
            print(name, ms, flush=True)
        with Halves("tc", True):
            want = kernel_tensor()
        with Halves("hand", True):
            kernels = kernel_tensor()
        gap = (kernels.float() - want.float()).abs().max()
        out["mlp_hand_max_gap_over_max"] = \
            (gap / want.float().abs().max()).item()
        out["mlp_hand_share_unequal"] = \
            (kernels != want).float().mean().item()
        del want
        # each hand-written layer alone, on the previous layer's output
        a = ef.to(cd).contiguous()
        for i in range(3):
            layer = params["edge_kernel"][f"layer_{i}"]
            wt = layer["w"].to(cd).contiguous()
            b = layer["b"].float().contiguous()
            o = torch.empty(e, wt.shape[1], dtype=cd, device="cuda")
            ms = event_ms(lambda: em.edge_mlp(a, wt, b, i < 2, out=o), n=3)
            out[f"mlp_hand_layer{i}_ms"] = ms
            out[f"mlp_hand_layer{i}_tflops"] = \
                2 * e * wt.shape[0] * wt.shape[1] / ms / 1e9
            a = o
        del a, o
        x = torch.randn(r, w, device="cuda")
        xs = torch.take_along_dim(x, graph.edges[0].long()[:, None], dim=-2)
        mask = graph.mask
        forms = {
            "per_slot": lambda: per_slot_aggregate(xs, kernels, mask, r, cd),
            "folded": lambda: edge_conv._blocked_aggregate(xs, kernels, mask,
                                                           r, cd),
            "per_edge": lambda: per_edge_aggregate(xs, kernels, mask, r, cd),
        }
        gb = kernels.numel() * kernels.element_size() / 1e9
        for name, fn in forms.items():
            ms = event_ms(fn)
            out[f"layer_{name}_ms"] = ms
            out[f"layer_{name}_tbps"] = gb / ms
        want = per_slot_aggregate(xs, kernels, mask, r, cd)
        scale = want.abs().max().item()
        for name in ("folded", "per_edge"):
            got = forms[name]()
            out[f"layer_{name}_max_rel_gap"] = \
                (got - want).abs().max().item() / scale
        del kernels, xs
    out["kernel_tensor_gb"] = gb
    return out


class Halves:
    """Picks the MLP's form and the layer's for the block by replacing
    module functions: ``mlp`` "hand" keeps the rules as they are, "tc"
    replaces ``ops/edge_conv.py``'s hand-written-MLP rule by one that says
    no, which sends the MLP to ``_TensorCoreMatmul`` and its f32 passes,
    and "f32" also ``ops/mlp.py``'s tensor-core rule, which sends it to
    f32 products; ``aggregate`` off restores the per-slot layer."""

    def __init__(self, mlp_form: str, aggregate_on: bool):
        assert mlp_form in ("hand", "tc", "f32"), mlp_form
        self.mlp_form, self.aggregate_on = mlp_form, aggregate_on

    def __enter__(self):
        self._rule, self._hand, self._agg = mlp._on_tensor_cores, \
            edge_conv.hand_mlp, edge_conv._blocked_aggregate
        if self.mlp_form != "hand":
            edge_conv.hand_mlp = lambda *a: False
        if self.mlp_form == "f32":
            mlp._on_tensor_cores = lambda x, w, compute_dtype: False
        if not self.aggregate_on:
            edge_conv._blocked_aggregate = per_slot_aggregate
        return self

    def __exit__(self, *exc):
        mlp._on_tensor_cores = self._rule
        edge_conv.hand_mlp = self._hand
        edge_conv._blocked_aggregate = self._agg
        return False


def steps(model, mix, inputs, params, aa, calls: int) -> dict:
    """ms a step of eager 8-step calls, as ``portbench/entries/
    rollout_scan.py`` makes them, under each pair of halves; the peak
    memory of a call; the counters a step."""
    cfg = model_config(model)
    n = mix["steps_per_call"]
    fn = make_rollout_fn(cfg, n, model["threshold"], clip=mix.get("clip"),
                         batched=True, device="cuda")
    pool = inputs["windows"]
    out = {}
    for label, on in (("hand", ("hand", True)), ("tc", ("tc", True)),
                      ("tc_per_slot", ("tc", False)),
                      ("f32_folded", ("f32", True)),
                      ("f32_per_slot", ("f32", False)),
                      ("hand_again", ("hand", True))):
        with Halves(*on), torch.no_grad():
            fn(params, aa, pool[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = profiling.counters()
            t0 = time.perf_counter()
            for i in range(calls):
                fn(params, aa, pool[i % len(pool)])[0].cpu()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = profiling.counters()
        out[label] = {
            "ms_a_step": 1e3 * dt / (calls * n),
            "steps_per_s": calls * n / dt,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "counters_a_step": {k: (after.get(k, 0) - before.get(k, 0))
                                / (calls * n)
                                for k in ("plain_tc_linear",
                                          "blocked_bf16_aggregate",
                                          "fused_edge_mlp", "edge_mlp")},
        }
        print(label, out[label], flush=True)
    return out


def dense_steps(seed: int) -> dict:
    """The graphed dense scan step of ``bba_1fme_sparse`` on the dense
    graph, 128 steps a call, in bf16 and f32, with the MLP in each
    form."""
    doc = json.loads((CONFIGS / "bba_1fme_sparse.json").read_text())
    model = {**doc["model"], "graph_mode": "dense"}
    mix = json.loads((TRAFFIC / "rollout_1000.json").read_text())
    inputs = generate.make(mix, doc["model"], seed, 20.0)
    aa = torch.as_tensor(inputs["aa"], device="cuda")
    w0 = torch.as_tensor(inputs["windows"][0], device="cuda")
    if w0.dim() == 4:
        w0 = w0[0]
    out = {}
    for cd in ("bfloat16", "float32"):
        cfg = model_config({**model, "compute_dtype": cd})
        params = gkn_init(cfg, seed=0, device="cuda")
        for label in ("hand", "tc", "f32", "hand_again"):
            with Halves(label.split("_")[0], True), torch.no_grad():
                fn = make_rollout_fn(cfg, 128, model["threshold"],
                                     clip=100.0, device="cuda")
                fn(params, aa, w0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn(params, aa, w0)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0) / (10 * 128)
            out[f"{cd}_{label}_ms_a_step"] = ms
            print(cd, label, ms, flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=2100000101)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--out", default="chiprun_out/blocked_step.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"card": card(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    print(result, flush=True)
    model, mix, inputs, params, aa = cell_inputs(args.seed)
    result["parts"] = parts(model, inputs, params, aa)
    print(result["parts"], flush=True)
    result["steps"] = steps(model, mix, inputs, params, aa, args.calls)
    del params
    torch.cuda.empty_cache()
    result["dense"] = dense_steps(args.seed)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
