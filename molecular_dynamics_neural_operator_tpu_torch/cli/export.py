"""Export CLI: package a trained checkpoint as a serving bundle
(``molecular_dynamics_neural_operator_tpu/cli/export.py``).

Exports one rollout step with ``torch.export``, writes the bundle
(``serving/export.py``) and self-tests it: the bundle is loaded back and
one call is compared bit for bit with the in-process rollout on this
host's device.

    python -m molecular_dynamics_neural_operator_tpu_torch.cli.export \\
        --checkpoint tools/bench_ckpt.npz --max_edges 224 --predict_delta \\
        --clip 100 --num_steps 128 --out bundles/bba

The JAX CLI's flags, plus ``--device`` (``cuda`` unless ``cpu`` is
asked for; the step is traced there). ``--platforms`` takes ``cpu`` and
``cuda`` and refuses ``tpu`` by name; the self-test is skipped when this
host's device is not among them.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run_path", type=Path, default=None,
                   help="training run dir: reads config.json and best.npz")
    p.add_argument("--checkpoint", type=Path, default=None,
                   help=".npz checkpoint (overrides run_path's best.npz)")
    p.add_argument("--out", type=Path, required=True,
                   help="bundle directory to create")
    p.add_argument("--operator", choices=["gkn", "fno"], default="gkn",
                   help="which family the checkpoint belongs to (fno "
                        "bundles take the (R, R, T) distance-channel "
                        "window; config from --run_path's config.json "
                        "or FNOConfig defaults + --num_residues)")
    p.add_argument("--num_steps", type=int, default=100)
    p.add_argument("--threshold", type=float, default=8.0)
    p.add_argument("--collect", choices=["coords", "contact_maps", "both"],
                   default="coords")
    p.add_argument("--clip", type=float, default=None)
    p.add_argument("--streams", type=int, default=0,
                   help="0 = single-stream signature; S>0 exports the "
                        "batched (S, T, R, 3) one")
    p.add_argument("--stream_chunk", type=int, default=None)
    p.add_argument("--platforms", type=str, nargs="+", default=None,
                   help="devices the bundle may run on (cpu, cuda); "
                        "default = the device it is traced on")
    p.add_argument("--no_selftest", action="store_true",
                   help="skip the load-back + bitwise-vs-in-process check "
                        "(needed when none of --platforms matches this "
                        "host)")
    # Model flags for checkpoint-only exports (ignored with --run_path).
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--kernel_width", type=int, default=1024)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--window_size", type=int, default=10)
    p.add_argument("--num_residues", type=int, default=28)
    p.add_argument("--graph_mode", choices=["dense", "sparse"],
                   default="sparse")
    p.add_argument("--max_edges", type=int, default=256)
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--predict_delta", action="store_true")
    p.add_argument("--predict_prior", choices=["last", "extrapolate"],
                   default="last")
    p.add_argument("--prior_damping", type=float, default=1.0,
                   help="damping on the extrapolate prior "
                        "(must match training)")
    p.add_argument("--device", default=None,
                   help="cuda (default; a missing card is an error) or cpu")
    args = p.parse_args(argv)
    for name in args.platforms or ():
        if name == "tpu":
            raise SystemExit(
                "not supported by the PyTorch port: --platforms tpu (a TPU "
                "program is the JAX package's cli.export); take cpu or cuda")
    return args


def selftest_inputs(cfg, operator: str, streams: int, device):
    """The self-test's seeded inputs: a (R, R, C) channel window for the
    FNO; (aa, window) for the GKN, windows of 4 A scale."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    r = cfg.num_residues
    if operator == "fno":
        x = rng.standard_normal((r, r, cfg.in_channels)).astype(np.float32)
        return (torch.as_tensor(x, device=device),)
    t = cfg.window_size
    shape = (t, r, 3) if streams == 0 else (streams, t, r, 3)
    window = rng.standard_normal(shape).astype(np.float32) * 4.0
    aa = np.arange(r, dtype=np.int32) % cfg.num_embeddings
    return (torch.as_tensor(aa, device=device),
            torch.as_tensor(window, device=device))


def in_process(params, cfg, operator: str, rollout: dict, device):
    """The rollout a bundle of this signature stands in for, in process:
    fn(params, *inputs)."""
    from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
        fno_rollout_scan,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    if operator == "fno":
        return lambda p, channels0: fno_rollout_scan(
            p, cfg, channels0, rollout["num_steps"])
    return make_rollout_fn(
        cfg, num_steps=rollout["num_steps"], threshold=rollout["threshold"],
        graph_frame=rollout["graph_frame"], collect=rollout["collect"],
        batched=rollout["streams"] > 0, clip=rollout["clip"],
        stream_chunk=rollout["stream_chunk"], device=device)


def same_outputs(got, want) -> bool:
    """Leaf by leaf: the same shapes, the same non-finite places, and the
    finite values equal bit for bit."""
    import torch

    def leaves(x):
        if isinstance(x, dict):
            return [y for v in x.values() for y in leaves(v)]
        if isinstance(x, (tuple, list)):
            return [y for v in x for y in leaves(v)]
        return [x]

    g_leaves, w_leaves = leaves(got), leaves(want)
    if len(g_leaves) != len(w_leaves):
        return False
    for g, w in zip(g_leaves, w_leaves):
        if g.shape != w.shape or g.dtype != w.dtype:
            return False
        if g.dtype == torch.bool:
            if not torch.equal(g, w):
                return False
            continue
        fin = torch.isfinite(g)
        if not (torch.equal(fin, torch.isfinite(w))
                and torch.equal(g[fin], w[fin])):
            return False
    return True


def main(argv=None):
    args = parse_args(argv)

    import torch

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        FNOConfig,
        ModelConfig,
        experiment_from_json,
    )
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        resolve_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
        fno_init,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.export import (
        bundle_bytes,
        load_bundle,
        save_bundle,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        restore_subtree,
    )

    device = resolve_device(args.device)
    ckpt = args.checkpoint
    exp_cfg = None
    if args.run_path is not None:
        exp_cfg = experiment_from_json(
            (args.run_path / "config.json").read_text())
        if ckpt is None and (args.run_path / "best.npz").exists():
            ckpt = args.run_path / "best.npz"
    if args.operator == "fno":
        cfg = (exp_cfg.fno if exp_cfg is not None
               else FNOConfig(num_residues=args.num_residues))
        init = fno_init
    else:
        cfg = exp_cfg.model if exp_cfg is not None else ModelConfig(
            width=args.width, ker_width=args.kernel_width, depth=args.depth,
            window_size=args.window_size, num_residues=args.num_residues,
            graph_mode=args.graph_mode, max_edges=args.max_edges,
            compute_dtype=args.compute_dtype,
            predict_delta=args.predict_delta,
            predict_prior=args.predict_prior,
            prior_damping=args.prior_damping,
        )
        init = gkn_init
    if ckpt is None:
        raise SystemExit("no checkpoint: pass --checkpoint or a --run_path "
                         "containing best.npz")

    template = init(cfg, seed=0, device=device)
    params, meta = restore_subtree(ckpt, template, ".params", device=device)

    path = save_bundle(
        args.out, params, cfg, args.num_steps,
        threshold=args.threshold, collect=args.collect, clip=args.clip,
        streams=args.streams, stream_chunk=args.stream_chunk,
        platforms=args.platforms,
        extra_meta={"checkpoint": str(ckpt),
                    "checkpoint_epoch": meta.get("epoch")},
    )
    sizes = bundle_bytes(path)
    print(f"bundle written: {path} "
          + " ".join(f"{k}={v}B" for k, v in sizes.items()))

    if args.no_selftest:
        return path
    platforms = tuple(args.platforms or (device.type,))
    if device.type not in platforms:
        print(f"selftest skipped: bundle platforms {platforms} exclude this "
              f"host ({device.type}); pass --no_selftest to silence")
        return path
    bundle = load_bundle(path, device=device)
    inputs = selftest_inputs(cfg, args.operator, args.streams, device)
    got = bundle(*inputs)
    with torch.no_grad():
        want = in_process(params, cfg, args.operator, bundle.rollout,
                          device)(params, *inputs)
    if not same_outputs(got, want):
        raise SystemExit("selftest FAILED: bundle output != in-process "
                         "rollout")
    print(f"selftest ok: {args.num_steps}-step rollout bitwise == "
          f"in-process on {device.type}")
    return path


if __name__ == "__main__":
    main()
