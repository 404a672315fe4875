"""Rollout CLI: a free-running trajectory from a checkpoint
(``molecular_dynamics_neural_operator_tpu/cli/rollout.py``).

    python -m molecular_dynamics_neural_operator_tpu_torch.cli.rollout \\
        --data_path traj.h5 --checkpoint runs/bba/best.npz \\
        --out_path runs/bba/rollout

The JAX CLI's flags, defaults and output files, flag for flag: roll out
``--num_steps`` steps from the window at ``--start_frame`` and write
``forecast_coords.npy``, ``per_step_mse.npy`` (when the trajectory holds
the true continuation) and ``rollout_summary.json``; ``--streams S``
rolls S windows ``--stream_stride`` frames apart at once;
``--movie`` renders forecast against real contact maps, ``--backbone``
the first steps' backbones. ``--impl persistent`` runs the rollout
kernels (``ops/cuda/persistent_rollout.py``: ``graph_encode``,
``edge_mlp`` ×3 and ``conv_head`` every step), which build their own
sparse graph of ``--max_edges`` slots whatever ``--graph_mode`` says, as
the JAX kernel does; ``--impl scan`` the PyTorch rollout
(``rollout/scan.py``) on the graph ``--graph_mode`` names, by default the
dense all-pairs graph. The checkpoint is a TrainState or
bare-params file of either package; only its parameters are read.

``--neighbor_impl cell_list`` (with ``--graph_mode sparse``) rebuilds
each step's graph with the O(N) cell list of ``geometry/cells.py``
(``--max_degree`` edges an atom, ``--cell_capacity`` atoms a cell,
``--num_cells`` hash buckets), the rebuild of the ``SOLVATED_10K``
preset; the default ``dense_rank`` ranks the contact map.

``--device`` picks the card (``cuda``, the default; a missing card is an
error) or ``cpu``, where the kernel path runs each kernel's plain
version. As in the JAX CLI, ``--kernel_quant int8`` without
``--graph_mode sparse`` is refused with ``SystemExit`` before any data
is read. ``--compilation_cache`` is accepted as a no-op.

``main(argv)`` parses, loads the trajectory and calls
``rollout_from_trajectory(args, traj)``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=Path, required=True)
    p.add_argument("--checkpoint", type=Path, default=None,
                   help=".npz train-state checkpoint (random init if absent)")
    p.add_argument("--out_path", type=Path, required=True)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--start_frame", type=int, default=0)
    p.add_argument("--threshold", type=float, default=8.0)
    p.add_argument("--window_size", type=int, default=10)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--kernel_width", type=int, default=1024)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--num_residues", type=int, default=28)
    p.add_argument("--graph_mode", choices=["dense", "sparse"], default="dense")
    p.add_argument("--max_edges", type=int, default=384,
                   help="padded edge capacity for sparse-mode rebuilds")
    p.add_argument("--neighbor_impl", choices=["dense_rank", "cell_list"],
                   default="dense_rank",
                   help="sparse-mode rebuild: the ranked contact map or "
                        "the O(N) cell list for large systems")
    p.add_argument("--max_degree", type=int, default=32)
    p.add_argument("--cell_capacity", type=int, default=16)
    p.add_argument("--num_cells", type=int, default=4096)
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--predict_delta", action="store_true")
    p.add_argument("--predict_prior", choices=["last", "extrapolate"],
                   default="last",
                   help="must match the training flag")
    p.add_argument("--electrostatics", choices=["none", "dh"],
                   default="none",
                   help="must match the training flag: checkpoints trained "
                        "with dh have a wider fc1")
    p.add_argument("--prior_damping", type=float, default=1.0,
                   help="damping on the extrapolate prior (must match "
                        "training)")
    p.add_argument("--window_diff", action="store_true")
    p.add_argument("--window_diff_scale", type=float, default=100.0)
    p.add_argument("--kernel_quant", choices=["none", "int8"],
                   default="none")
    p.add_argument("--clip", type=float, default=None)
    p.add_argument("--impl", choices=["scan", "persistent"], default="scan",
                   help="'persistent' runs the CUDA rollout kernels "
                        "(sparse graph semantics, tied edge kernel)")
    p.add_argument("--streams", type=int, default=1,
                   help=">1 rolls that many streams batched (start frames "
                        "spaced --stream_stride apart)")
    p.add_argument("--stream_stride", type=int, default=1)
    p.add_argument("--stream_chunk", type=int, default=None)
    p.add_argument("--movie", action="store_true")
    p.add_argument("--backbone", action="store_true",
                   help="render 3-D backbone frames of the first rollout "
                        "steps")
    p.add_argument("--compilation_cache", type=Path, default=None,
                   help="accepted for the JAX CLI's command lines; no-op")
    p.add_argument("--device", default=None,
                   help="cuda (default; a missing card is an error) or cpu")
    args = p.parse_args(argv)
    if args.kernel_quant != "none" and args.graph_mode != "sparse":
        raise SystemExit("--kernel_quant int8 requires --graph_mode sparse")
    return args


def rollout_from_trajectory(args, traj):
    """Everything of ``main`` after the trajectory is loaded. Returns the
    summary dict it writes to ``rollout_summary.json``."""
    import numpy as np
    import torch

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        resolve_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.persistent_rollout import (  # noqa: E501
        make_persistent_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
        rollout_with_mse,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        restore_subtree,
    )

    dev = resolve_device(args.device)
    if args.compilation_cache is not None:
        print("NOTE: --compilation_cache has no counterpart in the PyTorch "
              "port; ignoring it")
    cfg = ModelConfig(
        width=args.width,
        ker_width=args.kernel_width,
        depth=args.depth,
        window_size=args.window_size,
        num_residues=args.num_residues,
        graph_mode=args.graph_mode,
        max_edges=args.max_edges,
        neighbor_impl=args.neighbor_impl,
        max_degree=args.max_degree,
        cell_capacity=args.cell_capacity,
        num_cells=args.num_cells,
        compute_dtype=args.compute_dtype,
        predict_delta=args.predict_delta,
        predict_prior=args.predict_prior,
        prior_damping=args.prior_damping,
        electrostatics=args.electrostatics,
        window_diff=args.window_diff,
        window_diff_scale=args.window_diff_scale,
        kernel_quant=args.kernel_quant,
    )

    template = gkn_init(cfg, seed=0, device=dev)
    if args.checkpoint is not None:
        # the parameters alone: a rollout needs no optimizer state
        params, meta = restore_subtree(args.checkpoint, template, ".params",
                                       device=dev)
        print(f"Loaded checkpoint (epoch {meta.get('epoch', '?')})")
    else:
        params = template
        print("No checkpoint given: random init (throughput/debug mode)")

    aa = torch.as_tensor(traj.aminoacids, device=dev)
    s = args.start_frame
    window0 = traj.positions[s : s + cfg.window_size]

    out_dir = Path(args.out_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    def finish(t):
        """Device tensor -> host array (waits for the device)."""
        return t.float().cpu().numpy()

    if args.streams > 1:
        # S rollouts batched on one card; writes (S, num_steps, R, 3)
        starts = [s + i * args.stream_stride for i in range(args.streams)]
        hi = max(starts) + cfg.window_size
        if hi > traj.num_frames:
            raise ValueError(
                f"streams x stride needs frame {hi}, trajectory has "
                f"{traj.num_frames}"
            )
        w0s = np.stack([traj.positions[st : st + cfg.window_size]
                        for st in starts])
        if args.impl == "persistent":
            if args.stream_chunk is not None:
                print("NOTE: --stream_chunk applies to the scan path only; "
                      "the rollout kernels run every stream in each launch "
                      "(ignoring it)")
            roll = make_persistent_rollout_fn(cfg, args.num_steps,
                                              args.threshold,
                                              clip=args.clip, device=dev)
        else:
            roll = make_rollout_fn(cfg, args.num_steps, args.threshold,
                                   clip=args.clip, batched=True,
                                   stream_chunk=args.stream_chunk,
                                   device=dev)
        t0 = time.time()
        with torch.no_grad():
            coords, _, diags = roll(params, aa, w0s)
        coords = finish(coords)
        dt = time.time() - t0
        np.save(out_dir / "forecast_coords.npy", coords)
        summary = {
            "streams": args.streams,
            "num_steps": args.num_steps,
            "seconds": dt,
            "agg_steps_per_s": args.streams * args.num_steps / dt,
            "finite": bool(np.isfinite(coords).all()),
            "edge_overflow": bool(diags["edge_overflow"].any()),
        }
        (out_dir / "rollout_summary.json").write_text(
            json.dumps(summary, indent=2))
        print(json.dumps(summary))
        return summary

    truth_lo = s + cfg.window_size
    have_truth = truth_lo + args.num_steps <= traj.num_frames
    t0 = time.time()
    mses = None
    with torch.no_grad():
        if args.impl == "persistent":
            roll = make_persistent_rollout_fn(cfg, args.num_steps,
                                              args.threshold, clip=args.clip,
                                              device=dev)
            coords, _, diags = roll(params, aa, window0)
            if bool(diags["edge_overflow"]):
                print("WARNING: graph rebuild exceeded max_edges during the "
                      "rollout; edges were truncated (raise --max_edges)")
            if have_truth:
                truth = traj.positions[truth_lo : truth_lo + args.num_steps]
                mses = np.mean((finish(coords) - truth) ** 2, axis=(1, 2))
        elif have_truth:
            truth = torch.as_tensor(
                traj.positions[truth_lo : truth_lo + args.num_steps],
                device=dev)
            coords, mses, _ = rollout_with_mse(
                params, cfg, aa, torch.as_tensor(window0, device=dev), truth,
                args.threshold, clip=args.clip)
            mses = finish(mses)
        else:
            roll = make_rollout_fn(cfg, args.num_steps, args.threshold,
                                   clip=args.clip, device=dev)
            coords, _, diags = roll(params, aa, window0)
            if bool(diags["edge_overflow"]):
                print("WARNING: graph rebuild exceeded max_edges during the "
                      "rollout; edges were truncated (raise --max_edges)")
    if mses is not None:
        np.save(out_dir / "per_step_mse.npy", np.asarray(mses))
    coords = finish(coords)
    dt = time.time() - t0
    np.save(out_dir / "forecast_coords.npy", coords)

    summary = {
        "num_steps": args.num_steps,
        "seconds": dt,
        "steps_per_s": args.num_steps / dt,
        "finite": bool(np.isfinite(coords).all()),
    }
    if have_truth:
        m = np.asarray(mses)
        summary["mse_first"] = float(m[0])
        summary["mse_last"] = float(m[-1])
    (out_dir / "rollout_summary.json").write_text(
        json.dumps(summary, indent=2))
    print(json.dumps(summary))

    if args.movie:
        from molecular_dynamics_neural_operator_tpu_torch.geometry import (
            contact_map,
        )
        from molecular_dynamics_neural_operator_tpu_torch.utils.movie import (
            render_propagation_movie,
        )

        def cmap(x):
            return contact_map(torch.as_tensor(x), args.threshold).numpy()

        n = min(args.num_steps, 20)
        fc = [cmap(coords[i]) for i in range(n)]
        real = [cmap(traj.positions[truth_lo + i])
                for i in range(min(n, traj.num_frames - truth_lo))]
        render_propagation_movie(out_dir, 0, fc, real[: len(fc)])

    if args.backbone:
        from molecular_dynamics_neural_operator_tpu_torch.utils.backbone import (
            render_backbone_trajectory,
        )

        n = min(args.num_steps, 8)
        real_bb = None
        if have_truth:
            real_bb = [traj.positions[truth_lo + i] for i in range(n)]
        render_backbone_trajectory(out_dir, [coords[i] for i in range(n)],
                                   real_bb)
    return summary


def main(argv=None):
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        load_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        resolve_device,
    )

    args = parse_args(argv)
    resolve_device(args.device)
    traj = load_trajectory(args.data_path)
    return rollout_from_trajectory(args, traj)


if __name__ == "__main__":
    main()
