"""Training CLI of the GKN (``molecular_dynamics_neural_operator_tpu/cli/train.py``).

    python -m molecular_dynamics_neural_operator_tpu_torch.cli.train \\
        --data_path traj.h5 --run_path runs/bba

The JAX CLI's flags, defaults and output files, flag for flag: the run
directory gets ``config.json`` (``configs.to_json``, readable by both
packages), ``metrics.jsonl`` with the notebook's epoch lines on stdout,
``best.npz`` and ``last.npz`` (TrainState checkpoints in the JAX
package's layout, ``utils/checkpoint.py``), the propagation movie, the
latent sweep and ``latent_color_dict.pkl``. ``--rollout_steps K`` trains
the K-step curriculum, with gradient clipping 1.0 and the non-finite
update guard on by default; ``--resume`` continues from a checkpoint of
either package; ``--profile`` writes a ``torch.profiler`` Chrome trace of
the first epoch to ``<run_path>/trace``.

``--device`` picks the card (``cuda``, the default; a missing card is an
error) or ``cpu``. ``--train_conv_impl auto`` takes the training kernels
(``"pallas"``, ``ops/cuda/train_conv.py``) on the card with a sparse
graph and the per-layer PyTorch path (``"xla"``) otherwise: the default
``--graph_mode dense``, as in the JAX package, trains on the dense
all-pairs graph without them. ``--edge_layout blocked`` packs the sparse
edge lists in the block layout and aggregates them with
``scatter_mode="blocked"``.

``--operator fno`` trains the FNO on distance matrices instead
(``models/fno.py``; ``--fno_modes``, ``--fno_width``, ``--fno_depth``,
``--fno_predict_delta``, ``--fno_predict_prior``; ``--window_size``
input channels): the same run directory with the ``fno`` section in
``config.json``, teacher-forced or ``--rollout_steps K`` steps,
``--resume``, the checkpoints, and a movie of ``fno_rollout_scan``'s
contact maps; the GKN's model flags, ``--profile`` and the latent sweep
do not apply to it.

``--operator fno3d`` trains FNO-3d (``models/fno3d.py``, at its
published sizes unless ``--fno3d_*`` say otherwise; ``--window_size``
input frames) on one device through ``train_epoch``: each step forecasts
``--fno3d_out_frames`` distance matrices in one call and trains one loss
over the block. The run directory gets ``config.json`` (data and
training), ``fno3d.json`` (the model's ``FNO3dConfig``), the metrics and
the checkpoints; ``--resume`` continues from one. It has no movie, no
latent sweep and no ``--data_parallel``.

``--data_parallel`` trains on every rank of a ``torchrun`` launch, the
batch's rows spread over the ranks and the gradients summed
(``parallel/mesh.py``): the teacher-forced step, the curriculum and the
FNO. One process (no ``torchrun``) trains as without it, as one device
does in the JAX CLI. The batch size must divide by the world size. Only
rank 0 evaluates, logs, renders and writes the run directory; after every
epoch the ranks' parameters must be bit-equal, or the run stops.

    torchrun --nproc_per_node 2 -m \
        molecular_dynamics_neural_operator_tpu_torch.cli.train \
        --data_path traj.h5 --run_path runs/bba --graph_mode sparse \
        --data_parallel

``--compilation_cache`` has no counterpart and is accepted as a no-op.

``main(argv)`` parses, loads the trajectory and calls
``train_from_trajectory(args, traj)``, which does everything after the
load: a caller with a trajectory in memory (a machine without h5py)
calls it directly.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=Path, required=True)
    p.add_argument("--run_path", type=Path, required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--scheduler_step", type=int, default=50)
    p.add_argument("--scheduler_gamma", type=float, default=0.8)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--out_width", type=int, default=3)
    p.add_argument("--kernel_width", type=int, default=1024)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--node_features", type=int, default=7)
    p.add_argument("--edge_features", type=int, default=6)
    p.add_argument("--num_embeddings", type=int, default=20)
    p.add_argument("--embedding_dim", type=int, default=4)
    p.add_argument("--split_pct", type=float, default=0.8)
    # the reference's DataLoader worker knobs: prefetch_factor is the
    # depth of prefetch_to_device, the other three are warned no-ops.
    # "False", "0", "no" and "off" read as false (the reference's
    # type=bool reads every non-empty string as true).
    _flag = lambda s: s.lower() not in ("false", "0", "no", "off")  # noqa: E731
    p.add_argument("--num_data_workers", type=int, default=0)
    p.add_argument("--prefetch_factor", type=int, default=2)
    p.add_argument("--persistent_workers", type=_flag, default=False)
    p.add_argument("--non_blocking", type=_flag, default=False)
    p.add_argument("--generate_movie", type=_flag, default=True)
    p.add_argument("--num_movie_frames", type=int, default=5)
    p.add_argument("--plot_latent", type=_flag, default=True)
    p.add_argument("--plot_per_epochs", type=int, default=1)
    p.add_argument("--window_size", type=int, default=10)
    p.add_argument("--num_residues", type=int, default=28)
    p.add_argument("--horizon", type=int, default=1,
                   help="prediction horizon")
    p.add_argument("--node_features_path", type=Path, default=None)
    p.add_argument("--max_frames", type=int, default=100_000_000,
                   help="truncate trajectories for shorter training")
    p.add_argument("--rollout_steps", type=int, default=0,
                   help="K>0 enables the K-step rollout curriculum loss")
    p.add_argument("--loss_space", choices=["absolute", "delta"],
                   default="absolute",
                   help="curriculum loss normalization: 'delta' divides "
                        "each step's error by the true per-step "
                        "displacement")
    p.add_argument("--grad_steps", type=int, default=0,
                   help="supervise only the last j curriculum steps "
                        "(0 = full backpropagation through all K steps)")
    p.add_argument("--unroll_scans", action="store_true",
                   help="accepted for the JAX CLI's command lines: the "
                        "port's K-step loop is a Python loop either way")
    p.add_argument("--burnin_dtype", choices=["bfloat16"], default=None,
                   help="run the curriculum burn-in prefix with the model "
                        "body at this dtype")
    p.add_argument("--coord_clip", type=float, default=1000.0,
                   help="clip rail on the curriculum's inner rollout "
                        "coordinates (0 disables)")
    p.add_argument("--noise_std", type=float, default=0.0,
                   help="random-walk input noise std (Angstrom) on the "
                        "training windows; targets stay clean")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="average this many micro-batch gradients per "
                        "optimizer apply")
    p.add_argument("--grad_clip_norm", type=float, default=None,
                   help="global-norm gradient clipping (default: 1.0 when "
                        "the curriculum is on, else off)")
    p.add_argument("--skip_nonfinite", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="reject NaN/inf update steps (default: on when the "
                        "curriculum is on)")
    p.add_argument("--operator", choices=["gkn", "fno", "fno3d"],
                   default="gkn",
                   help="operator family: graph kernel network, FNO or "
                        "the space-time FNO-3d on distance matrices")
    p.add_argument("--fno_modes", type=int, default=12)
    p.add_argument("--fno_width", type=int, default=32)
    p.add_argument("--fno_depth", type=int, default=4)
    p.add_argument("--fno_predict_prior", choices=["last", "extrapolate"],
                   default="last")
    p.add_argument("--fno_predict_delta", action="store_true")
    p.add_argument("--fno3d_width", type=int, default=20)
    p.add_argument("--fno3d_modes", type=int, default=8,
                   help="kept modes on each residue axis")
    p.add_argument("--fno3d_modes3", type=int, default=8,
                   help="kept modes on the padded time axis")
    p.add_argument("--fno3d_depth", type=int, default=4)
    p.add_argument("--fno3d_out_frames", type=int, default=40,
                   help="distance matrices forecast in one call")
    p.add_argument("--graph_mode", choices=["dense", "sparse"], default="dense")
    p.add_argument("--max_edges", type=int, default=384,
                   help="padded edge capacity for sparse mode")
    p.add_argument("--edge_layout", choices=["csr", "blocked"],
                   default="csr")
    p.add_argument("--train_conv_impl", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="'pallas' runs the conv stack as the CUDA training "
                        "kernels, 'xla' as per-layer PyTorch; 'auto' takes "
                        "the kernels on the card with a sparse graph")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default="bfloat16")
    p.add_argument("--predict_delta", action="store_true")
    p.add_argument("--predict_prior", choices=["last", "extrapolate"],
                   default="last")
    p.add_argument("--prior_damping", type=float, default=1.0)
    p.add_argument("--head_init", choices=["default", "zero"],
                   default="default")
    p.add_argument("--head_scale", type=float, default=1.0)
    p.add_argument("--kernel_init_scale", type=float, default=1.0,
                   help="multiplier on the edge-kernel MLP's final-layer "
                        "init")
    p.add_argument("--window_diff", action="store_true")
    p.add_argument("--window_diff_scale", type=float, default=100.0)
    p.add_argument("--electrostatics", choices=["none", "dh"],
                   default="none")
    p.add_argument("--latent_frames", type=int, default=10000)
    p.add_argument("--resume", type=Path, default=None,
                   help="checkpoint (.npz) to resume from")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first "
                        "training epoch, with the program's spans, to "
                        "<run_path>/trace")
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--compilation_cache", type=Path, default=None,
                   help="accepted for the JAX CLI's command lines; no-op")
    p.add_argument("--device", default=None,
                   help="cuda (default; a missing card is an error) or cpu")
    return p.parse_args(argv)


def build_configs(args):
    import torch

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        DataConfig,
        ModelConfig,
        TrainConfig,
    )

    train_conv_impl = args.train_conv_impl
    if train_conv_impl == "auto":
        # the JAX rule: the kernel where it can run, on the device asked for
        on_card = torch.device(args.device or "cuda").type == "cuda"
        train_conv_impl = ("pallas" if on_card and args.graph_mode == "sparse"
                           else "xla")
    model = ModelConfig(
        train_conv_impl=train_conv_impl,
        width=args.width,
        ker_width=args.kernel_width,
        depth=args.depth,
        edge_features=args.edge_features,
        node_features=args.node_features,
        out_width=args.out_width,
        num_embeddings=args.num_embeddings,
        embedding_dim=args.embedding_dim,
        window_size=args.window_size,
        num_residues=args.num_residues,
        graph_mode=args.graph_mode,
        max_edges=args.max_edges,
        scatter_mode="blocked" if args.edge_layout == "blocked" else "auto",
        compute_dtype=args.compute_dtype,
        predict_delta=args.predict_delta,
        predict_prior=args.predict_prior,
        prior_damping=args.prior_damping,
        head_init=args.head_init,
        head_scale=args.head_scale,
        kernel_init_scale=args.kernel_init_scale,
        window_diff=args.window_diff,
        window_diff_scale=args.window_diff_scale,
        electrostatics=args.electrostatics,
    )
    data = DataConfig(
        data_path=str(args.data_path),
        node_features_path=(
            str(args.node_features_path) if args.node_features_path else None
        ),
        window_size=args.window_size,
        horizon=args.horizon,
        split_pct=args.split_pct,
    )
    # the curriculum's known-stable recipe (gradient clipping and the
    # non-finite update guard) unless the flags say otherwise
    curriculum = args.rollout_steps > 0
    clip = args.grad_clip_norm if args.grad_clip_norm is not None else (
        1.0 if curriculum else 0.0)
    skip_nf = args.skip_nonfinite if args.skip_nonfinite is not None else (
        curriculum)
    train = TrainConfig(
        rollout_steps=args.rollout_steps,
        loss_space=args.loss_space,
        noise_std=args.noise_std,
        grad_clip_norm=clip,
        skip_nonfinite_updates=skip_nf,
        grad_accum=args.grad_accum,
        seed=args.seed,
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        scheduler_step=args.scheduler_step,
        scheduler_gamma=args.scheduler_gamma,
        run_path=str(args.run_path),
        generate_movie=args.generate_movie,
        num_movie_frames=args.num_movie_frames,
        plot_latent=args.plot_latent,
        plot_per_epochs=args.plot_per_epochs,
        latent_frames=args.latent_frames,
        log_wandb=args.wandb,
    )
    return model, data, train


class _Ranks:
    """Where this process stands in a ``--data_parallel`` run: ``mesh``
    (None in one process) and whether it is rank 0, which alone
    evaluates, logs and writes."""

    def __init__(self, args, batch_size: int):
        from molecular_dynamics_neural_operator_tpu_torch.device import (
            resolve_device,
        )
        from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (  # noqa: E501
            data_parallel_put,
            init_distributed,
            launched_world_size,
        )

        self.mesh = self.put = None
        self.rank0 = True
        if not (args.data_parallel and launched_world_size() > 1):
            self.device = resolve_device(args.device)
            return
        import torch.distributed as dist

        self.device = init_distributed(args.device)
        self.mesh, self.put = data_parallel_put(batch_size,
                                                self.device.type)
        self.rank0 = dist.get_rank() == 0

    def say(self, *msg) -> None:
        if self.rank0:
            print(*msg, flush=True)

    def check(self, params) -> None:
        """Stop the run if the ranks' parameters differ by a bit."""
        from molecular_dynamics_neural_operator_tpu_torch.parallel.mesh import (  # noqa: E501
            replicas_equal,
        )

        if self.mesh is not None and not replicas_equal(
                params, self.mesh.get_group("data")):
            raise RuntimeError("data-parallel ranks hold different "
                               "parameters after an epoch")


def _train_fno(args, traj, data_cfg, train_cfg, ranks):
    """The ``--operator fno`` run: the GKN run's data, split, checkpoint
    and metrics machinery with the FNO's distance-matrix steps. Returns
    the final ``TrainState``."""
    import numpy as np
    import torch

    from molecular_dynamics_neural_operator_tpu_torch import configs
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        batch_iterator,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        prefetch_to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
        distance_matrix_channels,
        fno_curriculum_loss,
        fno_init,
        fno_rollout_scan,
        fno_window_loss,
        make_fno_curriculum_train_step,
        make_fno_window_eval_step,
        make_fno_window_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_data_parallel_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        _read_metrics,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils import (
        BestCheckpointer,
        MetricLogger,
        restore_checkpoint,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.movie import (
        render_propagation_movie,
    )

    device = ranks.device
    run_dir = Path(train_cfg.run_path)
    cfg = configs.FNOConfig(
        width=args.fno_width, modes1=args.fno_modes, modes2=args.fno_modes,
        depth=args.fno_depth, in_channels=args.window_size,
        num_residues=traj.num_residues,
        predict_delta=args.fno_predict_delta,
        predict_prior=args.fno_predict_prior,
        prior_damping=args.prior_damping,
        head_init=args.head_init,
        head_scale=args.head_scale,
    )
    if ranks.rank0:
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.json").write_text(configs.to_json(
            configs.ExperimentConfig(fno=cfg, data=data_cfg,
                                     train=train_cfg)))
    ds = WindowDataset(traj, window_size=args.window_size,
                       horizon=data_cfg.horizon, graph_mode="none")
    tr_idx, va_idx = train_valid_split(len(ds), data_cfg.split_pct,
                                       data_cfg.split_method)
    steps_per_epoch = max(1, len(tr_idx) // train_cfg.batch_size)
    tx, _ = make_optimizer(
        train_cfg.lr, train_cfg.weight_decay, train_cfg.scheduler_step,
        train_cfg.scheduler_gamma, steps_per_epoch,
        grad_clip_norm=train_cfg.grad_clip_norm,
        skip_nonfinite_updates=train_cfg.skip_nonfinite_updates,
        grad_accum=train_cfg.grad_accum,
    )
    params = fno_init(cfg, seed=train_cfg.seed, device=device)
    state = TrainState(params, tx.init(params), 0, train_cfg.seed)
    start_epoch = 0
    if args.resume is not None:
        state, meta = restore_checkpoint(args.resume, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        ranks.say(f"Resumed from {args.resume} at epoch {start_epoch}")
    if ranks.mesh is not None:
        loss = (fno_curriculum_loss(cfg, train_cfg.rollout_steps)
                if train_cfg.rollout_steps > 0 else fno_window_loss(cfg))
        step, _ = make_data_parallel_step(
            loss, tx, ranks.mesh, name="data-parallel FNO train step")
        ranks.say(f"FNO data parallelism: batch sharded over "
                  f"{ranks.mesh.size()} devices")
    elif train_cfg.rollout_steps > 0:
        step = make_fno_curriculum_train_step(
            cfg, tx, rollout_steps=train_cfg.rollout_steps)
    else:
        step = make_fno_window_train_step(cfg, tx)
    if train_cfg.rollout_steps > 0:
        ranks.say(f"FNO curriculum training: K={train_cfg.rollout_steps} "
                  "rollout steps in the loss")
    eval_step = make_fno_window_eval_step(cfg)
    if ranks.rank0:
        logger = MetricLogger(run_dir, use_wandb=train_cfg.log_wandb,
                              config=vars(args))
        ckpt = BestCheckpointer(run_dir, resume=args.resume is not None)
    ranks.say(f"FNO training: {len(ds)} windows, R={traj.num_residues}, "
              f"on {device}")

    def mean_loss(metrics, empty: float) -> float:
        """Mean rel_l2 over the loop's steps, read from the device once."""
        if not metrics:
            return empty
        return sum(m["rel_l2"] for m in _read_metrics(metrics)) / len(metrics)

    for epoch in range(start_epoch, train_cfg.epochs):
        t0 = time.time()
        acc = []
        for batch in prefetch_to_device(
                batch_iterator(ds, tr_idx, train_cfg.batch_size,
                               seed=train_cfg.seed, epoch=epoch,
                               rollout_horizon=train_cfg.rollout_steps),
                size=args.prefetch_factor, put=ranks.put, device=device):
            state, m = step(state, batch)
            acc.append(m)
        tr_loss = mean_loss(acc, 0.0)
        ranks.check(state.params)
        if not ranks.rank0:
            continue
        # the remainder batch is kept: with drop_last a validation split
        # smaller than a batch would read as a loss of 0.0
        acc = [eval_step(state.params, batch) for batch in prefetch_to_device(
            batch_iterator(ds, va_idx, train_cfg.batch_size, shuffle=False,
                           drop_last=False), size=2, device=device)]
        va_loss = mean_loss(acc, float("nan"))

        extra = {}
        if (train_cfg.generate_movie and train_cfg.plot_per_epochs > 0
                and epoch % train_cfg.plot_per_epochs == 0):
            lo = int(va_idx[0])
            ch0 = distance_matrix_channels(torch.as_tensor(
                traj.positions[lo : lo + args.window_size], device=device))
            with torch.no_grad():
                preds, _ = fno_rollout_scan(state.params, cfg, ch0,
                                            train_cfg.num_movie_frames)
            fc = [(p < data_cfg.threshold).astype(np.float32)
                  for p in preds.cpu().numpy()]
            real = []
            for i in range(train_cfg.num_movie_frames):
                idx = min(lo + args.window_size + i, traj.num_frames - 1)
                d = np.linalg.norm(traj.positions[idx][:, None]
                                   - traj.positions[idx][None], axis=-1)
                real.append((d < data_cfg.threshold).astype(np.float32))
            extra["movie"] = str(
                render_propagation_movie(run_dir, epoch, fc, real))

        logger.log_epoch(epoch, time.time() - t0, tr_loss, va_loss, extra)
        ckpt.update(epoch, va_loss, state)
    if ranks.rank0:
        logger.close()
    return state


def _train_fno3d(args, traj, data_cfg, train_cfg, ranks):
    """The ``--operator fno3d`` run: the GKN run's data, split, checkpoint
    and metrics machinery with FNO-3d's block steps through
    ``train_epoch``. Returns the final ``TrainState``."""
    from molecular_dynamics_neural_operator_tpu_torch import configs
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        batch_iterator,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        prefetch_to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models.fno3d import (
        fno3d_init,
        make_fno3d_eval_step,
        make_fno3d_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_epoch,
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        _read_metrics,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils import (
        BestCheckpointer,
        MetricLogger,
        restore_checkpoint,
    )

    if ranks.mesh is not None:
        raise ValueError("--operator fno3d trains on one device; drop "
                         "--data_parallel")
    device = ranks.device
    run_dir = Path(train_cfg.run_path)
    cfg = configs.FNO3dConfig(
        width=args.fno3d_width, modes1=args.fno3d_modes,
        modes2=args.fno3d_modes, modes3=args.fno3d_modes3,
        depth=args.fno3d_depth, in_frames=args.window_size,
        out_frames=args.fno3d_out_frames, num_residues=traj.num_residues)
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(configs.to_json(
        configs.ExperimentConfig(data=data_cfg, train=train_cfg)))
    (run_dir / "fno3d.json").write_text(configs.to_json(cfg))
    ds = WindowDataset(traj, window_size=args.window_size,
                       horizon=data_cfg.horizon, graph_mode="none")
    tr_idx, va_idx = train_valid_split(len(ds), data_cfg.split_pct,
                                       data_cfg.split_method)
    tx, _ = make_optimizer(
        train_cfg.lr, train_cfg.weight_decay, train_cfg.scheduler_step,
        train_cfg.scheduler_gamma,
        max(1, len(tr_idx) // train_cfg.batch_size),
        grad_clip_norm=train_cfg.grad_clip_norm,
        skip_nonfinite_updates=train_cfg.skip_nonfinite_updates,
        grad_accum=train_cfg.grad_accum)
    params = fno3d_init(cfg, seed=train_cfg.seed, device=device)
    state = TrainState(params, tx.init(params), 0, train_cfg.seed)
    start_epoch = 0
    if args.resume is not None:
        state, meta = restore_checkpoint(args.resume, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        print(f"Resumed from {args.resume} at epoch {start_epoch}")
    step = make_fno3d_train_step(cfg, tx)
    eval_step = make_fno3d_eval_step(cfg)
    logger = MetricLogger(run_dir, use_wandb=train_cfg.log_wandb,
                          config=vars(args))
    ckpt = BestCheckpointer(run_dir, resume=args.resume is not None)
    print(f"FNO-3d training: {len(ds)} windows, R={traj.num_residues}, "
          f"{cfg.in_frames} frames in and {cfg.out_frames} out, on {device}",
          flush=True)
    for epoch in range(start_epoch, train_cfg.epochs):
        t0 = time.time()
        state, metrics = train_epoch(
            state, step, ds, tr_idx, train_cfg.batch_size,
            seed=train_cfg.seed, epoch=epoch, rollout_horizon=cfg.out_frames,
            prefetch=args.prefetch_factor)
        acc = [eval_step(state.params, batch) for batch in prefetch_to_device(
            batch_iterator(ds, va_idx, train_cfg.batch_size, shuffle=False,
                           drop_last=False, rollout_horizon=cfg.out_frames),
            size=2, device=device)]
        va_loss = (sum(m["rel_l2"] for m in _read_metrics(acc)) / len(acc)
                   if acc else float("nan"))
        logger.log_epoch(epoch, time.time() - t0, metrics["rel_l2"], va_loss)
        ckpt.update(epoch, va_loss, state)
    logger.close()
    return state


def train_from_trajectory(args, traj):
    """Everything of ``main`` after the trajectory is loaded: the run
    directory, the dataset and split, the train state (or ``--resume``),
    the epoch loop with its movie, latents, metrics and checkpoints.
    Returns the final ``TrainState``; ``--operator fno`` trains the FNO
    (``_train_fno``)."""
    import numpy as np

    from molecular_dynamics_neural_operator_tpu_torch import configs
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_sharded_curriculum_train_step,
        make_sharded_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        eval_epoch,
        make_curriculum_train_step,
        make_eval_step,
        make_train_step,
        train_epoch,
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils import (
        BestCheckpointer,
        MetricLogger,
        restore_checkpoint,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.latent import (
        collect_latents,
        log_latent_visualization,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.movie import (
        make_propagation_movie,
        select_starting_points,
    )

    model_cfg, data_cfg, train_cfg = build_configs(args)
    ranks = _Ranks(args, train_cfg.batch_size)
    device, say = ranks.device, ranks.say
    if args.compilation_cache is not None:
        say("NOTE: --compilation_cache has no counterpart in the PyTorch "
              "port (the CUDA kernels are built once into the package's "
              "build/ directory); ignoring it")
    for name in ("num_data_workers", "persistent_workers", "non_blocking"):
        if getattr(args, name):
            say(f"WARNING: --{name} accepted for reference CLI "
                  "compatibility but is a no-op: host batches flow through "
                  "the in-process prefetch_to_device queue "
                  "(--prefetch_factor sets its depth)")

    if args.operator == "fno":
        return _train_fno(args, traj, data_cfg, train_cfg, ranks)
    if args.operator == "fno3d":
        return _train_fno3d(args, traj, data_cfg, train_cfg, ranks)

    run_dir = Path(train_cfg.run_path)
    if ranks.rank0:
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "config.json").write_text(configs.to_json(
            configs.ExperimentConfig(model=model_cfg, data=data_cfg,
                                     train=train_cfg)))

    dataset = WindowDataset(
        traj,
        window_size=model_cfg.window_size,
        horizon=data_cfg.horizon,
        threshold=data_cfg.threshold,
        graph_mode=model_cfg.graph_mode,
        max_edges=model_cfg.max_edges,
        edge_layout=args.edge_layout,
    )
    say(f"Created dataset: {len(dataset)} windows, "
        f"{traj.num_residues} residues")

    tr_idx, va_idx = train_valid_split(
        len(dataset), data_cfg.split_pct, data_cfg.split_method,
        seed=train_cfg.seed,
    )
    steps_per_epoch = max(1, len(tr_idx) // train_cfg.batch_size)
    state, tx, _ = create_train_state(
        train_cfg.seed, model_cfg, train_cfg,
        steps_per_epoch=steps_per_epoch, device=device,
    )

    start_epoch = 0
    if args.resume is not None:
        state, meta = restore_checkpoint(args.resume, state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        say(f"Resumed from {args.resume} at epoch {start_epoch}")

    if train_cfg.loss_space != "absolute" and train_cfg.rollout_steps == 0:
        # the teacher-forced steps implement only the reference LpLoss
        raise SystemExit(
            f"--loss_space {train_cfg.loss_space} requires the curriculum "
            f"path: pass --rollout_steps K >= 1 (K=1 is teacher-forced "
            f"with the delta normalizer)"
        )
    if train_cfg.rollout_steps > 0:
        coord_clip = args.coord_clip if args.coord_clip > 0 else None
        grad_steps = args.grad_steps if args.grad_steps > 0 else None
        opts = dict(rollout_steps=train_cfg.rollout_steps,
                    threshold=data_cfg.threshold, coord_clip=coord_clip,
                    loss_space=train_cfg.loss_space, grad_steps=grad_steps,
                    noise_std=train_cfg.noise_std,
                    burnin_dtype=args.burnin_dtype,
                    unroll_scans=args.unroll_scans)
        if ranks.mesh is not None:
            train_step, _ = make_sharded_curriculum_train_step(
                model_cfg, tx, ranks.mesh, **opts)
            say(f"Data-parallel curriculum: batch sharded over "
                f"{ranks.mesh.size()} devices")
        else:
            train_step = make_curriculum_train_step(model_cfg, tx, **opts)
        say(f"Curriculum training: K={train_cfg.rollout_steps} rollout "
              f"steps in the loss (grad_clip={train_cfg.grad_clip_norm}, "
              f"skip_nonfinite={train_cfg.skip_nonfinite_updates}, "
              f"coord_clip={coord_clip}, grad_steps="
              f"{grad_steps or train_cfg.rollout_steps}, "
              f"noise_std={train_cfg.noise_std})")
    elif ranks.mesh is not None:
        train_step, _ = make_sharded_train_step(
            model_cfg, tx, ranks.mesh, noise_std=train_cfg.noise_std)
        say(f"Data parallelism: batch sharded over {ranks.mesh.size()} "
            "devices")
    else:
        train_step = make_train_step(model_cfg, tx,
                                     noise_std=train_cfg.noise_std)
    eval_step = make_eval_step(model_cfg)
    say(f"Initialized model on {device} "
        f"(train_conv_impl={model_cfg.train_conv_impl})")

    if ranks.rank0:
        logger = MetricLogger(run_dir, use_wandb=train_cfg.log_wandb,
                              config=vars(args))
        ckpt = BestCheckpointer(run_dir, resume=args.resume is not None)
    starting_points = select_starting_points(
        len(va_idx), model_cfg.window_size
    )
    if ranks.rank0 and train_cfg.plot_latent and traj.rmsd is not None:
        import pickle

        n_lat = min(train_cfg.latent_frames, len(va_idx))
        color_dict = {
            "RMSD": np.asarray(traj.rmsd[va_idx[0] : va_idx[0] + n_lat])
        }
        (run_dir / "latent_color_dict.pkl").write_bytes(
            pickle.dumps(color_dict)
        )
    say("Started training")

    for epoch in range(start_epoch, train_cfg.epochs):
        t0 = time.time()
        profile_ctx = None
        if args.profile and epoch == start_epoch and ranks.rank0:
            from molecular_dynamics_neural_operator_tpu_torch.utils.profiling import (  # noqa: E501
                trace,
            )

            profile_ctx = trace(str(run_dir / "trace"))
            profile_ctx.__enter__()
        state, train_m = train_epoch(
            state, train_step, dataset, tr_idx, train_cfg.batch_size,
            seed=train_cfg.seed, epoch=epoch,
            rollout_horizon=train_cfg.rollout_steps,
            prefetch=args.prefetch_factor, put=ranks.put,
        )
        ranks.check(state.params)
        if not ranks.rank0:
            continue
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
            print(f"profiler trace written to {run_dir / 'trace'}")
        valid_m = eval_epoch(
            state.params, eval_step, dataset, va_idx, train_cfg.batch_size,
        )
        extra = {
            "avg_train_mse": train_m["mse"],
            "avg_valid_mse": valid_m["mse"],
            "steps_per_sec": train_m["steps_per_sec"],
            "examples_per_sec": train_m["examples_per_sec"],
        }

        if (train_cfg.generate_movie and train_cfg.plot_per_epochs > 0
                and epoch % train_cfg.plot_per_epochs == 0):
            movie = make_propagation_movie(
                state.params, model_cfg, dataset, run_dir, epoch,
                [int(va_idx[0] + s) for s in starting_points],
                num_steps=train_cfg.num_movie_frames,
            )
            extra["movie"] = str(movie)
        if (train_cfg.plot_latent and train_cfg.plot_per_epochs > 0
                and epoch % train_cfg.plot_per_epochs == 0):
            n_lat = min(train_cfg.latent_frames, len(va_idx))
            latents = collect_latents(
                state.params, model_cfg, dataset, int(va_idx[0]), n_lat
            )
            colors = {}
            if traj.rmsd is not None:
                colors["RMSD"] = traj.rmsd[va_idx[0] : va_idx[0] + n_lat]
            for method in ("PCA", "TSNE") if n_lat > 16 else ("PCA",):
                paths = log_latent_visualization(
                    latents, colors, run_dir, epoch, method
                )
                extra.update({f"{method}_{k}": str(v)
                              for k, v in paths.items()})

        logger.log_epoch(
            epoch, time.time() - t0, train_m["rel_l2"], valid_m["rel_l2"],
            extra,
        )
        ckpt.update(epoch, valid_m["rel_l2"], state)

    if ranks.rank0:
        logger.close()
    return state


def main(argv=None):
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        load_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        resolve_device,
    )

    args = parse_args(argv)
    resolve_device(args.device)
    if not args.data_path.exists():
        raise ValueError(f"data_path does not exist: {args.data_path}")
    traj = load_trajectory(
        args.data_path,
        node_feature_dset_path=args.node_features_path,
        max_frames=args.max_frames,
    )
    return train_from_trajectory(args, traj)


if __name__ == "__main__":
    main()
