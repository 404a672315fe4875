"""Teacher-forced training: ``train/loop.py::train_epoch`` (its
``data/prefetch.py`` producer thread and the native packer of
``data/windows.py``) over ``train/loop.py::make_train_step`` on one card,
or, with ``ranks`` > 1 in the mix, over ``parallel/mesh.py::
make_sharded_train_step`` on that many NCCL ranks with a card each, as
``cli/train.py --data_parallel`` composes them (the global batch split
over the ranks, one SUM all-reduce of every gradient a step). The step
is a CUDA graph a batch shape (``train/graphed.py``) with the training
kernels (``train_conv_impl="pallas"``).

With several ranks the process that prints is rank 0: it spawns the
others (``portbench.run`` with ``--rank``), which join through a
rendezvous file in a fresh directory under ``TMPDIR``, run the same
set-up, window and judgement, and send their readings to rank 0; rank 0
decides after each epoch whether the window goes on, for all.

Set-up builds one train state from the seed's weights and drives it
through its first ``check.steps`` steps by the window's own call, a
``train_epoch`` over rows that all differ, recording each step's loss,
the Adam first moment after step 1 and the weights after the last; the
window then trains that same state epoch after epoch, each a ``train_epoch``
over every row in an order drawn from the seed and the epoch."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from portbench.entries import _rollout
from portbench.reference import train as ref
from portbench.traffic import generate


def _tree_clone(tree):
    if isinstance(tree, dict):
        return {k: _tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def setup(run) -> None:
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        TrainConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
        TrajectoryData,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
        train_epoch,
    )

    mix = run.mix
    ranks = mix.get("ranks", 1)
    run.group = None
    if ranks > 1:
        _join(run, ranks)
    _rollout.inputs(run)
    cfg = _rollout.model_config(run)
    inp = run.inputs
    b = mix["batch_size"]
    traj = TrajectoryData(positions=inp["positions"],
                          edge_indices=inp["contacts"],
                          aminoacids=inp["aa"],
                          rmsd=np.zeros(len(inp["positions"]), np.float32))
    ds = WindowDataset(traj, window_size=cfg.window_size, horizon=1,
                       threshold=run.model["threshold"], graph_mode="sparse",
                       max_edges=cfg.max_edges)
    tcfg = TrainConfig(batch_size=b, lr=mix["lr"],
                       weight_decay=mix["weight_decay"])
    rows = inp["rows"]
    state, tx, _ = create_train_state(0, cfg, tcfg,
                                      steps_per_epoch=len(rows) // b,
                                      device=run.device, params=run.params)
    put = None
    if run.group is not None:
        from molecular_dynamics_neural_operator_tpu_torch.parallel import (
            data_parallel_put,
            make_sharded_train_step,
        )

        mesh, put = data_parallel_put(b, run.device.type)
        step, _ = make_sharded_train_step(cfg, tx, mesh)
    else:
        step = make_train_step(cfg, tx)
    n = mix["check"]["steps"]
    rec = {"p0": _tree_clone(state.params), "losses": []}

    def recording(st, batch):
        new, metrics = step(st, batch)
        rec["losses"].append(metrics["rel_l2"].clone())
        if len(rec["losses"]) == 1:
            rec["mu1"] = _tree_clone(new.opt_state.mu)
        if len(rec["losses"]) == n:
            rec["params"] = _tree_clone(new.params)
        return new, metrics

    state, _ = train_epoch(state, recording, ds, rows[:n * b], b,
                           shuffle=False, put=put)
    rec["losses"] = [float(x) for x in rec["losses"]]
    run.recorded = rec
    run.state = {"state": state, "step": step, "ds": ds, "put": put,
                 "train_epoch": train_epoch}


def _join(run, ranks: int) -> None:
    """Join (rank 0: spawn first) the ranks' process group. Each rank
    keeps one host thread for PyTorch's CPU operations, as ``torchrun``
    sets ``OMP_NUM_THREADS=1`` for the ranks it launches."""
    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        init_distributed,
    )

    torch.set_num_threads(1)
    if run.rank is None:
        run.rank, run.world = 0, ranks
        run.rdzv = os.path.join(tempfile.mkdtemp(prefix="portbench-"),
                                "rendezvous")
        logs = run.root / "portbench" / "out"
        logs.mkdir(parents=True, exist_ok=True)
        run.workers = []
        for r in range(1, ranks):
            cmd = [sys.executable, "-m", "portbench.run",
                   "--workload", run.cell["name"], "--seed", str(run.seed),
                   "--seconds", str(run.seconds),
                   "--trace", str(int(run.trace_on)), "--rank", str(r),
                   "--world", str(ranks), "--rdzv", run.rdzv,
                   "--device", run.device.type]
            with open(logs / f"rank{r}.log", "w") as log:
                run.workers.append(subprocess.Popen(
                    cmd, cwd=run.root, stdout=subprocess.DEVNULL,
                    stderr=log, env=dict(os.environ, OMP_NUM_THREADS="1")))
    run.device = init_distributed(run.device.type,
                                  init_method=f"file://{run.rdzv}",
                                  rank=run.rank, world_size=run.world)
    run.group = dist.group.WORLD


def window(run, deadline: float) -> None:
    st = run.state
    b, rows = run.mix["batch_size"], run.inputs["rows"]
    seed = generate.seeds(run.seed)[3]
    state, epoch, samples, last = st["state"], 0, 0, None
    while True:
        state, last = st["train_epoch"](state, st["step"], st["ds"], rows, b,
                                        shuffle=True, seed=seed, epoch=epoch,
                                        put=st["put"])
        samples += (len(rows) // b) * b
        epoch += 1
        if not _go_on(run, time.perf_counter() < deadline):
            break
    st["state"] = state
    run.samples, run.steps = samples, samples // b
    run.last_loss = last["rel_l2"]
    run.attempted = epoch
    run.failed = 0 if np.isfinite(run.last_loss) else epoch


def _go_on(run, mine: bool) -> bool:
    """Rank 0's decision, the same on every rank."""
    if run.group is None:
        return mine
    import torch.distributed as dist

    flag = torch.tensor([float(mine)], device=run.device)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def _gather(run, value):
    """``value`` of every rank, on every rank (one value without ranks)."""
    if run.group is None:
        return [value]
    import torch.distributed as dist

    out = [None] * run.world
    dist.all_gather_object(out, value)
    return out


def release(run) -> None:
    run.state = None


def finish(run) -> None:
    """Leave the process group; rank 0 waits for the ranks it spawned."""
    if run.group is None:
        return
    import torch.distributed as dist

    dist.destroy_process_group()
    failed = []
    for r, proc in enumerate(getattr(run, "workers", []), start=1):
        try:
            if proc.wait(timeout=120):
                failed.append(r)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failed.append(r)
    if failed:
        raise RuntimeError(f"ranks {failed} failed (portbench/out/rank*.log)")


def end_to_end(run) -> dict:
    return {"train_samples_per_s": run.samples / run.window_s}


def batches(run) -> list:
    """The first steps' batches, made from the inputs as the reference
    reads them: window (B, T, R, 3), y, the stored contacts of each
    window's first frame padded to the slots, and their mask."""
    inp, b, t = run.inputs, run.mix["batch_size"], run.model["window_size"]
    e = run.model["max_edges"]
    out = []
    for k in range(run.mix["check"]["steps"]):
        idx = inp["rows"][k * b:(k + 1) * b]
        pos = inp["positions"]
        edges = np.zeros((b, 2, e), np.int64)
        mask = np.zeros((b, e), np.float32)
        for i, f in enumerate(idx):
            c = inp["contacts"][f]
            edges[i, :, :c.shape[1]] = c
            mask[i, :c.shape[1]] = 1.0
        dev = run.device
        out.append({
            "window": torch.as_tensor(
                np.stack([pos[f:f + t] for f in idx]), device=dev),
            "y": torch.as_tensor(pos[idx + t], device=dev),
            "edges": torch.as_tensor(edges, device=dev),
            "mask": torch.as_tensor(mask, device=dev)})
    return out


def readings(run, got: dict, rounding=None) -> dict:
    """The three numbers of a training run ``got`` (losses, the first
    Adam moment, the weights after the steps) against the reference's
    steps from the same weights and batches."""
    mix = run.mix
    want = ref.train(run.params, run.model, run.aa, batches(run), mix["lr"],
                     mix["weight_decay"], rounding=None)
    p0 = dict(ref.leaves(run.params))
    grad = {k: v / (1 - ref.B1) - mix["weight_decay"] * p0[k]
            for k, v in ref.leaves(got["mu1"])}
    moved = {k: v - p0[k] for k, v in ref.leaves(got["params"])}
    ref_moved = {k: v - p0[k] for k, v in want["params"].items()}
    counted = ref.moving_leaves(want["grad1"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 want["losses"])]
    return {"loss_gap": gaps[0], "later_loss_gaps": gaps[1:],
            "grad_gap": ref.leaf_gaps(grad, want["grad1"], counted),
            "move_gap": ref.leaf_gaps(moved, ref_moved, counted),
            "leaves_counted": len(counted)}


def judge(run) -> list:
    """The first step's loss, the first gradient as Adam got it (its
    first moment after step 1 over 1 - b1, less the L2 decay of the
    starting weights) and the weights' change after the steps, by the
    worst leaf, against the reference; the window's last loss finite.
    The later steps' losses are printed, not compared: Adam moves every
    weight by about the learning rate whatever its gradient's size, so a
    rounding that flips a small gradient's sign moves the two runs apart
    and their later losses swing from seed to seed (``PERF.md``)."""

    mine = readings(run, run.recorded)
    mine["finite"] = bool(np.isfinite(run.last_loss))
    mine["peak"] = run.memory_peak
    every = _gather(run, mine)
    run.memory_peak = max(g["peak"] for g in every)
    print(f"later steps' loss gaps (not compared): "
          f"{[g['later_loss_gaps'] for g in every]}", file=sys.stderr)
    lim = run.config["limits"]
    finite = all(g["finite"] for g in every)
    worst = {k: max(g[k] for g in every)
             for k in ("loss_gap", "grad_gap", "move_gap")}
    return [("last_loss_finite", int(finite), 1, finite)] + [
        (k, worst[k], lim[k], worst[k] <= lim[k]) for k in worst]


def work(run) -> None:
    """The steps of the window and their real edges, from the stored
    contacts of every row's first frame (each epoch takes every row)."""
    counts = np.array([c.shape[1] for c in run.inputs["contacts"]])
    rows = run.inputs["rows"]
    per_epoch = counts[rows[:(len(rows) // run.mix["batch_size"])
                            * run.mix["batch_size"]]].sum()
    run.work["train_steps"] = run.steps
    run.work["train_real_edges"] = float(per_epoch) * run.attempted
    run.work["batch_size"] = run.mix["batch_size"]
    if run.trace is not None:
        busy = _gather(run, run.trace.busy_s)
        run.busy_s = sum(busy) / len(busy)
