"""The K-step rollout curriculum on one card, as ``cli/train.py
--rollout_steps K --loss_space delta`` composes it: ``train/loop.py::
train_epoch`` (its ``data/prefetch.py`` producer and the native packer of
``data/windows.py``, batches carrying ``y_seq``) over ``train/
curriculum.py::make_curriculum_train_step`` with every step supervised,
the coordinate clip 1000 and the CLI's curriculum recipe (gradient clip
1.0, non-finite updates skipped). The step is a CUDA graph
(``train/graphed.py``) with the K rebuilds inside; on the dense graph
each model step runs the edge MLP over all B * R^2 pairs.

Set-up builds one train state from the seed's weights and drives it
through its first ``check.steps`` steps by the window's own call, a
``train_epoch`` over rows that all differ, recording each step's loss,
the Adam first moment after step 1 and the weights after the last; the
window then trains that same state epoch after epoch over every row
whose K-step continuation the trajectory holds, in an order drawn from
the seed and the epoch. The program's counters over the window
(``utils/profiling.py::counters``) are kept for the readers."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench.entries import _rollout
from portbench.entries.train_steps import _tree_clone
from portbench.reference import curriculum as ref
from portbench.reference import train as ref_train
from portbench.traffic import generate

CLIP = 1000.0          # cli/train.py --coord_clip
GRAD_CLIP = 1.0        # cli/train.py's gradient clip with the curriculum


def _counters() -> dict:
    """The program's counters, where the program has them."""
    from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def rows(run) -> np.ndarray:
    """The mix's rows whose K-step continuation the trajectory holds, in
    the mix's order (``batch_iterator`` drops the others)."""
    k, t = run.mix["rollout_steps"], run.model["window_size"]
    limit = run.inputs["positions"].shape[0] - t - k
    r = run.inputs["rows"]
    return r[r <= limit]


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
        make_curriculum_train_step,
        train_epoch,
    )

    mix = run.mix
    _rollout.inputs(run)
    cfg = _rollout.model_config(run)
    inp = run.inputs
    b, k = mix["batch_size"], mix["rollout_steps"]
    traj = TrajectoryData(positions=inp["positions"],
                          edge_indices=inp["contacts"],
                          aminoacids=inp["aa"],
                          rmsd=np.zeros(len(inp["positions"]), np.float32))
    ds = WindowDataset(traj, window_size=cfg.window_size, horizon=1,
                       threshold=run.model["threshold"],
                       graph_mode=cfg.graph_mode, max_edges=cfg.max_edges)
    tcfg = TrainConfig(batch_size=b, lr=mix["lr"],
                       weight_decay=mix["weight_decay"], rollout_steps=k,
                       loss_space="delta", grad_clip_norm=GRAD_CLIP,
                       skip_nonfinite_updates=True)
    order = rows(run)
    state, tx, _ = create_train_state(0, cfg, tcfg,
                                      steps_per_epoch=len(order) // b,
                                      device=run.device, params=run.params)
    step = make_curriculum_train_step(cfg, tx, rollout_steps=k,
                                      threshold=run.model["threshold"],
                                      coord_clip=CLIP, loss_space="delta")
    n = mix["check"]["steps"]
    rec = {"losses": []}

    def recording(st, batch):
        new, metrics = step(st, batch)
        rec["losses"].append(metrics["rel_l2"].clone())
        if len(rec["losses"]) == 1:
            rec["mu1"] = _tree_clone(new.opt_state.mu)
        if len(rec["losses"]) == n:
            rec["params"] = _tree_clone(new.params)
        return new, metrics

    state, _ = train_epoch(state, recording, ds, order[:n * b], b,
                           shuffle=False, rollout_horizon=k)
    rec["losses"] = [float(x) for x in rec["losses"]]
    run.recorded = rec
    run.state = {"state": state, "step": step, "ds": ds, "rows": order,
                 "train_epoch": train_epoch}


def window(run, deadline: float) -> None:
    st = run.state
    b, k = run.mix["batch_size"], run.mix["rollout_steps"]
    order = st["rows"]
    seed = generate.seeds(run.seed)[3]
    state, epoch, samples, last = st["state"], 0, 0, None
    before = _counters()
    while True:
        state, last = st["train_epoch"](state, st["step"], st["ds"], order, b,
                                        shuffle=True, seed=seed, epoch=epoch,
                                        rollout_horizon=k)
        samples += (len(order) // b) * b
        epoch += 1
        if time.perf_counter() >= deadline:
            break
    after = _counters()
    run.counters = {name: v - before.get(name, 0) for name, v in after.items()
                    if v != before.get(name, 0)}
    st["state"] = state
    run.samples, run.steps = samples, samples // b
    run.last_loss = last["rel_l2"]
    run.attempted = epoch
    run.failed = 0 if np.isfinite(run.last_loss) else epoch


def release(run) -> None:
    run.state = None


def end_to_end(run) -> dict:
    return {"train_samples_per_s": run.samples / run.window_s}


def batches(run) -> list:
    """The first steps' batches as the reference reads them: window
    (B, T, R, 3), y_seq (B, K, R, 3) and the stored contact list of each
    window's first frame."""
    inp, b = run.inputs, run.mix["batch_size"]
    t, k = run.model["window_size"], run.mix["rollout_steps"]
    order, pos, dev = rows(run), inp["positions"], run.device
    out = []
    for s in range(run.mix["check"]["steps"]):
        idx = order[s * b:(s + 1) * b]
        out.append({
            "window": torch.as_tensor(
                np.stack([pos[f:f + t] for f in idx]), device=dev),
            "y_seq": torch.as_tensor(
                np.stack([pos[f + t:f + t + k] for f in idx]), device=dev),
            "contacts": [inp["contacts"][f] for f in idx]})
    return out


def reference(run, rounding=None) -> dict:
    """The reference's steps from the run's weights and batches."""
    mix = run.mix
    return ref.train(run.params, run.model, run.aa, batches(run), mix["lr"],
                     mix["weight_decay"], run.model["threshold"], CLIP,
                     GRAD_CLIP, rounding, mix["check"].get("chunk", 32))


def readings(run, got: dict, want: dict) -> dict:
    """The numbers of a training run ``got`` (losses, the first Adam
    moment, the weights after the steps) against the reference's
    ``want``: the first step's loss gap, the worst leaf's gap of the
    first gradient as Adam took it (its first moment over 1 - b1, less
    the decay of the starting weights) and of the weights' change."""
    wd = run.mix["weight_decay"]
    p0 = dict(ref_train.leaves(run.params))
    grad = {k: v / (1 - ref_train.B1) - wd * p0[k]
            for k, v in ref_train.leaves(got["mu1"])}
    moved = {k: v - p0[k] for k, v in ref_train.leaves(got["params"])}
    ref_moved = {k: v - p0[k] for k, v in want["params"].items()}
    counted = ref_train.moving_leaves(want["grad1"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 want["losses"])]
    return {"loss_gap": gaps[0], "later_loss_gaps": gaps[1:],
            "grad_gap": ref_train.leaf_gaps(grad, want["grad1"], counted),
            "move_gap": ref_train.leaf_gaps(moved, ref_moved, counted),
            "leaves_counted": len(counted)}


def judge(run) -> list:
    """The first step's loss, the first gradient as Adam took it and the
    weights' change after the steps, by the worst leaf, against the
    reference; the window's last loss finite. The later steps' losses
    are printed, not compared (``train_steps.judge`` says why)."""
    mine = readings(run, run.recorded, reference(run))
    finite = bool(np.isfinite(run.last_loss))
    print(f"later steps' loss gaps (not compared): "
          f"{mine['later_loss_gaps']}", file=sys.stderr)
    lim = run.config["limits"]
    return [("last_loss_finite", int(finite), 1, finite)] + [
        (k, mine[k], lim[k], mine[k] <= lim[k])
        for k in ("loss_gap", "grad_gap", "move_gap")]


def work(run) -> None:
    """The window's optimizer steps and the batch size; the counters are
    the program's own (``run.counters``)."""
    run.work["train_steps"] = run.steps
    run.work["batch_size"] = run.mix["batch_size"]
