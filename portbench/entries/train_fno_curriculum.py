"""The FNO's K-step rollout curriculum on one card, as ``cli/train.py
--operator fno --rollout_steps K --fno_predict_delta`` composes it:
``train/loop.py::train_epoch`` (its ``data/prefetch.py`` producer and the
native packer of ``data/windows.py`` with no graph, batches carrying
``y_seq``) over ``models/fno.py::make_fno_curriculum_train_step``, every
step supervised with equal weights, the distance matrices made on the
device inside the step, and the CLI's curriculum recipe (gradient clip
1.0, non-finite updates skipped). The step is a CUDA graph
(``train/graphed.py``) with the K feedbacks inside.

Set-up builds one train state from the seed's weights
(``weights_fno.py``) and drives it through its first ``check.steps``
steps by the window's own call, recording each step's loss, the Adam
first moment after step 1 and the weights after the last; the window
(``train_curriculum.window``) then trains that same state epoch after
epoch over every row whose K-step continuation the trajectory holds, in
an order drawn from the seed and the epoch, and keeps the program's
counters over it for the readers."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from portbench import weights_fno
from portbench.entries import train_curriculum
from portbench.entries.train_steps import _tree_clone
from portbench.reference import fno as ref
from portbench.traffic import generate

GRAD_CLIP = train_curriculum.GRAD_CLIP
rows = train_curriculum.rows
window = train_curriculum.window
release = train_curriculum.release
end_to_end = train_curriculum.end_to_end
work = train_curriculum.work


def model_config(run):
    """The program's ``FNOConfig`` of the run's model block."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        FNOConfig,
    )

    names = {f.name for f in dataclasses.fields(FNOConfig)}
    return FNOConfig(**{k: v for k, v in run.model.items() if k in names})


def inputs(run) -> None:
    """The seed's traffic and weights, on the run's device."""
    run.inputs = generate.make(run.mix, run.model, run.seed, run.seconds)
    run.params = weights_fno.make(run.model, generate.seeds(run.seed)[0],
                                  run.device)


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
    from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
        make_fno_curriculum_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        TrainState,
        make_optimizer,
        train_epoch,
    )

    mix = run.mix
    inputs(run)
    cfg = model_config(run)
    inp = run.inputs
    b, k = mix["batch_size"], mix["rollout_steps"]
    traj = TrajectoryData(positions=inp["positions"],
                          edge_indices=inp["contacts"],
                          aminoacids=inp["aa"],
                          rmsd=np.zeros(len(inp["positions"]), np.float32))
    ds = WindowDataset(traj, window_size=run.model["window_size"],
                       horizon=1, graph_mode="none")
    tcfg = TrainConfig(batch_size=b, lr=mix["lr"],
                       weight_decay=mix["weight_decay"], rollout_steps=k,
                       grad_clip_norm=GRAD_CLIP, skip_nonfinite_updates=True)
    order = rows(run)
    tx, _ = make_optimizer(
        tcfg.lr, tcfg.weight_decay, tcfg.scheduler_step,
        tcfg.scheduler_gamma, len(order) // b,
        grad_clip_norm=tcfg.grad_clip_norm,
        skip_nonfinite_updates=tcfg.skip_nonfinite_updates,
        grad_accum=tcfg.grad_accum)
    state = TrainState(run.params, tx.init(run.params), 0, tcfg.seed)
    step = make_fno_curriculum_train_step(cfg, tx, rollout_steps=k)
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


def batches(run) -> list:
    """The first steps' batches as the reference reads them: window
    (B, T, R, 3) and y_seq (B, K, R, 3)."""
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
                np.stack([pos[f + t:f + t + k] for f in idx]), device=dev)})
    return out


def reference(run, rounding=None) -> dict:
    """The reference's steps from the run's weights and batches."""
    mix = run.mix
    return ref.train(run.params, run.model, batches(run), mix["lr"],
                     mix["weight_decay"], GRAD_CLIP, rounding,
                     mix["check"].get("chunk", 32))


def judge(run) -> list:
    """The first step's loss, the first gradient as Adam took it and the
    weights' change after the steps, by the worst leaf, against the
    reference (``train_curriculum.readings``); the window's last loss
    finite."""
    mine = train_curriculum.readings(run, run.recorded, reference(run))
    finite = bool(np.isfinite(run.last_loss))
    print(f"later steps' loss gaps (not compared): "
          f"{mine['later_loss_gaps']}", file=sys.stderr)
    lim = run.config["limits"]
    return [("last_loss_finite", int(finite), 1, finite)] + [
        (k, mine[k], lim[k], mine[k] <= lim[k])
        for k in ("loss_gap", "grad_gap", "move_gap")]
