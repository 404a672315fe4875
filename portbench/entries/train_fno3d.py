"""FNO-3d's block forecast on one card, as ``cli/train.py --operator
fno3d --grad_clip_norm 1.0 --skip_nonfinite`` composes it:
``train/loop.py::train_epoch`` (its ``data/prefetch.py`` producer and the
native packer of
``data/windows.py`` with no graph, each batch carrying the out_frames
continuation ``y_seq`` of its windows) over ``models/fno3d.py::
make_fno3d_train_step``, the distance matrices made on the device inside
the step, one loss over each 40-frame block, the gradient clip and the
skip of non-finite updates of the curriculum cells' recipe. The step is
a CUDA graph (``train/graphed.py``).

Set-up builds one train state from the seed's weights
(``weights_fno3d.py``) and drives it through its first ``check.steps``
steps by the window's own call, recording each step's loss, the Adam
first moment after step 1 and the weights after the last; the window
then trains that same state epoch after epoch over every row whose
out_frames continuation the trajectory holds, in an order drawn from the
seed and the epoch, and keeps the program's counters over it for the
readers. The judgement holds those steps against ``reference/fno3d.py``
at the cell's widths, ``check.chunk`` examples at a time."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from portbench import weights_fno3d
from portbench.entries import train_curriculum
from portbench.entries.train_steps import _tree_clone
from portbench.reference import fno3d as ref
from portbench.traffic import generate

GRAD_CLIP = train_curriculum.GRAD_CLIP
release = train_curriculum.release
end_to_end = train_curriculum.end_to_end
work = train_curriculum.work


def model_config(run):
    """The program's ``FNO3dConfig`` of the run's model block (its
    window_size is the input frames)."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        FNO3dConfig,
    )

    names = {f.name for f in dataclasses.fields(FNO3dConfig)}
    return FNO3dConfig(in_frames=run.model["window_size"],
                       **{k: v for k, v in run.model.items() if k in names})


def rows(run) -> np.ndarray:
    """The mix's rows whose out_frames continuation the trajectory holds,
    in the mix's order (``batch_iterator`` drops the others)."""
    t, k = run.model["window_size"], run.model["out_frames"]
    limit = run.inputs["positions"].shape[0] - t - k
    r = run.inputs["rows"]
    return r[r <= limit]


def inputs(run) -> None:
    """The seed's traffic and weights, on the run's device."""
    run.inputs = generate.make(run.mix, run.model, run.seed, run.seconds)
    run.params = weights_fno3d.make(run.model, generate.seeds(run.seed)[0],
                                    run.device)


def setup(run) -> None:
    from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
        TrajectoryData,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models.fno3d import (
        make_fno3d_train_step,
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
    b = mix["batch_size"]
    traj = TrajectoryData(positions=inp["positions"],
                          edge_indices=inp["contacts"],
                          aminoacids=inp["aa"],
                          rmsd=np.zeros(len(inp["positions"]), np.float32))
    ds = WindowDataset(traj, window_size=cfg.in_frames, horizon=1,
                       graph_mode="none")
    order = rows(run)
    tx, _ = make_optimizer(mix["lr"], mix["weight_decay"],
                           steps_per_epoch=len(order) // b,
                           grad_clip_norm=GRAD_CLIP,
                           skip_nonfinite_updates=True)
    state = TrainState(run.params, tx.init(run.params), 0, 0)
    step = make_fno3d_train_step(cfg, tx)
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
                           shuffle=False, rollout_horizon=cfg.out_frames)
    rec["losses"] = [float(x) for x in rec["losses"]]
    run.recorded = rec
    run.state = {"state": state, "step": step, "ds": ds, "rows": order,
                 "train_epoch": train_epoch}


def window(run, deadline: float) -> None:
    st = run.state
    b, k = run.mix["batch_size"], run.model["out_frames"]
    order = st["rows"]
    seed = generate.seeds(run.seed)[3]
    state, epoch, samples, last = st["state"], 0, 0, None
    before = train_curriculum._counters()
    while True:
        state, last = st["train_epoch"](state, st["step"], st["ds"], order, b,
                                        shuffle=True, seed=seed, epoch=epoch,
                                        rollout_horizon=k)
        samples += (len(order) // b) * b
        epoch += 1
        if time.perf_counter() >= deadline:
            break
    after = train_curriculum._counters()
    run.counters = {name: v - before.get(name, 0) for name, v in after.items()
                    if v != before.get(name, 0)}
    st["state"] = state
    run.samples, run.steps = samples, samples // b
    run.last_loss = last["rel_l2"]
    run.attempted = epoch
    run.failed = 0 if np.isfinite(run.last_loss) else epoch


def batches(run) -> list:
    """The first steps' batches as the reference reads them: window
    (B, T_in, R, 3) and y_seq (B, T, R, 3)."""
    inp, b = run.inputs, run.mix["batch_size"]
    t, k = run.model["window_size"], run.model["out_frames"]
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
                     mix["check"].get("chunk", 8))


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
