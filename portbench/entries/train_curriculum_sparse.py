"""The K-step rollout curriculum on the sparse padded edge list on one
card, as ``cli/train.py --graph_mode sparse --max_edges 256
--train_conv_impl pallas --rollout_steps K --loss_space delta`` composes
it: ``entries/train_curriculum.py``'s set-up, window and readings on a
graph of ``max_edges`` slots, where every model step's conv stack is the
training kernels (``ops/cuda/train_conv.py``: K forward launches and,
through autograd, K backward launches a step) and each rebuilt graph
keeps its first slots in row-major order and flags an overflow past
them. The judgement holds the first ``check.steps`` steps against
``reference/curriculum_sparse.py`` and the program's overflow flags
against the reference's."""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench.entries import _rollout
from portbench.entries import train_curriculum as dense
from portbench.entries.train_steps import _tree_clone
from portbench.reference import curriculum_sparse as ref

CLIP, GRAD_CLIP = dense.CLIP, dense.GRAD_CLIP
rows = dense.rows
window = dense.window
release = dense.release
end_to_end = dense.end_to_end
work = dense.work


def setup(run) -> None:
    """``train_curriculum.setup``, recording each checked step's edge
    overflow flag beside its loss."""
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
    rec = {"losses": [], "overflows": []}

    def recording(st, batch):
        new, metrics = step(st, batch)
        rec["losses"].append(metrics["rel_l2"].clone())
        rec["overflows"].append(metrics["edge_overflow"].clone())
        if len(rec["losses"]) == 1:
            rec["mu1"] = _tree_clone(new.opt_state.mu)
        if len(rec["losses"]) == n:
            rec["params"] = _tree_clone(new.params)
        return new, metrics

    state, _ = train_epoch(state, recording, ds, order[:n * b], b,
                           shuffle=False, rollout_horizon=k)
    rec["losses"] = [float(x) for x in rec["losses"]]
    rec["overflows"] = [bool(x) for x in rec["overflows"]]
    run.recorded = rec
    run.state = {"state": state, "step": step, "ds": ds, "rows": order,
                 "train_epoch": train_epoch}


def batches(run) -> list:
    """The first steps' batches as the reference reads them: window
    (B, T, R, 3), y_seq (B, K, R, 3) and the stored contacts of each
    window's first frame in ``max_edges`` padded slots with their mask."""
    out = dense.batches(run)
    e = run.model["max_edges"]
    b = run.mix["batch_size"]
    for batch in out:
        edges = np.zeros((b, 2, e), np.int64)
        mask = np.zeros((b, e), np.float32)
        for i, c in enumerate(batch.pop("contacts")):
            n = min(c.shape[1], e)
            edges[i, :, :n] = c[:, :n]
            mask[i, :n] = 1.0
        batch["edges"] = torch.as_tensor(edges, device=run.device)
        batch["mask"] = torch.as_tensor(mask, device=run.device)
    return out


def reference(run, rounding=None) -> dict:
    """The reference's steps from the run's weights and batches."""
    mix = run.mix
    return ref.train(run.params, run.model, run.aa, batches(run), mix["lr"],
                     mix["weight_decay"], run.model["threshold"], CLIP,
                     GRAD_CLIP, rounding, mix["check"].get("chunk", 32))


def judge(run) -> list:
    """The first step's loss, the first gradient as Adam took it and the
    weights' change after the steps, by the worst leaf, against the
    reference (``train_curriculum.readings``); the checked steps' edge
    overflow flags against the reference's; the window's last loss
    finite."""
    want = reference(run)
    mine = dense.readings(run, run.recorded, want)
    wrong = sum(a != b for a, b in zip(run.recorded["overflows"],
                                       want["overflows"]))
    finite = bool(np.isfinite(run.last_loss))
    print(f"later steps' loss gaps (not compared): "
          f"{mine['later_loss_gaps']}", file=sys.stderr)
    lim = run.config["limits"]
    return [("last_loss_finite", int(finite), 1, finite),
            ("overflow_flags_wrong", wrong, 0, wrong == 0)] + [
        (k, mine[k], lim[k], mine[k] <= lim[k])
        for k in ("loss_gap", "grad_gap", "move_gap")]
