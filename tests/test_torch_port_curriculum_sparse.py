"""The K = 4 rollout curriculum on the sparse padded edge list, held
against the benchmark's plain reference for it
(``portbench/reference/curriculum_sparse.py``): the loss, every gradient
leaf, the weights after one Adam step and the rebuilt graphs' overflow
flag, with the conv stack as the training kernels' plain versions
(``train_conv_impl="pallas"`` on the CPU), the delta-space loss and the
coordinate clip of ``cli/train.py``. The reference aggregates over the
real edges by ``index_add_`` and rebuilds by its own ranked pair list;
both round the products' operands and each message to bf16.

Seeded weights (``portbench/weights.py``, ``bba_1fme_sparse``'s recipe)
at width 8, kernel width 32, depth 2; windows of the benchmark's
synthetic chain at R = 28, T = 4; B = 4, K = 4; 256 edge slots (the
chain's frames hold 170 to 206 contacts at 8 A). This file imports no
JAX."""

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.data.h5 import (
    TrajectoryData,
)
from molecular_dynamics_neural_operator_tpu_torch.data.windows import (
    WindowDataset,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    TrainState,
    make_curriculum_train_step,
    make_optimizer,
)
from portbench import weights
from portbench.reference import curriculum_sparse as ref
from portbench.reference.train import leaves
from portbench.traffic import sources

R, T, B, K, E = 28, 4, 4, 4, 256
LR, WD, CLIP, CLIP_NORM = 1e-3, 5e-4, 1000.0, 1.0
MODEL = dict(width=8, ker_width=32, depth=2, window_size=T, num_residues=R,
             graph_mode="sparse", max_edges=E, compute_dtype="bfloat16",
             train_conv_impl="pallas", predict_delta=True, head_scale=0.05,
             kernel_init_scale=0.1, threshold=8.0)
RECIPE = {"kernel_init_scale": 0.1, "head_bias": "zero"}

# The program and the reference round at the same points to bf16 and sum
# in f32 in other orders; a sum that lands on a rounding boundary rounds
# the other way now and then. Measured (seeds 1 to 3): the loss 2e-8 to
# 5e-8 of itself, a gradient leaf 3.0e-3 to 3.5e-3 of the larger of its
# norm and the median leaf's, a leaf's change after one Adam step 0.043
# to 0.059 of its norm (Adam moves every element by about the learning
# rate, so a small gradient whose sign flips moves by twice it). The
# reference in fp8 reads 7.7e-5, 1.08 and 1.58.
LOSS_RTOL = 1e-6
GRAD_RTOL = 3e-2
MOVE_RTOL = 0.3


def cfg_of() -> ModelConfig:
    names = ModelConfig.__dataclass_fields__
    return ModelConfig(**{k: v for k, v in MODEL.items() if k in names})


def data(seed: int):
    """The program's batch (the packer's padded slots) and the
    reference's view of it."""
    frames, aa = sources.chain_trajectory(120, R, 13)
    traj = TrajectoryData(positions=frames,
                          edge_indices=sources.chain_contacts(frames, 8.0),
                          aminoacids=aa, rmsd=np.zeros(len(frames),
                                                       np.float32))
    ds = WindowDataset(traj, window_size=T, horizon=1, graph_mode="sparse",
                       max_edges=E)
    idx = np.random.default_rng(seed).choice(120 - T - K, B, replace=False)
    batch = {k: torch.as_tensor(v) for k, v in
             ds.get_batch(idx, rollout_horizon=K).items()}
    return batch, torch.as_tensor(aa)


def readings(seed: int, threshold: float = 8.0, rounding=None) -> dict:
    params = weights.make(MODEL, RECIPE, seed, "cpu")
    batch, aa = data(seed)
    p0 = dict(leaves(params))
    want = ref.train(params, MODEL, aa, [batch], LR, WD, threshold, CLIP,
                     CLIP_NORM, chunk=3)
    if rounding is None:
        tx, _ = make_optimizer(lr=LR, weight_decay=WD,
                               grad_clip_norm=CLIP_NORM,
                               skip_nonfinite_updates=True)
        step = make_curriculum_train_step(cfg_of(), tx, K,
                                          threshold=threshold,
                                          coord_clip=CLIP,
                                          loss_space="delta")
        new, metrics = step(TrainState(params, tx.init(params), 0, 0), batch)
        loss, over = float(metrics["rel_l2"]), bool(metrics["edge_overflow"])
        grads = {k: v / 0.1 - WD * p0[k]
                 for k, v in leaves(new.opt_state.mu)}
        moved = dict(leaves(new.params))
    else:
        low = ref.train(params, MODEL, aa, [batch], LR, WD, threshold, CLIP,
                        CLIP_NORM, rounding, chunk=3)
        loss, over = low["losses"][0], low["overflows"][0]
        grads, moved = low["grad1"], low["params"]
    norms = {k: float(v.norm()) for k, v in want["grad1"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {
        "loss": abs(loss - want["losses"][0]) / abs(want["losses"][0]),
        "grad": max(float((grads[k] - g).norm()) / max(norms[k], median)
                    for k, g in want["grad1"].items()),
        "move": max(float((moved[k] - p).norm()) / max(float(
            (p - p0[k]).norm()), 1e-30) for k, p in want["params"].items()),
        "overflow": (over, want["overflows"][0]),
    }


@pytest.mark.parametrize("seed", [1, 2])
def test_the_sparse_k4_step_matches_the_reference(seed):
    got = readings(seed)
    assert got["overflow"] == (False, False)
    assert got["loss"] <= LOSS_RTOL, got
    assert got["grad"] <= GRAD_RTOL, got
    assert got["move"] <= MOVE_RTOL, got


def test_a_rebuild_over_its_slots_is_flagged_by_both():
    """At a 10-A rebuild threshold the chain's rebuilt frames hold more
    pairs than the 256 slots: program and reference flag the step and
    train on the same truncated graphs."""
    got = readings(3, threshold=10.0)
    assert got["overflow"] == (True, True)
    assert got["loss"] <= LOSS_RTOL, got
    assert got["grad"] <= GRAD_RTOL, got


def test_the_comparison_fails_fp8_operands():
    """The reference with fp8 operands, in the program's place, fails the
    tolerances the program meets."""
    got = readings(1, rounding="fp8")
    assert (got["loss"] > LOSS_RTOL or got["grad"] > GRAD_RTOL
            or got["move"] > MOVE_RTOL), got
