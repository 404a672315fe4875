"""The K-step rollout curriculum on the dense all-pairs graph at villin's
35 residues, held against the benchmark's plain reference
(``portbench/reference/curriculum.py``), which aggregates over the
contact pairs themselves rather than over all pairs under a mask; and the
curriculum step's spans and counters (``utils/profiling.py``).

Seeded random weights (``portbench/weights.py``: uniform +-1/sqrt(fan in),
the edge kernel's last layer x0.1, the head's bias 0) at width 16,
ker_width 64, depth 2; windows of the benchmark's synthetic chain at
R = 35; B = 4, K = 3; f32 unless a test says otherwise. This file
imports no JAX."""

import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    dense_edge_features,
)
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    DenseGraph,
    gkn_apply_single,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    TrainState,
    make_curriculum_train_step,
    make_optimizer,
)
from molecular_dynamics_neural_operator_tpu_torch.train.curriculum import (
    make_curriculum_loss,
)
from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
    value_and_grad,
)
from molecular_dynamics_neural_operator_tpu_torch.utils import profiling
from portbench import weights
from portbench.reference import curriculum as ref
from portbench.reference import gkn as ref_gkn
from portbench.reference.train import leaves
from portbench.traffic import sources

R, T, B, K = 35, 10, 4, 3
THRESHOLD, CLIP = 8.0, 1000.0
LR, WD, CLIP_NORM = 1e-3, 5e-4, 1.0
MODEL = dict(width=16, ker_width=64, depth=2, window_size=T, num_residues=R,
             graph_mode="dense", compute_dtype="float32", predict_delta=True,
             head_scale=0.05, kernel_init_scale=0.1)
RECIPE = {"kernel_init_scale": 0.1, "head_bias": "zero"}

# f32 against f32, the sums taken in other orders (all pairs against the
# contacts, chunks against one batch) over three unrolled steps: the loss
# agrees to some 3e-8 of itself, so 1e-6; bf16 operands move it by 2e-5
LOSS_RTOL = 1e-6
# a gradient leaf's difference over the larger of its norm and the
# median leaf's: some 3e-7 in f32, so 1e-5; bf16 operands move it by 2e-2
GRAD_RTOL = 1e-5
# the weights after one Adam step from the same start: each element moves
# by about the learning rate (m / sqrt(v) is +-1 at step 1); in f32 the
# two agree to some 4e-7 (a few elements whose gradient is near nought),
# so 2e-3 of the learning rate; bf16 operands move them by 2e-3
MOVE_ATOL = 2e-3 * LR


def chain(seed: int):
    frames, aa = sources.chain_trajectory(200, R, 13)
    contacts = sources.chain_contacts(frames, THRESHOLD)
    idx = np.random.default_rng(seed).choice(200 - T - K, B, replace=False)
    return frames, aa, contacts, idx


def batches(seed: int):
    """(the program's batch dict, the reference's) of B windows."""
    frames, aa, contacts, idx = chain(seed)
    window = torch.as_tensor(np.stack([frames[f:f + T] for f in idx]))
    y_seq = torch.as_tensor(np.stack([frames[f + T:f + T + K] for f in idx]))
    adj = torch.zeros(B, R, R)
    for i, f in enumerate(idx):
        adj[i, contacts[f][0], contacts[f][1]] = 1.0
    prog = {"aa": torch.as_tensor(aa), "window": window, "y": y_seq[:, 0],
            "y_seq": y_seq, "adj": adj}
    return prog, {"window": window, "y_seq": y_seq,
                  "contacts": [contacts[f] for f in idx]}


def cfg_of(**kw) -> ModelConfig:
    return ModelConfig(**{**MODEL, **kw})


def params_of(seed: int):
    return weights.make(MODEL, RECIPE, seed, "cpu")


def program(cfg, params, batch):
    """(loss, {leaf: gradient}, {leaf: weights after one step})."""
    loss_fn = make_curriculum_loss(cfg, K, threshold=THRESHOLD,
                                   coord_clip=CLIP, loss_space="delta")
    (loss, _), grads = value_and_grad(loss_fn, params, batch)
    tx, _ = make_optimizer(lr=LR, weight_decay=WD, grad_clip_norm=CLIP_NORM,
                           skip_nonfinite_updates=True)
    step = make_curriculum_train_step(cfg, tx, K, threshold=THRESHOLD,
                                      coord_clip=CLIP, loss_space="delta")
    state = TrainState(params, tx.init(params), 0, 0)
    new, _ = step(state, batch)
    return float(loss), dict(leaves(grads)), dict(leaves(new.params))


def gaps(cfg, seed: int) -> dict:
    """The program at ``cfg`` against the f32 reference on seed's
    weights and windows."""
    params = params_of(seed)
    prog, mine = batches(seed)
    loss, grads, moved = program(cfg, params, prog)
    aa = prog["aa"]
    want_loss, want_grads = ref.loss_and_grads(
        params, MODEL, aa, mine, THRESHOLD, CLIP, "float32", chunk=3)
    want = ref.train(params, MODEL, aa, [mine], LR, WD, THRESHOLD, CLIP,
                     CLIP_NORM, "float32", chunk=3)
    norms = {k: float(v.norm()) for k, v in want_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return {
        "loss": abs(loss - want_loss) / abs(want_loss),
        "grad": max(float((grads[k] - g).norm()) / max(norms[k], median)
                    for k, g in want_grads.items()),
        "move": max(float((moved[k] - p).abs().max())
                    for k, p in want["params"].items()),
        "leaves": set(grads) == set(want_grads),
    }


def within(g: dict) -> bool:
    return (g["loss"] <= LOSS_RTOL and g["grad"] <= GRAD_RTOL
            and g["move"] <= MOVE_ATOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_dense_curriculum_matches_the_reference(seed):
    """The K-step loss, every gradient leaf and the weights after one
    Adam step (gradient clip, L2 decay) against the reference's."""
    g = gaps(cfg_of(), seed)
    assert g["leaves"]
    assert within(g), g


def test_the_comparison_fails_the_program_in_bf16():
    """The same comparison with the program's body in bf16: the f32
    tolerances do not hold it."""
    g = gaps(cfg_of(compute_dtype="bfloat16"), 1)
    assert not within(g), g
    assert g["grad"] > 10 * GRAD_RTOL or g["loss"] > 10 * LOSS_RTOL, g


@pytest.mark.parametrize("frame", [0, -1], ids=["first", "last"])
@pytest.mark.parametrize("seed", [1, 2])
def test_dense_step_is_the_contact_edge_form(seed, frame):
    """One model step on the dense graph (all pairs, the kernel tensor
    masked by the adjacency) equals the reference's sum over the contact
    pairs, edge features from the window's first or last frame. The
    head's scale is 1 here, so that the step stands well above the
    rounding of the coordinates it is added to."""
    model = dict(MODEL, head_scale=1.0)
    params = params_of(seed)
    prog, _ = batches(seed)
    window, aa = prog["window"], prog["aa"]
    pos = window[:, frame]
    adj = (((pos[:, :, None] - pos[:, None]) ** 2).sum(-1)
           < THRESHOLD ** 2).float()
    with torch.no_grad():
        got = gkn_apply_single(params, cfg_of(head_scale=1.0), aa, window,
                               DenseGraph(adj=adj,
                                          edge_feats=dense_edge_features(pos)))
        pairs = ref_gkn.contact_pairs(pos, THRESHOLD)
        want = ref.model_step(params, model, aa, window, pairs, frame,
                              ref.rounding_fn(model))
    step = (want - window[:, -1]).abs().max()
    # f32 sums over all pairs against over the contacts: 1e-6 of the step
    assert float((got - want).abs().max() / step) < 1e-5


def _counted(step, state, batch, calls: int) -> dict:
    before = profiling.counters()
    for _ in range(calls):
        state, _ = step(state, batch)
    after = profiling.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()}


@pytest.mark.parametrize("grad_steps", [None, 1], ids=["all", "last"])
@pytest.mark.parametrize("graph_mode", ["dense", "sparse"])
def test_the_curriculum_counters(graph_mode, grad_steps):
    """Each step call counts one optimizer step, K model steps, the
    supervised ones and, on the dense graph, B * R^2 pairs a model step;
    host integers, read around the calls."""
    cfg = cfg_of(graph_mode=graph_mode, max_edges=1225)
    params = params_of(3)
    prog, mine = batches(3)
    if graph_mode == "sparse":
        edges = np.zeros((B, 2, 1225), np.int32)
        mask = np.zeros((B, 1225), np.float32)
        for i, c in enumerate(mine["contacts"]):
            edges[i, :, :c.shape[1]] = c
            mask[i, :c.shape[1]] = 1.0
        prog = dict(prog, edges=torch.as_tensor(edges),
                    mask=torch.as_tensor(mask))
        del prog["adj"]
    tx, _ = make_optimizer(lr=LR, weight_decay=WD)
    step = make_curriculum_train_step(cfg, tx, K, grad_steps=grad_steps)
    got = _counted(step, TrainState(params, tx.init(params), 0, 0), prog, 2)
    supervised = K if grad_steps is None else grad_steps
    want = {"curriculum_steps": 2, "curriculum_unrolled": 2 * K,
            "curriculum_supervised": 2 * supervised}
    if graph_mode == "dense":
        want["dense_pairs"] = 2 * K * B * R * R
    assert {k: v for k, v in got.items() if v} == want


def test_the_curriculum_spans():
    """``train.curriculum`` around each step call; issued op by op, each
    of the K model steps ``curriculum.unroll`` within it and each rebuild
    ``curriculum.rebuild`` within a model step. Recorded only under
    ``tracing()``."""
    cfg = cfg_of()
    params = params_of(4)
    prog, _ = batches(4)
    tx, _ = make_optimizer(lr=LR, weight_decay=WD)
    step = make_curriculum_train_step(cfg, tx, K)
    state = TrainState(params, tx.init(params), 0, 0)
    state, _ = step(state, prog)               # outside tracing()
    with profiling.tracing() as spans:
        state, _ = step(state, prog)
    names = [s.name for s in spans]
    assert names.count("train.curriculum") == 1
    assert names.count("curriculum.unroll") == K
    assert names.count("curriculum.rebuild") == K - 1
    for s in spans:
        if s.name == "curriculum.unroll":
            assert s.parent == "train.curriculum"
        if s.name == "curriculum.rebuild":
            assert s.parent == "curriculum.unroll"
    with profiling.tracing() as both:
        step(state, prog)
        step.eager(state, prog)
    assert [s.name for s in both].count("train.curriculum") == 2
    step(state, prog)                          # outside tracing() again
    assert profiling.span("train.curriculum") is profiling.span("x")
