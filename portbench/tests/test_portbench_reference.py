"""The plain reference against the port's plain path at a tiny size on
the CPU: the sparse BBA-like step (contact rebuild, one-hot aggregation,
bf16 operands) and the cell-list step with the Debye-Hueckel feature
(600 atoms, blocked aggregation). The reference's control precision
moves the step by far more."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import gkn as ref
from portbench.traffic import sources


def port_step(model, params, aa, window, clip):
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import scan

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in model.items() if k in names})
    _, out, over = scan._step(params, cfg, aa, window, model["threshold"],
                              "last", clip)
    return out, bool(over)


BBA = dict(width=8, ker_width=64, depth=2, window_size=10, num_residues=28,
           graph_mode="sparse", max_edges=224, compute_dtype="bfloat16",
           predict_delta=True, head_scale=0.05, threshold=8.0)
GRID = dict(width=8, ker_width=64, depth=2, window_size=4, num_residues=600,
            graph_mode="sparse", max_edges=600 * 48,
            compute_dtype="bfloat16", predict_delta=True,
            electrostatics="dh", eps_solvent=78.0, temperature=310.0,
            ionic_strength=0.15, neighbor_impl="cell_list", max_degree=48,
            cell_capacity=32, num_cells=65536, threshold=8.0)


def inputs(model, seed):
    r, t = model["num_residues"], model["window_size"]
    if r == 28:
        frames, aa = sources.chain_trajectory(400, r, 13)
        window = frames[100:100 + t]
    else:
        window = sources.breathing_trajectory(
            sources.serpentine_grid(r, 4.0), t, seed)
        aa = np.random.default_rng(seed).integers(0, 20, r)
    params = weights.make(model, {"kernel_init_scale": 0.1,
                                  "head_bias": "zero"}, seed, "cpu")
    return params, torch.as_tensor(aa), torch.as_tensor(window)


@pytest.mark.parametrize("model,clip", [(BBA, 100.0), (GRID, 1000.0)],
                         ids=["bba", "grid_dh"])
@pytest.mark.parametrize("seed", [1, 2])
def test_reference_step_equals_the_port_plain_step(model, clip, seed):
    params, aa, window = inputs(model, seed)
    with torch.no_grad():
        want, over = port_step(model, params, aa, window, clip)
        got, count, ref_over = ref.step(params, model, aa, window[None],
                                        clip)
        lower, _, _ = ref.step(params, model, aa, window[None], clip, "fp8")
    delta = (want - window[-1]).abs().max()
    gap = float((got[0] - want).abs().max() / delta)
    assert gap < 1e-3
    assert bool(ref_over[0]) == over
    assert float((lower[0] - want).abs().max() / delta) > 10 * max(gap, 1e-4)


def test_rebuild_truncates_in_row_major_order():
    pos = torch.zeros(1, 4, 3)
    pos[0, :, 0] = torch.tensor([0.0, 1.0, 2.0, 30.0])
    b, s, d, count, over = ref.rebuild(pos, 8.0, max_edges=5)
    assert int(count[0]) == 10 and bool(over[0])
    assert s.tolist() == [0, 0, 0, 1, 1] and d.tolist() == [0, 1, 2, 0, 1]
    assert int(ref.contact_counts(pos, 8.0)[0]) == 10
