"""Free rollouts on the plain PyTorch path:
``rollout/scan.py::make_rollout_fn`` (replays of CUDA graphs where the
configuration allows them; op by op under the cell list, by
``ops/cuda/graphs.py::stays_eager``). Each call rolls ``steps_per_call``
steps from a fresh start window and its frames are copied to the host."""

from __future__ import annotations

import torch

from portbench.entries import _rollout


def setup(run) -> None:
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    _rollout.inputs(run)
    cfg = _rollout.model_config(run)
    fn = make_rollout_fn(cfg, run.inputs["steps_per_call"],
                         run.model["threshold"], clip=run.mix.get("clip"),
                         batched=True, device=run.device)
    params, aa = run.params, run.aa

    def call(w0):
        with torch.no_grad():
            coords, _, diags = fn(params, aa, w0)
        return coords.cpu().numpy(), bool(diags["edge_overflow"].any())

    run.state = {"call": call}
    call(run.inputs["windows"][0])


def window(run, deadline: float) -> None:
    _rollout.calls(run, run.state["call"], deadline)


def release(run) -> None:
    run.state = None


judge = _rollout.judge
work = _rollout.real_edges


def end_to_end(run) -> dict:
    return {"rollout_steps_per_s": _rollout.frames_per_s(run)}
