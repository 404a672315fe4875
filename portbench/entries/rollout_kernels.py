"""Free rollouts on the hand-written kernels:
``ops/cuda/persistent_rollout.py::make_persistent_rollout_fn``, whose
calls replay the CUDA graphs of ``PreparedRollout``. Each call rolls
``steps_per_call`` steps from a start window and its frames are copied
to the host."""

from __future__ import annotations

from portbench.entries import _rollout


def setup(run) -> None:
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    _rollout.inputs(run)
    cfg = _rollout.model_config(run)
    fn = pr.make_persistent_rollout_fn(
        cfg, run.inputs["steps_per_call"], run.model["threshold"],
        run.mix.get("clip"), run.device)
    params, aa = run.params, run.aa

    def call(w0):
        coords, _, diags = fn(params, aa, w0)
        if coords.dim() == 3:                  # one stream: (n, R, 3)
            coords = coords[None]
        return coords.cpu().numpy(), bool(diags["edge_overflow"])

    run.state = {"call": call, "pr": pr}
    call(run.inputs["windows"][0])             # builds, captures, warms
    pr.reset_launch_counts()


def window(run, deadline: float) -> None:
    _rollout.calls(run, run.state["call"], deadline)
    run.counters["launches"] = run.state["pr"].launch_counts()


def release(run) -> None:
    run.state = None


judge = _rollout.judge
work = _rollout.real_edges


def end_to_end(run) -> dict:
    return {"rollout_steps_per_s": _rollout.frames_per_s(run)}
