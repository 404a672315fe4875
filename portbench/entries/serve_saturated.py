"""Requests served by ``serving/server.py::RolloutServer`` on the
hand-written kernels under an open loop offered above the server's
knee: ``serve_kernels``'s set-up, window, judgement and counts, judged
end to end by the frames the server delivers a second. The backlog grows
all through the arrivals, so the window runs on until the last request
is back, and the throughput is every served request's frames over the
window's whole time, the drain included."""

from __future__ import annotations

from portbench.entries.serve_kernels import (  # noqa: F401
    judge,
    release,
    setup,
    window,
    work,
)


def end_to_end(run) -> dict:
    served = sum(r.coords.shape[0] for r in run.outputs if r is not None)
    return {"rollout_steps_per_s": served / run.window_s}
