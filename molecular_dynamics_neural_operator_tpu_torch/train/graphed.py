"""Train steps on the card as CUDA graphs, the counterpart of the JAX
package's ``jax.jit(step, donate_argnums=(0,))``.

``graphed_step(body, ...)`` turns a step body ``body(state, batch) ->
(state, metrics)``, which leaves its state as it was, into the step a
caller uses, ``step(state, batch)``:

- on the CPU (and for a configuration that stays eager) it is the body,
  run eagerly;
- on the card it keeps one static train state and one graph memory pool
  for all its graphs, and one graph for each batch signature (the keys,
  shapes and dtypes of the batch). The first call of a signature runs the
  body once eagerly (the warm-up), then captures it followed by one copy
  of the new parameters, moments and counters into the static state. A
  call copies the batch into the graph's input buffers (and the state,
  unless it is the static state the last call returned), draws the step's
  noise into its buffer outside the graph (one launch), replays and
  returns the static state with ``step + 1`` and a copy of the metrics.
  A data-parallel step's noise buffer holds the GLOBAL batch's
  increments (``noise_rows`` times the rank's rows), of which the body
  adds its own rows (``with_noise``'s ``part``), as its eager form does.

The returned state is the graph's own: the next call overwrites it, as a
donated JAX state is consumed. A caller that keeps a state across steps
copies it (``copy_state``). A replay writes the static state without
passing through PyTorch's dispatcher, so each replay advances the version
counters of its tensors: a cache keyed on them (``ops/cuda/graphs.py::
tree_identity``) sees the new values. ``step.eager`` is the body run
eagerly on any device, the graph's oracle on the card; ``step.graphed``
is the ``GraphedStep`` (None for a step that stays eager), whose
``graphs`` are those captured so far.
"""

from __future__ import annotations

from typing import Callable

import torch

from molecular_dynamics_neural_operator_tpu_torch.device import device_of
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
    capture,
)
from molecular_dynamics_neural_operator_tpu_torch.train.noise import (
    noise_increments,
    random_walk,
)
from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
    clone_opt_state,
    opt_state_leaves,
    tree_leaves,
    tree_map,
)
from molecular_dynamics_neural_operator_tpu_torch.train.state import (
    TrainState,
)


def _state_leaves(state: TrainState) -> list:
    return tree_leaves(state.params) + opt_state_leaves(state.opt_state)


def copy_state(state: TrainState) -> TrainState:
    """A copy of ``state`` with tensors of its own."""
    return state._replace(params=tree_map(torch.clone, state.params),
                          opt_state=clone_opt_state(state.opt_state))


def _batch_leaves(batch) -> list:
    if isinstance(batch, dict):
        return list(batch.values())
    return list(batch)


def _like(batch, leaves: list):
    """``leaves`` in the container type of ``batch`` (a dict or a
    NamedTuple of tensors)."""
    if isinstance(batch, dict):
        return dict(zip(batch, leaves))
    return type(batch)(*leaves)


def _signature(batch) -> tuple:
    keys = list(batch) if isinstance(batch, dict) else batch._fields
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in zip(keys, _batch_leaves(batch)))


def with_noise(batch: dict, noise_std: float, part: int = 0) -> dict:
    """The batch with its window noised by the increments the step drew
    into ``batch["noise"]`` (``train/noise.py``), and without them. The
    window's b rows take rows ``part * b`` on of the increments: a
    data-parallel rank's rows of the global batch's noise."""
    if noise_std <= 0.0:
        return batch
    batch = dict(batch)
    eps = batch.pop("noise")
    b = batch["window"].shape[0]
    return dict(batch, window=batch["window"] + random_walk(
        eps[part * b:(part + 1) * b], noise_std))


def _noise_shape(window: torch.Tensor, rows: int) -> tuple:
    return (rows * window.shape[0],) + tuple(window.shape[1:])


class _Graph:
    """A captured step, its input buffers, and ``box["metrics"]``, the
    metrics its capture returned (the graph's outputs)."""

    def __init__(self, captured, batch, box):
        self.captured, self.batch, self.box = captured, batch, box


class GraphedStep:
    """``step(state, batch) -> (state, metrics)`` on the card through CUDA
    graphs; see the module docstring."""

    def __init__(self, body: Callable, noise_std: float, name: str,
                 noise_rows: int = 1):
        self.body, self.noise_std, self.name = body, float(noise_std), name
        self.noise_rows = noise_rows
        self._state: TrainState | None = None
        self.graphs: dict = {}
        # replays are serialised, so the graphs of all signatures share
        # one pool
        self._pool = None

    def _static_state(self, state: TrainState) -> TrainState:
        if self._state is None:
            self._state = copy_state(state)
            return self._state
        static = _state_leaves(self._state)
        given = _state_leaves(state)
        if len(given) != len(static):
            raise ValueError(f"{self.name}: the state's optimizer chain "
                             "differs from the one the graphs hold")
        if not all(a is b for a, b in zip(given, static)):
            torch._foreach_copy_(static, given)
        return self._state

    def _draw_noise(self, state: TrainState, inputs) -> None:
        """The step's noise increments, drawn into the graph's buffer."""
        if self.noise_std > 0.0:
            eps = inputs["noise"]
            noise_increments(state.rng, state.step, eps.shape, eps.device,
                             eps.dtype, out=eps)

    def _capture(self, state: TrainState, static: TrainState,
                 batch) -> _Graph:
        inputs = _like(batch, [t.clone() for t in _batch_leaves(batch)])
        if self.noise_std > 0.0:
            window = batch["window"]
            inputs["noise"] = window.new_empty(_noise_shape(window,
                                                            self.noise_rows))
            self._draw_noise(state, inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        box = {}

        def body():
            new, metrics = self.body(static, inputs)
            pairs = [(s, n) for s, n in zip(_state_leaves(static),
                                            _state_leaves(new))
                     if s is not n]
            torch._foreach_copy_([s for s, _ in pairs],
                                 [n for _, n in pairs])
            box["metrics"] = metrics

        captured, _ = capture(body, self.name,
                              warmup=lambda: self.body(static, inputs),
                              pool=self._pool)
        return _Graph(captured, inputs, box)

    def __call__(self, state: TrainState, batch):
        static = self._static_state(state)
        key = _signature(batch)
        if key not in self.graphs:
            self.graphs[key] = self._capture(state, static, batch)
        graph = self.graphs[key]
        given = _batch_leaves(batch)
        torch._foreach_copy_(_batch_leaves(graph.batch)[:len(given)], given)
        self._draw_noise(state, graph.batch)
        graph.captured.replay()
        for t in _state_leaves(static):
            torch.autograd.graph.increment_version(t)
        metrics = {k: v.clone() for k, v in graph.box["metrics"].items()}
        return static._replace(step=state.step + 1, rng=state.rng), metrics


def graphed_step(body: Callable, noise_std: float = 0.0,
                 eager_only: bool = False, name: str = "train step",
                 noise_rows: int = 1):
    """``step(state, batch)`` of a body ``body(state, batch)``
    whose batch carries the noise increments as ``batch["noise"]`` when
    ``noise_std > 0`` (``noise_rows`` times the batch's rows): CUDA graphs
    on the card unless ``eager_only`` (``ops/cuda/graphs.py::
    step_stays_eager``), the eager body elsewhere. ``step.eager`` runs the
    body eagerly; ``step.graphed`` is the ``GraphedStep``, None when
    ``eager_only``."""
    graphed = None if eager_only else GraphedStep(body, noise_std, name,
                                                  noise_rows)

    def eager(state: TrainState, batch):
        if noise_std > 0.0:
            window = batch["window"]
            batch = dict(batch, noise=noise_increments(
                state.rng, state.step, _noise_shape(window, noise_rows),
                window.device, window.dtype))
        return body(state, batch)

    def step(state: TrainState, batch):
        if graphed is None or device_of(state.params).type != "cuda":
            return eager(state, batch)
        return graphed(state, batch)

    step.eager, step.graphed = eager, graphed
    return step
