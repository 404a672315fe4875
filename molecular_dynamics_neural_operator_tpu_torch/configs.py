"""Configuration dataclasses of the PyTorch port.

The port's own copy of ``ModelConfig``, ``TrainConfig`` and ``RolloutConfig`` from the JAX
package (``molecular_dynamics_neural_operator_tpu/configs.py``): the same
fields, the same defaults, so one configuration describes one model in
both packages. See the JAX package's file for the reasoning behind each
field; the short notes here say what each one selects.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """GKN operator hyperparameters (width 64, kernel width 1024, depth 6,
    7 node features, 6 edge features, 20 amino-acid embeddings of dim 4)."""

    width: int = 64
    ker_width: int = 1024
    depth: int = 6
    edge_features: int = 6
    node_features: int = 7
    out_width: int = 3
    num_embeddings: int = 20
    embedding_dim: int = 4
    x_position_dim: int = 3
    window_size: int = 10
    num_residues: int = 28
    # "dense" all-pairs adjacency or "sparse" fixed-capacity edge lists
    graph_mode: str = "dense"
    max_edges: int = 384
    # conv1 and conv2 share one edge-kernel MLP
    tie_edge_kernel: bool = True
    # older variant without the LSTM and with one conv stack
    legacy_no_lstm: bool = False
    # matmul operand type; accumulation and parameters stay f32
    compute_dtype: str = "bfloat16"
    conv_impl: str = "xla"
    train_conv_impl: str = "xla"
    fused_conv_vjp: bool = True
    remat_edge_mlp: bool = False
    # out = prior + head_scale * head instead of absolute coordinates
    predict_delta: bool = False
    predict_prior: str = "last"  # "last" | "extrapolate"
    # prior = x_t + prior_damping * (x_t - x_{t-1}) under "extrapolate"
    prior_damping: float = 1.0
    head_init: str = "default"  # "default" | "zero"
    head_scale: float = 1.0
    # multiplier on the edge-kernel MLP's final layer init
    kernel_init_scale: float = 1.0
    window_diff: bool = False
    window_diff_scale: float = 100.0
    neighbor_impl: str = "dense_rank"
    max_degree: int = 32
    scatter_mode: str = "auto"
    kernel_quant: str = "none"  # "none" | "int8"
    cell_capacity: int = 16
    num_cells: int = 4096
    electrostatics: str = "none"  # "none" | "dh"
    eps_solvent: float = 78.0
    temperature: float = 310.0
    ionic_strength: float = 0.15


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop parameters. The curriculum's own settings (K, its
    grad_steps, graph frame and clip) are arguments of
    ``train/curriculum.py::make_curriculum_train_step`` and
    ``train/recipe.py::train_curriculum_recipe``, as in the JAX package;
    the fields the port does not act on yet (``rollout_steps``,
    ``rollout_loss_weight`` and ``loss_space``, which the JAX package's
    training CLI reads, checkpoint cadence, movies, plots, wandb) are kept
    so that a configuration file reads into both packages."""

    seed: int = 0
    epochs: int = 200
    batch_size: int = 128
    lr: float = 0.01
    weight_decay: float = 5e-4
    scheduler_step: int = 50
    scheduler_gamma: float = 0.8
    grad_clip_norm: float = 0.0  # >0 enables global-norm gradient clipping
    skip_nonfinite_updates: bool = False  # reject NaN/inf update steps
    # average this many micro-batch gradients per optimizer apply
    grad_accum: int = 1
    drop_last: bool = True
    shuffle: bool = True
    # curriculum: free-rollout steps mixed into the loss (0 = teacher forcing)
    rollout_steps: int = 0
    rollout_loss_weight: float = 1.0
    loss_space: str = "absolute"
    # random-walk input-noise std (train/noise.py); 0 disables
    noise_std: float = 0.0
    run_path: str = "runs/default"
    checkpoint_every: int = 1
    generate_movie: bool = True
    num_movie_frames: int = 5
    plot_latent: bool = True
    plot_per_epochs: int = 1
    latent_frames: int = 10000
    log_wandb: bool = False
    wandb_project: str = "bba_gno"


@dataclass(frozen=True)
class RolloutConfig:
    """Autoregressive rollout settings."""

    num_steps: int = 1000
    threshold: float = 8.0
    # which window frame the rebuilt graph comes from
    graph_frame: str = "last"
    collect: str = "coords"  # "coords" | "contact_maps" | "both"


def _from_dict(cls, d: dict):
    """``cls`` from a dict as a run's ``config.json`` stores it: unknown
    keys are dropped, lists become tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in names})
