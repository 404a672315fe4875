"""Configuration dataclasses of the PyTorch port.

The port's own copy of every configuration of the JAX package
(``molecular_dynamics_neural_operator_tpu/configs.py``): the same
dataclasses, fields and defaults, and the same ``to_json`` text, so a run
directory's ``config.json`` reads into both packages
(``experiment_from_json``). See the JAX package's file for the reasoning
behind each field; the short notes here say what each one selects.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


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
class FNOConfig:
    """FNO spectral-conv variant on distance-matrix trajectories (data
    only in the port)."""

    width: int = 32
    modes1: int = 12
    modes2: int = 12
    depth: int = 4
    in_channels: int = 10  # window of distance matrices as channels
    out_channels: int = 1
    num_residues: int = 28
    compute_dtype: str = "float32"
    spectral_impl: str = "auto"  # "dft" | "fft" | "auto"
    predict_delta: bool = False
    predict_prior: str = "last"  # "last" | "extrapolate"
    prior_damping: float = 1.0
    head_init: str = "default"  # "default" | "zero"
    head_scale: float = 1.0


@dataclass(frozen=True)
class FNO3dConfig:
    """FNO-3d, the space-time FNO (``models/fno3d.py``, f32) at its
    published sizes: ``in_frames`` distance matrices in, ``out_frames``
    out in one call. The port's own: the JAX package has no FNO-3d, so
    this stays outside ``ExperimentConfig``, whose text is the JAX
    package's."""

    width: int = 20
    modes1: int = 8
    modes2: int = 8
    modes3: int = 8  # kept time frequencies of the padded time axis
    depth: int = 4
    in_frames: int = 10
    out_frames: int = 40
    time_pad: int = 6  # zeros after the time axis; cropped at the end
    projection: int = 128
    num_residues: int = 80
    spectral_impl: str = "auto"  # "dft" | "fft" | "auto"


@dataclass(frozen=True)
class DataConfig:
    """Trajectory dataset parameters."""

    data_path: str = ""
    node_features_path: Optional[str] = None
    edge_index_dset_name: str = "contact_map"
    edge_attr_dset_name: str = "point_cloud"
    node_feature_dset_name: str = "amino_acids"
    window_size: int = 10
    horizon: int = 1
    threshold: float = 8.0  # contact threshold in Angstrom
    split_pct: float = 0.8
    split_method: str = "partition"  # or "random"
    # graphs from the stored contact maps (training) or recomputed from
    # the coordinates (the rollout's semantics)
    use_stored_contact_maps: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training-loop parameters. ``cli/train.py`` reads them all as the
    JAX package's CLI does; ``rollout_loss_weight`` and
    ``checkpoint_every`` are carried for the configuration file only, in
    both packages."""

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


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout: the ranks of the process group over
    ``axis_names`` (``parallel/mesh.py::make_mesh``)."""

    data: int = 1   # batch-axis data parallelism
    model: int = 1  # edge/feature-axis model parallelism
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    fno: FNOConfig = field(default_factory=FNOConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def to_json(cfg) -> str:
    """The JAX package's text: sorted keys, indent 2."""
    return json.dumps(dataclasses.asdict(cfg), indent=2, sort_keys=True)


def _from_dict(cls, d: dict):
    """``cls`` from a dict as a run's ``config.json`` stores it: unknown
    keys are dropped, lists become tuples, and a sub-configuration's dict
    becomes its dataclass."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            continue
        sub = _CONFIG_TYPES.get(k)
        if sub is not None and isinstance(v, dict):
            kwargs[k] = _from_dict(sub, v)
        else:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


_CONFIG_TYPES = {
    "model": ModelConfig,
    "fno": FNOConfig,
    "data": DataConfig,
    "train": TrainConfig,
    "rollout": RolloutConfig,
    "mesh": MeshConfig,
}


def experiment_from_json(s: str) -> ExperimentConfig:
    return _from_dict(ExperimentConfig, json.loads(s))
