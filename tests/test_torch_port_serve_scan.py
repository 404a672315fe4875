"""What the serving slice added around the rollout: ``stream_chunk`` of
``make_rollout_fn``, ``restore_subtree`` on checkpoints the JAX package
wrote, and ``_from_dict`` of a run's ``config.json``."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
    TrainConfig as JaxTrainConfig,
)
from molecular_dynamics_neural_operator_tpu.configs import (
    _from_dict as jax_from_dict,
)
from molecular_dynamics_neural_operator_tpu.models import gkn as jgkn
from molecular_dynamics_neural_operator_tpu.rollout import (
    make_rollout_fn as jax_make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu.train import create_train_state
from molecular_dynamics_neural_operator_tpu.utils import (
    checkpoint as jckpt,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    _from_dict,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
    restore_subtree,
)

SMALL = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
             max_edges=128, graph_mode="sparse", compute_dtype="float32",
             predict_delta=True)


def _setup(**kw):
    opts = {**SMALL, **kw}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jparams = jax.tree.map(np.asarray,
                           jgkn.gkn_init(jax.random.PRNGKey(3), jcfg))
    traj = synthetic_trajectory(num_frames=40, num_residues=12, seed=6)
    return jcfg, cfg, jparams, params_from_jax(jparams, "cpu"), traj


@pytest.mark.parametrize("chunk", [1, 2, 4])
@pytest.mark.parametrize("collect", ["coords", "both"])
def test_stream_chunk_equals_the_unchunked_rollout_and_jax(chunk, collect):
    jcfg, cfg, jparams, params, traj = _setup()
    aa = traj.aminoacids
    w0 = np.stack([traj.positions[i:i + 4] for i in (0, 7, 14, 21)])
    whole = make_rollout_fn(cfg, 4, batched=True, collect=collect,
                            device="cpu")(params, aa, w0)
    parts = make_rollout_fn(cfg, 4, batched=True, collect=collect,
                            stream_chunk=chunk, device="cpu")(params, aa, w0)
    want = jax_make_rollout_fn(jcfg, 4, batched=True, collect=collect,
                               stream_chunk=chunk)(
        jparams, jnp.asarray(aa), jnp.asarray(w0))

    def leaves(out):
        collected, final, diags = out
        collected = collected if isinstance(collected, tuple) else (collected,)
        return [*collected, final, diags["edge_overflow"]]

    for got, ref, jref in zip(leaves(parts), leaves(whole), leaves(want)):
        assert got.shape == ref.shape == jref.shape
        if got.dtype == torch.bool:
            assert torch.equal(got, ref)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jref))
            continue
        # the same f32 sums over C streams instead of S: order differences
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=2e-5)
        # against JAX: a few steps fed back (tests/test_torch_port_rollout)
        np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=2e-4,
                                   atol=2e-4)


def test_stream_chunk_with_one_sequence_per_stream():
    _, cfg, _, params, traj = _setup()
    rng = np.random.default_rng(0)
    aas = rng.integers(0, 20, (4, 12))
    w0 = np.stack([traj.positions[i:i + 4] for i in (0, 7, 14, 21)])
    whole, _, _ = make_rollout_fn(cfg, 3, batched=True, device="cpu")(
        params, aas, w0)
    parts, _, _ = make_rollout_fn(cfg, 3, batched=True, stream_chunk=2,
                                  device="cpu")(params, aas, w0)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5,
                               atol=2e-5)


def test_stream_chunk_refusals():
    _, cfg, _, params, traj = _setup()
    with pytest.raises(ValueError, match="batched=True"):
        make_rollout_fn(cfg, 2, stream_chunk=2, device="cpu")
    w0 = np.stack([traj.positions[i:i + 4] for i in (0, 7, 14)])
    with pytest.raises(ValueError, match="not divisible"):
        make_rollout_fn(cfg, 2, batched=True, stream_chunk=2,
                        device="cpu")(params, traj.aminoacids, w0)


def _assert_trees_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v)
        else:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("opts", [{}, dict(electrostatics="dh")],
                         ids=["plain", "dh"])
def test_restore_subtree_reads_checkpoints_the_jax_package_wrote(tmp_path,
                                                                 opts):
    jcfg, cfg, jparams, _, _ = _setup(**opts)
    template = gkn_init(cfg, seed=1, device="cpu")
    # params only, with sidecar
    jckpt.save_checkpoint(tmp_path / "params.npz", jparams,
                          {"epoch": 7, "valid_loss": 0.5})
    got, meta = restore_subtree(tmp_path / "params.npz", template, ".params",
                                device="cpu")
    _assert_trees_equal(got, jparams)
    assert meta == {"epoch": 7, "valid_loss": 0.5}
    # a TrainState, as the JAX trainer's BestCheckpointer writes it
    state, *_ = create_train_state(jax.random.PRNGKey(0), jcfg,
                                   JaxTrainConfig())
    jckpt.save_checkpoint(tmp_path / "best.npz", state, {"epoch": 3})
    got, meta = restore_subtree(tmp_path / "best", template, ".params",
                                device="cpu")
    _assert_trees_equal(got, jax.tree.map(np.asarray, state.params))
    assert meta["epoch"] == 3
    # and the JAX package reads the same files the same way
    jgot, _ = jckpt.restore_subtree(tmp_path / "best.npz", jparams, ".params")
    _assert_trees_equal(got, jax.tree.map(np.asarray, jgot))
    assert got["fc1"]["w"].shape[0] == (8 if opts else 7)


def test_restore_subtree_without_sidecar_and_its_errors(tmp_path):
    jcfg, cfg, jparams, params, _ = _setup()
    flat = {k: np.asarray(v, np.float16)
            for k, v in jckpt._flatten_with_paths(jparams).items()}
    np.savez(tmp_path / "bare.npz", **flat)  # as tools/bench_ckpt.npz
    got, meta = restore_subtree(tmp_path / "bare.npz", params, ".params",
                                device="cpu")
    assert meta == {}
    assert got["emb"].dtype == torch.float32
    np.testing.assert_array_equal(got["emb"].numpy(),
                                  flat["emb"].astype(np.float32))
    dh_template = gkn_init(dataclasses.replace(cfg, electrostatics="dh"),
                           device="cpu")
    with pytest.raises(ValueError, match="fc1/w has shape"):
        restore_subtree(tmp_path / "bare.npz", dh_template, ".params",
                        device="cpu")
    untied = gkn_init(dataclasses.replace(cfg, tie_edge_kernel=False),
                      device="cpu")
    with pytest.raises(KeyError, match="edge_kernel2"):
        restore_subtree(tmp_path / "bare.npz", untied, ".params",
                        device="cpu")


def test_bench_checkpoint_restores_into_the_bench_template():
    from pathlib import Path

    ckpt = Path(__file__).resolve().parents[1] / "tools" / "bench_ckpt.npz"
    cfg = ModelConfig(graph_mode="sparse", max_edges=224, predict_delta=True)
    got, _ = restore_subtree(ckpt, gkn_init(cfg, device="cpu"), ".params",
                             device="cpu")
    with np.load(ckpt) as raw:
        np.testing.assert_array_equal(
            got["edge_kernel"]["layer_2"]["w"].numpy(),
            raw["edge_kernel/layer_2/w"].astype(np.float32))


def test_from_dict_reads_a_runs_config_like_the_jax_package(tmp_path):
    jcfg = JaxModelConfig(**{**SMALL, "electrostatics": "dh",
                             "eps_solvent": 60.0, "temperature": 298.0,
                             "ionic_strength": 0.3, "conv_impl": "pallas"})
    stored = json.loads(json.dumps(
        {**dataclasses.asdict(jcfg), "a_field_of_a_later_version": [1, 2]}))
    got = _from_dict(ModelConfig, stored)
    want = jax_from_dict(JaxModelConfig, stored)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.eps_solvent, got.temperature, got.ionic_strength) == (
        60.0, 298.0, 0.3)
    assert {f.name for f in dataclasses.fields(ModelConfig)} == {
        f.name for f in dataclasses.fields(JaxModelConfig)}
