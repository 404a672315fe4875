"""The curriculum slice of the port as a whole against the JAX package on
the CPU: ``curriculum_loss_single``, ``make_curriculum_train_step`` with
each graph frame, the bf16 burn-in, the input noise, and
``train_curriculum_recipe`` (its mid-epoch switch to K, abort and
backoff)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_curriculum import (
    ATOL,
    BASE,
    BATCH,
    RTOL,
    _flat,
    _setup,
    assert_grads_close,
    assert_same_graphs,
    record_graphs,
)

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
    TrainConfig as JaxTrainConfig,
)
from molecular_dynamics_neural_operator_tpu.data import (
    WindowDataset as JaxWindowDataset,
    synthetic_trajectory as jax_synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu.train import (
    create_train_state as jax_create_train_state,
)
from molecular_dynamics_neural_operator_tpu.train import (
    curriculum as jcurriculum,
)
from molecular_dynamics_neural_operator_tpu.train import loop as jloop
from molecular_dynamics_neural_operator_tpu.train.recipe import (
    train_curriculum_recipe as jax_train_curriculum_recipe,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import (
    ModelConfig,
    TrainConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.data import (
    WindowDataset,
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
    to_device,
)
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    SparseGraph,
)
from molecular_dynamics_neural_operator_tpu_torch.train import (
    create_train_state,
    curriculum,
    loop,
    make_curriculum_train_step,
    make_train_step,
    noise,
    recipe,
    train_curriculum_recipe,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)

TRAIN = dict(lr=1e-3, batch_size=BATCH)
# bf16, as the existing bf16 tests hold these paths: on the per-layer path
# a rounding flipped by the order of an f32 sum is 2^-8 of a value, 2^-5 of
# a gradient's scale after the layers (test_torch_port_train_model.py);
# the JAX package's Pallas kernel also rounds each product x * K and the
# per-node partial sums to bf16 where the port rounds the summed message,
# 2^-4 of scale (test_torch_port_train_conv.py); the loss within 2e-2
BF16_GRAD = {"xla": 2.0 ** -5, "pallas": 2.0 ** -4}
BF16_LOSS = 2e-2


def test_curriculum_loss_single_matches_jax():
    """One example, K = 3, weighted steps and the clip: loss, MSE and every
    gradient."""
    jcfg, cfg, batch, jparams = _setup("xla", 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jloop.featurize_batch(jcfg, jb, "first")
    jgraph = jax.tree.map(lambda x: x[0], jg.graph)
    opts = dict(step_weights=[1.0, 2.0, 3.0], coord_clip=1000.0)
    (jl, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcurriculum.curriculum_loss_single(
            p, jcfg, jb["aa"], jb["window"][0], jgraph, jb["y_seq"][0],
            **opts), has_aux=True))(jparams)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    g = loop.featurize_batch(cfg, tb, "first").graph
    graph = SparseGraph(g.edges[0], g.mask[0], g.edge_feats[0])
    (l, m), grads = loop.value_and_grad(
        lambda p: curriculum.curriculum_loss_single(
            p, cfg, tb["aa"], tb["window"][0], graph, tb["y_seq"][0], **opts),
        params_from_jax(jparams, "cpu"))
    np.testing.assert_allclose(float(l), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(m), float(jm), rtol=RTOL)
    assert_grads_close(grads, jgrads)


def _both_states(impl):
    opts = {**BASE, "train_conv_impl": impl}
    jcfg, cfg = JaxModelConfig(**opts), ModelConfig(**opts)
    jstate, jtx, _ = jax_create_train_state(jax.random.PRNGKey(0), jcfg,
                                            JaxTrainConfig(**TRAIN))
    state, tx, _ = create_train_state(
        0, cfg, TrainConfig(**TRAIN), device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params),
                               "cpu"))
    return jcfg, cfg, jstate, jtx, state, tx


def _langevin_batch(k: int):
    from molecular_dynamics_neural_operator_tpu.data import (
        langevin_trajectory,
    )

    ds = JaxWindowDataset(
        langevin_trajectory(num_frames=24, num_residues=12, seed=13),
        window_size=4, graph_mode="sparse", max_edges=128, use_native=False)
    return ds.get_batch(np.arange(BATCH), rollout_horizon=k)


@pytest.mark.parametrize("graph_frame", ["first", "last", "rebuild"])
def test_curriculum_train_step_matches_jax(graph_frame, monkeypatch):
    """One K = 2 step on the kernel path, delta loss and the clip, on data
    with real motion: metrics, every updated parameter, and every rebuilt
    graph (the teacher step's too under ``"rebuild"``)."""
    jcfg, cfg, jstate, jtx, state, tx = _both_states("pallas")
    batch = _langevin_batch(2)
    opts = dict(rollout_steps=2, graph_frame=graph_frame, coord_clip=1000.0,
                loss_space="delta")
    port, jax_rec = record_graphs(monkeypatch)
    jstate, jm = jcurriculum.make_curriculum_train_step(jcfg, jtx, **opts)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = make_curriculum_train_step(cfg, tx, **opts)(
        state, to_device(batch, "cpu"))
    assert_same_graphs(port, jax_rec, BATCH,
                       2 if graph_frame == "rebuild" else 1)
    assert set(m) == {"rel_l2", "mse", "edge_overflow"}
    for key in ("rel_l2", "mse"):
        assert m[key].shape == ()
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL,
                                   err_msg=key)
    assert bool(m["edge_overflow"]) == bool(jm["edge_overflow"])
    assert state.step == int(jstate.step) == 1
    want = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
    for name, p in _flat(state.params):
        np.testing.assert_allclose(p.numpy(), want[name], RTOL, ATOL,
                                   err_msg=name)


def test_the_step_refuses_what_the_jax_step_refuses():
    _, cfg, _, _, state, tx = _both_states("xla")
    with pytest.raises(ValueError, match="grad_steps"):
        make_curriculum_train_step(cfg, tx, rollout_steps=2, grad_steps=3)
    with pytest.raises(ValueError, match="grad_steps"):
        make_curriculum_train_step(cfg, tx, rollout_steps=2, grad_steps=0)
    with pytest.raises(ValueError, match="graph_frame"):
        make_curriculum_train_step(cfg, tx, rollout_steps=1,
                                   graph_frame="lst")
    step = make_curriculum_train_step(cfg, tx, rollout_steps=3)
    batch = to_device(_langevin_batch(2), "cpu")
    with pytest.raises(ValueError, match="rollout_horizon=3"):
        step(state, batch)


def test_k1_curriculum_step_is_the_teacher_forced_step():
    """K = 1 with the stored graph: the teacher-forced objective, so the
    same loss and the same update as ``make_train_step``."""
    _, cfg, _, _, state, tx = _both_states("pallas")
    batch = to_device(_langevin_batch(1), "cpu")
    np.testing.assert_array_equal(batch["y_seq"][:, 0].numpy(),
                                  batch["y"].numpy())
    s_tf, m_tf = make_train_step(cfg, tx)(
        state, {k: v for k, v in batch.items() if k != "y_seq"})
    s_cu, m_cu = make_curriculum_train_step(cfg, tx, rollout_steps=1)(
        state, batch)
    np.testing.assert_allclose(float(m_cu["rel_l2"]), float(m_tf["rel_l2"]),
                               rtol=1e-6)
    for (_, a), (_, b) in zip(_flat(s_tf.params), _flat(s_cu.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_noisy_curriculum_step_corrupts_the_initial_window_only():
    """``noise_std`` noises the window of the step's own (seed, step) and
    nothing else: the same as a clean step on that noised window."""
    _, cfg, _, _, state, tx = _both_states("xla")
    batch = to_device(_langevin_batch(2), "cpu")
    opts = dict(rollout_steps=2, loss_space="delta", coord_clip=1000.0)
    noisy, m_n = make_curriculum_train_step(cfg, tx, noise_std=0.1, **opts)(
        state, batch)
    by_hand = dict(batch, window=noise.noised_window(
        batch["window"], state.rng, state.step, 0.1))
    clean, m_c = make_curriculum_train_step(cfg, tx, **opts)(state, by_hand)
    assert torch.equal(m_n["rel_l2"], m_c["rel_l2"])
    for (_, a), (_, b) in zip(_flat(noisy.params), _flat(clean.params)):
        assert torch.equal(a, b)
    _, m_0 = make_curriculum_train_step(cfg, tx, **opts)(state, batch)
    assert not torch.equal(m_n["rel_l2"], m_0["rel_l2"])


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_bf16_burn_in_matches_jax(impl, monkeypatch):
    """``burnin_dtype="bfloat16"`` in an f32 model, K = 3, grad_steps=1:
    two bf16 burn-in steps (the training conv stack at bf16 under
    ``"pallas"``), whose last window is handed on detached, then one f32
    supervised step. Held to the bf16 tolerances against the JAX package,
    and the rebuilt graphs must be the same."""
    jcfg, cfg, batch, jparams = _setup(impl, 3)
    opts = dict(grad_steps=1, burnin_dtype="bfloat16", coord_clip=1000.0,
                loss_space="delta")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jloop.featurize_batch(jcfg, jb, "first")
    port, jax_rec = record_graphs(monkeypatch)
    (jl, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jcurriculum.curriculum_loss_batched(
            p, jcfg, jg, jb["y_seq"], **opts), has_aux=True))(jparams)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    gb = loop.featurize_batch(cfg, tb, "first")
    params = params_from_jax(jparams, "cpu")
    (l, m), grads = loop.value_and_grad(
        lambda p: curriculum.curriculum_loss_batched(p, cfg, gb, tb["y_seq"],
                                                     **opts), params)
    assert_same_graphs(port, jax_rec, BATCH, 2)
    assert abs(float(l) - float(jl)) <= BF16_LOSS * abs(float(jl))
    assert abs(float(m) - float(jm)) <= BF16_LOSS * abs(float(jm))
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    for name, g in _flat(grads):
        ref = torch.from_numpy(np.array(want[name]))
        assert (g - ref).abs().max() <= BF16_GRAD[impl] * ref.abs().max(), \
            name
    # the burn-in's dtype changes the exposure: not the f32 burn-in's loss
    (l32, _), _ = loop.value_and_grad(
        lambda p: curriculum.curriculum_loss_batched(
            p, cfg, gb, tb["y_seq"], grad_steps=1, coord_clip=1000.0,
            loss_space="delta"), params)
    assert float(l) != float(l32)
    # without a burn-in the option changes nothing, to the bit
    a = curriculum.curriculum_loss_batched(params, cfg, gb, tb["y_seq"])
    b = curriculum.curriculum_loss_batched(params, cfg, gb, tb["y_seq"],
                                           burnin_dtype="bfloat16")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---- the recipe -----------------------------------------------------------

RECIPE_CFG = dict(width=8, ker_width=16, depth=1, window_size=4,
                  num_residues=10, max_edges=128, graph_mode="sparse",
                  compute_dtype="float32", predict_delta=True)


def _recipe_data(jax_side: bool):
    gen = jax_synthetic_trajectory if jax_side else synthetic_trajectory
    wds = JaxWindowDataset if jax_side else WindowDataset
    extra = dict(use_native=False) if jax_side else {}
    return wds(gen(num_frames=64, num_residues=10, seed=0), window_size=4,
               graph_mode="sparse", max_edges=128, **extra)


def _k_of_logs(text: str) -> list:
    return [line.split("(K=")[1].split(",")[0]
            for line in text.splitlines() if "step " in line]


def test_recipe_switches_to_k_mid_epoch_as_the_jax_recipe_does(
        capsys, monkeypatch):
    """12 train windows make an epoch of 3 batches of 4; a warm-up of 2 of
    6 steps crosses to K = 3 inside the first epoch. Both packages log the
    same K at every step, from the same parameters reach the same final
    loss and parameters, and the final loss is reported even when the run
    is shorter than ``log_every``."""
    jcfg = JaxModelConfig(**RECIPE_CFG, train_conv_impl="pallas")
    cfg = ModelConfig(**RECIPE_CFG, train_conv_impl="pallas")
    jtcfg, tcfg = JaxTrainConfig(lr=1e-3, batch_size=4), TrainConfig(
        lr=1e-3, batch_size=4)
    opts = dict(steps=6, k=3, warmup_frac=0.34, min_warmup=2, log_every=1,
                loss_space="delta")
    jstate, _, jloss = jax_train_curriculum_recipe(
        jcfg, jtcfg, _recipe_data(True), np.arange(12), **opts)
    jax_ks = _k_of_logs(capsys.readouterr().out)
    jparams0 = jax_create_train_state(jax.random.PRNGKey(0), jcfg,
                                      jtcfg)[0].params
    # the port's recipe starts from the JAX recipe's initial parameters
    monkeypatch.setattr(recipe, "create_train_state", functools.partial(
        create_train_state,
        params=params_from_jax(jax.tree.map(np.asarray, jparams0), "cpu")))
    state, seconds, loss = train_curriculum_recipe(
        cfg, tcfg, _recipe_data(False), np.arange(12), device="cpu", **opts)
    monkeypatch.undo()
    ks = _k_of_logs(capsys.readouterr().out)
    assert ks == jax_ks == ["1", "1", "3", "3", "3", "3"]
    assert state.step == 6 and seconds > 0
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    want = dict(_flat(jax.tree.map(np.asarray, jstate.params)))
    for name, p in _flat(state.params):
        np.testing.assert_allclose(p.numpy(), want[name], 1e-3, 1e-5,
                                   err_msg=name)

    _, _, last = train_curriculum_recipe(
        cfg, tcfg, _recipe_data(False), np.arange(12), steps=3, k=1,
        warmup_frac=1.0, min_warmup=1, log_every=100, device="cpu")
    assert last is not None and np.isfinite(last)


def _diverging():
    cfg = ModelConfig(**RECIPE_CFG)
    tcfg = TrainConfig(lr=1e20, batch_size=4, skip_nonfinite_updates=False,
                       grad_clip_norm=0.0)
    return cfg, tcfg, _recipe_data(False)


def test_recipe_aborts_a_diverged_run(capsys):
    cfg, tcfg, ds = _diverging()
    with pytest.raises(RuntimeError, match="diverged"):
        train_curriculum_recipe(cfg, tcfg, ds, np.arange(12), steps=30, k=1,
                                warmup_frac=1.0, min_warmup=1, log_every=2,
                                divergence_limit=3, device="cpu")
    with pytest.raises(RuntimeError, match="diverged"):
        train_curriculum_recipe(cfg, tcfg, ds, np.arange(12), steps=200,
                                k=1, warmup_frac=1.0, min_warmup=1,
                                log_every=2, divergence_limit=3,
                                on_divergence="backoff", max_backoffs=2,
                                device="cpu")
    msgs = [line for line in capsys.readouterr().out.splitlines()
            if "DIVERGED" in line]
    assert len(msgs) == 2 and "backoff 2/2" in msgs[-1]


def test_recipe_backoff_restores_the_last_good_parameters(capsys):
    """lr 1e20: step 1's logged loss (before its update) is finite, so the
    parameters after step 1 are the last good ones; step 2's is not, and
    with a limit of 1 the backoff restores them with a fresh optimizer at
    half the lr. The run ends there (2 steps), so it returns what the
    backoff restored: the state of a 1-step run, bit for bit."""
    cfg, tcfg, ds = _diverging()
    opts = dict(k=1, warmup_frac=1.0, min_warmup=1, log_every=1,
                device="cpu")
    one, _, _ = train_curriculum_recipe(cfg, tcfg, ds, np.arange(12),
                                        steps=1, divergence_limit=0, **opts)
    capsys.readouterr()
    two, _, loss = train_curriculum_recipe(
        cfg, tcfg, ds, np.arange(12), steps=2, divergence_limit=1,
        on_divergence="backoff", max_backoffs=1, **opts)
    out = capsys.readouterr().out
    assert "DIVERGED at step <= 2" in out and "lr x0.5" in out
    assert not np.isfinite(loss) or loss > 1e4
    assert two.step == 0 and two.opt_state.count == 0
    for (_, a), (_, b) in zip(_flat(one.params), _flat(two.params)):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for (_, a), (_, b) in zip(
        _flat(one.params),
        _flat(create_train_state(0, cfg, tcfg, device="cpu")[0].params))
        if a.abs().max() > 0)


def test_recipe_defaults_to_one_gradient_step_after_the_burn_in(monkeypatch):
    """``grad_steps="default"`` builds the K step with grad_steps=1 (and
    the K = 1 step with full backpropagation); ``None`` keeps every K."""
    built = []
    orig = make_curriculum_train_step

    def spy(cfg, tx, rollout_steps, **kw):
        built.append((rollout_steps, kw.get("grad_steps")))
        return orig(cfg, tx, rollout_steps, **kw)

    monkeypatch.setattr(recipe, "make_curriculum_train_step", spy)
    cfg = ModelConfig(**RECIPE_CFG)
    tcfg = TrainConfig(lr=1e-3, batch_size=4)
    for grad_steps, want in (("default", 1), (None, None), (2, 2)):
        built.clear()
        train_curriculum_recipe(cfg, tcfg, _recipe_data(False),
                                np.arange(12), steps=1, k=3, min_warmup=1,
                                grad_steps=grad_steps, device="cpu")
        assert built == [(1, None), (3, want)]
