"""The port's serving bundles (``serving/export.py``, ``cli/export.py``)
against its in-process rollout and against the JAX package's bundles.

A bundle's call must equal ``make_rollout_fn`` (``fno_rollout_scan`` for
the FNO) bit for bit on the same device, in every signature the JAX
package exports: one stream and S streams, with and without
``stream_chunk``, each ``collect`` mode. Against the JAX bundle of the
same weights it holds within the port's f32 tolerance, rtol 2e-4 and
atol 1e-5 over 8 steps (the two packages sum in other orders). The
small configs are ``tests/test_serving.py``'s.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu import configs as jax_configs
from molecular_dynamics_neural_operator_tpu.models import (
    gkn_init as jax_gkn_init,
)
from molecular_dynamics_neural_operator_tpu.models.fno import (
    fno_init as jax_fno_init,
)
from molecular_dynamics_neural_operator_tpu.serving import (
    load_bundle as jax_load_bundle,
)
from molecular_dynamics_neural_operator_tpu.serving import (
    save_bundle as jax_save_bundle,
)
from molecular_dynamics_neural_operator_tpu_torch.cli import export as cli
from molecular_dynamics_neural_operator_tpu_torch.configs import (
    FNOConfig,
    ModelConfig,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.models import fno as fno_mod
from molecular_dynamics_neural_operator_tpu_torch.models.fno import (
    fno_init,
    fno_rollout_scan,
)
from molecular_dynamics_neural_operator_tpu_torch.rollout import (
    make_rollout_fn,
)
from molecular_dynamics_neural_operator_tpu_torch.serving import (
    export_rollout,
    load_bundle,
    save_bundle,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
    save_checkpoint,
)

SMALL = dict(width=16, ker_width=32, depth=2, window_size=4, num_residues=12,
             graph_mode="sparse", max_edges=64, compute_dtype="float32",
             predict_delta=True)
CFG = ModelConfig(**SMALL)
FNO_SMALL = dict(width=8, modes1=4, modes2=4, depth=2, in_channels=3,
                 num_residues=12)
RTOL, ATOL = 2e-4, 1e-5
CPU = "cpu"


def _inputs(streams=0, seed=1):
    rng = np.random.default_rng(seed)
    r, t = CFG.num_residues, CFG.window_size
    shape = (t, r, 3) if streams == 0 else (streams, t, r, 3)
    window = rng.standard_normal(shape).astype(np.float32) * 4.0
    aa = np.arange(r, dtype=np.int32) % CFG.num_embeddings
    return aa, window


@pytest.fixture(scope="module")
def params():
    return gkn_init(CFG, seed=0, device=CPU)


@pytest.mark.parametrize("collect", ["coords", "contact_maps", "both"])
def test_single_stream_bundle_equals_the_rollout(tmp_path, params, collect):
    aa, window = _inputs()
    n = 5
    path = save_bundle(tmp_path / "b", params, CFG, n, clip=100.0,
                       collect=collect)
    assert sorted(p.name for p in path.iterdir()) == [
        "bundle.json", "params.npz", "params.npz.json", "rollout.pt2"]
    bundle = load_bundle(path, device=CPU)
    want = make_rollout_fn(CFG, n, clip=100.0, collect=collect,
                           device=CPU)(params, aa, window)
    got = bundle(aa, window)
    assert cli.same_outputs(got, want)
    lead = got[0][0] if collect == "both" else got[0]
    assert lead.shape[0] == n
    assert bundle.rollout["num_steps"] == n
    assert bundle.platforms == ("cpu",)


@pytest.mark.parametrize("chunk", [None, 2])
def test_stream_bundle_equals_the_rollout(tmp_path, params, chunk):
    s, n = 4, 3
    aa, window = _inputs(streams=s)
    path = save_bundle(tmp_path / "b", params, CFG, n, streams=s,
                       stream_chunk=chunk, clip=100.0, collect="both")
    bundle = load_bundle(path, device=CPU)
    # the program takes the chunk's streams, the bundle all of them
    inputs = [node.meta["val"] for node in bundle.program.graph.nodes
              if node.op == "placeholder"]
    assert tuple(inputs[-1].shape) == (chunk or s, 4, 12, 3)
    want = make_rollout_fn(CFG, n, batched=True, stream_chunk=chunk,
                           clip=100.0, collect="both", device=CPU)(
        params, aa, window)
    got = bundle(aa, window)
    assert got[0][0].shape == (s, n, CFG.num_residues, 3)
    assert got[2]["edge_overflow"].shape == (s,)
    assert cli.same_outputs(got, want)


def test_fno_bundle_equals_the_rollout(tmp_path):
    cfg = FNOConfig(**FNO_SMALL)
    fparams = fno_init(cfg, seed=0, device=CPU)
    channels0 = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (12, 12, 3)).astype(np.float32))
    n = 4
    bundle = load_bundle(save_bundle(tmp_path / "f", fparams, cfg, n),
                         device=CPU)
    assert bundle.operator == "fno" and bundle.cfg == cfg
    assert cli.same_outputs(bundle(channels0),
                            fno_rollout_scan(fparams, cfg, channels0, n))


def test_hot_swap_and_restored_weights(tmp_path, params):
    other = gkn_init(CFG, seed=7, device=CPU)
    aa, window = _inputs()
    bundle = load_bundle(save_bundle(tmp_path / "b", params, CFG, 3,
                                     clip=100.0), device=CPU)
    want = make_rollout_fn(CFG, 3, clip=100.0, device=CPU)(other, aa, window)
    assert cli.same_outputs(bundle(aa, window, params=other), want)
    # numpy leaves in another key order are taken as well
    def reordered(tree):
        if isinstance(tree, dict):
            return {k: reordered(tree[k]) for k in reversed(list(tree))}
        return tree.numpy()

    assert cli.same_outputs(bundle(aa, window, params=reordered(other)),
                            want)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    restored, saved = dict(leaves(bundle.params)), dict(leaves(params))
    assert restored.keys() == saved.keys()
    assert all(torch.equal(restored[k], saved[k]) for k in saved)


def test_refusals(tmp_path, params):
    with pytest.raises(ValueError, match="ctypes"):
        export_rollout(params, dataclasses.replace(CFG, conv_impl="pallas"),
                       2)
    cfg = FNOConfig(**FNO_SMALL)
    with pytest.raises(ValueError, match="single-stream"):
        export_rollout(fno_init(cfg, device=CPU), cfg, 2, streams=2)
    with pytest.raises(ValueError, match="tpu"):
        export_rollout(params, CFG, 2, platforms=["tpu", "cpu"])
    with pytest.raises(ValueError, match="stream_chunk"):
        export_rollout(params, CFG, 2, stream_chunk=2)
    with pytest.raises(ValueError, match="divisible"):
        export_rollout(params, CFG, 2, streams=3, stream_chunk=2)
    path = save_bundle(tmp_path / "b", params, CFG, 2)
    meta = json.loads((path / "bundle.json").read_text())
    meta["format_version"] = 999
    (path / "bundle.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format_version"):
        load_bundle(path, device=CPU)
    # a bundle named for the card only is refused on the CPU, by name
    path = save_bundle(tmp_path / "c", params, CFG, 2, platforms=["cuda"])
    with pytest.raises(ValueError, match="runs on cuda, not on cpu"):
        load_bundle(path, device=CPU)


def test_a_program_moved_between_devices_runs_there(tmp_path, params):
    """The trace bakes its device into the graph (the zeros of the
    rollout's flags, the charges table); ``load_bundle`` moves a program
    traced elsewhere with ``move_to_device_pass``. The CPU stands in for
    the card here: a bundle marked as traced on another device is moved
    and still equals the rollout."""
    aa, window = _inputs()
    path = save_bundle(tmp_path / "b", params, CFG, 3, clip=100.0)
    meta = json.loads((path / "bundle.json").read_text())
    meta["traced_on"] = "meta"
    (path / "bundle.json").write_text(json.dumps(meta))
    bundle = load_bundle(path, device=CPU)
    want = make_rollout_fn(CFG, 3, clip=100.0, device=CPU)(params, aa, window)
    assert cli.same_outputs(bundle(aa, window), want)


def test_cli_end_to_end_with_its_selftest(tmp_path, params, capsys):
    ckpt = tmp_path / "ckpt.npz"
    save_checkpoint(ckpt, params)
    flags = ["--checkpoint", str(ckpt), "--num_steps", "3", "--clip", "100.0",
             "--width", "16", "--kernel_width", "32", "--depth", "2",
             "--window_size", "4", "--num_residues", "12", "--graph_mode",
             "sparse", "--max_edges", "64", "--compute_dtype", "float32",
             "--predict_delta", "--device", "cpu"]
    out = cli.main(flags + ["--out", str(tmp_path / "b"), "--streams", "4",
                            "--stream_chunk", "2", "--collect", "both"])
    assert "selftest ok" in capsys.readouterr().out
    bundle = load_bundle(out, device=CPU)
    assert bundle.cfg == CFG
    assert bundle.meta["extra"]["checkpoint"] == str(ckpt)
    aa, window = _inputs(streams=4)
    assert bundle(aa, window)[0][0].shape == (4, 3, 12, 3)
    # a bundle for the card only, made on the CPU: no self-test here
    cli.main(flags + ["--out", str(tmp_path / "c"), "--platforms", "cuda"])
    assert "selftest skipped" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="--platforms tpu"):
        cli.parse_args(["--out", "o", "--platforms", "tpu", "cpu"])
    # the flags are the JAX CLI's, plus --device
    from molecular_dynamics_neural_operator_tpu.cli import export as jax_cli

    ours = vars(cli.parse_args(["--out", "o"]))
    assert ours.pop("device") is None
    assert ours == vars(jax_cli.parse_args(["--out", "o"]))


def test_cli_fno(tmp_path, capsys):
    cfg = FNOConfig(num_residues=28)
    ckpt = tmp_path / "fno.npz"
    save_checkpoint(ckpt, fno_init(cfg, seed=0, device=CPU))
    out = cli.main(["--operator", "fno", "--checkpoint", str(ckpt), "--out",
                    str(tmp_path / "f"), "--num_steps", "2",
                    "--num_residues", "28", "--device", "cpu"])
    assert "selftest ok" in capsys.readouterr().out
    bundle = load_bundle(out, device=CPU)
    channels0 = np.random.default_rng(2).standard_normal(
        (28, 28, cfg.in_channels)).astype(np.float32)
    assert bundle(channels0)[0].shape == (2, 28, 28)


def _jax_small(**kw):
    return jax_configs.ModelConfig(**{**SMALL, **kw})


@pytest.mark.parametrize("streams", [0, 4])
def test_port_bundle_against_the_jax_bundle(tmp_path, streams):
    """The same weights through both packages' bundles, 8 steps in f32."""
    n = 8
    jcfg = _jax_small()
    jparams = jax_gkn_init(jax.random.PRNGKey(0), jcfg)
    aa, window = _inputs(streams=streams)
    chunk = 2 if streams else None
    jb = jax_load_bundle(jax_save_bundle(
        tmp_path / "j", jparams, jcfg, n, clip=100.0, streams=streams,
        stream_chunk=chunk, collect="both"))
    (jc, jm), jw, jd = jb(jnp.asarray(aa), jnp.asarray(window))
    pb = load_bundle(save_bundle(
        tmp_path / "p", params_from_jax(jparams, device=CPU), CFG, n,
        clip=100.0, streams=streams, stream_chunk=chunk, collect="both"),
        device=CPU)
    (pc, pm), pw, pd = pb(aa, window)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pd["edge_overflow"].numpy(),
                                  np.asarray(jd["edge_overflow"]))


def test_port_fno_bundle_against_the_jax_bundle(tmp_path):
    n = 8
    jcfg = jax_configs.FNOConfig(**FNO_SMALL)
    jparams = jax_fno_init(jax.random.PRNGKey(0), jcfg)
    channels0 = np.random.default_rng(2).standard_normal(
        (12, 12, 3)).astype(np.float32) + 5.0
    jp, jch = jax_load_bundle(jax_save_bundle(tmp_path / "j", jparams, jcfg,
                                              n))(jnp.asarray(channels0))
    pb = load_bundle(save_bundle(tmp_path / "p",
                                 params_from_jax(jparams, device=CPU),
                                 FNOConfig(**FNO_SMALL), n), device=CPU)
    pp, pch = pb(channels0)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pch.numpy(), np.asarray(jch), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("operator", ["gkn", "fno"])
def test_the_jax_package_reads_the_port_bundle_config(tmp_path, params,
                                                      operator):
    if operator == "fno":
        cfg = FNOConfig(**FNO_SMALL)
        path = save_bundle(tmp_path / "f", fno_init(cfg, device=CPU), cfg, 2)
        cls, want = jax_configs.FNOConfig, jax_configs.FNOConfig(**FNO_SMALL)
    else:
        path = save_bundle(tmp_path / "b", params, CFG, 2, clip=100.0)
        cls, want = jax_configs.ModelConfig, _jax_small()
    meta = json.loads((path / "bundle.json").read_text())
    assert {"format_version", "operator", "model_config", "rollout",
            "platforms", "torch_version"} <= set(meta)
    assert "jax_version" not in meta and meta["operator"] == operator
    assert jax_configs._from_dict(cls, meta["model_config"]) == want
    # and the JAX package reads the weights back into its own template
    from molecular_dynamics_neural_operator_tpu.utils.checkpoint import (
        restore_checkpoint,
    )

    template = (jax_fno_init(jax.random.PRNGKey(0), want) if operator == "fno"
                else jax_gkn_init(jax.random.PRNGKey(0), want))
    restored, _ = restore_checkpoint(path / "params.npz", template)
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(template)


def test_export_then_eager_fno_gives_real_equal_tensors():
    """An export of the FNO rollout must leave no trace's tensor behind:
    the DFT matrices made while ``torch.export`` traced were once cached
    and every later eager call returned FakeTensors. The shape is this
    test's own, so no earlier eager call has cached its matrices."""
    cfg = FNOConfig(width=8, modes1=3, modes2=3, depth=1, in_channels=2,
                    num_residues=13, spectral_impl="dft")
    fparams = fno_init(cfg, seed=3, device=CPU)
    channels0 = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (13, 13, 2)).astype(np.float32))

    class Rollout(torch.nn.Module):
        def forward(self, p, c):
            return fno_rollout_scan(p, cfg, c, 2)

    program = torch.export.export(Rollout(), (fparams, channels0))
    exported = program.module()(fparams, channels0)
    eager = fno_rollout_scan(fparams, cfg, channels0, 2)
    from torch._subclasses.fake_tensor import FakeTensor

    for got, want in zip(exported, eager):
        assert type(want) is torch.Tensor and type(got) is torch.Tensor
        assert not isinstance(want, FakeTensor)
        assert torch.equal(got, want)
    mats = fno_mod._dft_tensors(13, 13, 3, 3, torch.device(CPU))
    assert all(type(m) is torch.Tensor for m in mats)
