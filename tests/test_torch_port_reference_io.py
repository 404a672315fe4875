"""The port's reference-checkpoint converters (``utils/torch_import.py``,
``utils/torch_export.py``) against the reference architecture's replica
(``tools/torch_replica.py``) and against the JAX package's converters.

As ``tests/test_torch_parity.py`` does for JAX: a ``TorchKernelNN`` (and
the older no-LSTM ``TorchLegacyKernelNN``) state dict is imported, and the
port's forward on one example equals the replica's within rtol 1e-4 /
atol 1e-5 (f32, sums in another order). The port's import equals JAX's
leaf for leaf exactly (both transpose the same f32 values), and export
then import gives the parameters back bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from molecular_dynamics_neural_operator_tpu.configs import (
    ModelConfig as JaxModelConfig,
)
from molecular_dynamics_neural_operator_tpu.models import (
    gkn_init as jax_gkn_init,
)
from molecular_dynamics_neural_operator_tpu.utils import (
    torch_export as jax_export,
)
from molecular_dynamics_neural_operator_tpu.utils import (
    torch_import as jax_import,
)
from molecular_dynamics_neural_operator_tpu_torch.configs import ModelConfig
from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
    contact_map,
    dense_edge_features,
)
from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
    DenseGraph,
    gkn_apply_single,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
    params_from_jax,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.torch_export import (
    export_reference_state_dict,
    save_reference_checkpoint,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.torch_import import (
    import_legacy_state_dict,
    import_reference_checkpoint,
    import_reference_state_dict,
    is_legacy_state_dict,
)
from tools.torch_replica import TorchKernelNN, TorchLegacyKernelNN

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-5


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _example(r, t, seed):
    rng = np.random.default_rng(seed)
    window = rng.normal(size=(t, r, 3)).astype(np.float32) * 4
    aa = rng.integers(0, 20, r).astype(np.int64)
    frame = window[-1]
    d2 = ((frame[:, None] - frame[None]) ** 2).sum(-1)
    src, dst = np.nonzero(d2 < 64.0)
    edge_attr = np.concatenate([frame[src], frame[dst]], axis=1)
    return (window, aa, torch.tensor(np.stack([src, dst])),
            torch.tensor(edge_attr.astype(np.float32)))


def _port_forward(params, cfg, window, aa):
    w = torch.as_tensor(window)
    frame = w[-1]
    graph = DenseGraph(adj=contact_map(frame, 8.0),
                       edge_feats=dense_edge_features(frame))
    with torch.no_grad():
        return gkn_apply_single(params, cfg, torch.as_tensor(aa), w,
                                graph).numpy()


def test_forward_parity_with_the_reference_replica():
    torch.manual_seed(0)
    width, ker_width, depth, t, r = 16, 32, 2, 4, 10
    model = TorchKernelNN(width, ker_width, depth, t, r).eval()
    window, aa, edge_index, edge_attr = _example(r, t, 0)
    with torch.no_grad():
        ref = model(torch.tensor(window), torch.tensor(aa), edge_index,
                    edge_attr).numpy()
    cfg = ModelConfig(width=width, ker_width=ker_width, depth=depth,
                      window_size=t, num_residues=r, compute_dtype="float32")
    # DataParallel's prefix is taken off; the tensors are taken as they are
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    assert not is_legacy_state_dict(sd)
    params = import_reference_state_dict(sd, cfg, device=CPU)
    assert set(params) == set(gkn_init(cfg, device=CPU))
    np.testing.assert_allclose(_port_forward(params, cfg, window, aa), ref,
                               rtol=RTOL, atol=ATOL)


def test_legacy_forward_parity_with_the_reference_replica():
    torch.manual_seed(1)
    width, ker_width, depth, r = 16, 32, 3, 10
    model = TorchLegacyKernelNN(width, ker_width, depth).eval()
    window, aa, edge_index, edge_attr = _example(r, 1, 1)
    with torch.no_grad():
        ref = model(torch.tensor(window[0]), torch.tensor(aa), edge_index,
                    edge_attr).numpy()
    cfg = ModelConfig(width=width, ker_width=ker_width, depth=depth,
                      window_size=1, num_residues=r, compute_dtype="float32",
                      legacy_no_lstm=True)
    sd = model.state_dict()
    assert is_legacy_state_dict(sd)
    params = import_legacy_state_dict(sd, cfg, device=CPU)
    assert set(params) == set(gkn_init(cfg, device=CPU)) == {
        "emb", "fc1", "fc2", "conv1", "edge_kernel"}
    np.testing.assert_allclose(_port_forward(params, cfg, window, aa), ref,
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="legacy_no_lstm"):
        import_legacy_state_dict(
            sd, dataclasses.replace(cfg, legacy_no_lstm=False), device=CPU)


@pytest.mark.parametrize("layout", ["tied", "untied", "legacy"])
def test_the_port_import_equals_the_jax_import(layout):
    kw = dict(width=16, ker_width=32, depth=2, window_size=4,
              num_residues=10, compute_dtype="float32")
    if layout == "untied":
        kw["tie_edge_kernel"] = False
    if layout == "legacy":
        kw.update(window_size=1, legacy_no_lstm=True)
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_gkn_init(jax.random.PRNGKey(5), jcfg))
    sd = jax_export.export_reference_state_dict(jparams, jcfg) \
        if layout != "legacy" else None
    if layout == "legacy":
        sd = {k: v.numpy() for k, v in
              export_reference_state_dict(params_from_jax(jparams, CPU),
                                          cfg).items()}
        want = jax_import.import_legacy_state_dict(sd, jcfg)
        got = import_legacy_state_dict(sd, cfg, device=CPU)
    else:
        want = jax_import.import_reference_state_dict(sd, jcfg)
        got = import_reference_state_dict(sd, cfg, device=CPU)
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("layout", ["tied", "untied", "legacy"])
def test_export_then_import_is_exact(tmp_path, layout):
    kw = dict(width=16, ker_width=32, depth=2, window_size=4,
              num_residues=10, compute_dtype="float32")
    if layout == "untied":
        kw["tie_edge_kernel"] = False
    if layout == "legacy":
        kw.update(window_size=1, legacy_no_lstm=True)
    cfg = ModelConfig(**kw)
    params = gkn_init(cfg, seed=3, device=CPU)
    sd = export_reference_state_dict(params, cfg)
    if layout == "legacy":
        assert is_legacy_state_dict(sd)
    else:
        # the reference's key set: both conv stacks' nets, tied or not
        jcfg = JaxModelConfig(**kw)
        jsd = jax_export.export_reference_state_dict(
            jax.tree_util.tree_map(np.asarray,
                                   jax_gkn_init(jax.random.PRNGKey(0), jcfg)),
            jcfg)
        assert set(sd) == set(jsd)
        for k, v in sd.items():
            assert tuple(v.shape) == jsd[k].shape, k
        # the port's export equals JAX's on the same weights
        jsd = jax_export.export_reference_state_dict(
            {k: v.numpy() if isinstance(v, torch.Tensor) else
             jax.tree_util.tree_map(lambda t: t.numpy(), v)
             for k, v in params.items()}, jcfg)
        for k in jsd:
            np.testing.assert_array_equal(sd[k].numpy(), jsd[k], err_msg=k)
    path = tmp_path / "best.pt"
    save_reference_checkpoint(path, params, cfg, epoch=7)
    assert torch.load(path, weights_only=True)["epoch"] == 7
    for back in (import_reference_checkpoint(path, cfg, device=CPU),
                 (import_legacy_state_dict if layout == "legacy"
                  else import_reference_state_dict)(sd, cfg, device=CPU)):
        a, b = dict(_leaves(params)), dict(_leaves(back))
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
