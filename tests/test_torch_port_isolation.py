"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points run on the card unless asked not to.

The import check reads the source with ``ast``: a runtime
``'jax' in sys.modules`` check would say nothing here, where JAX is
imported before any test runs.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "molecular_dynamics_neural_operator_tpu_torch"
JAX_PACKAGE = "molecular_dynamics_neural_operator_tpu"


def _imported_modules(path: Path):
    """Every module a file imports and, for ``from X import Y``, X.Y too
    (Y may be a module of the package X)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{alias.name}" for alias in node.names)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == JAX_PACKAGE


# the rank workers of the parallel tests run in spawned processes that
# import their module, so it must stand alone as the port does
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "tests" / "test_torch_port_parallel_ranks.py",
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_tells_the_port_from_the_jax_package():
    assert _forbidden("molecular_dynamics_neural_operator_tpu.configs")
    assert _forbidden("molecular_dynamics_neural_operator_tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("molecular_dynamics_neural_operator_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def _above_the_loop_layer(module: str) -> bool:
    """What ``ops/cuda/graphs.py`` may not import: a kernel wrapper of
    ``ops/cuda/`` (its build and launch helpers excepted) or a layer that
    builds on the graphs."""
    port = "molecular_dynamics_neural_operator_tpu_torch."
    if not module.startswith(port):
        return False
    parts = module[len(port):].split(".")
    if parts[:2] == ["ops", "cuda"]:
        return len(parts) > 2 and parts[2] not in ("_launch", "_build")
    return parts[0] in ("models", "rollout", "train", "serving", "parallel")


def test_the_graph_layer_imports_no_kernel_wrapper_and_no_layer_above():
    """The loop layer counts launches through the program counters, so it
    knows no kernel wrapper by name and nothing that replays its graphs."""
    path = PORT / "ops" / "cuda" / "graphs.py"
    bad = sorted({m for m in _imported_modules(path)
                  if _above_the_loop_layer(m)})
    assert not bad, f"ops/cuda/graphs.py imports {bad}"
    port = "molecular_dynamics_neural_operator_tpu_torch"
    assert _above_the_loop_layer(f"{port}.ops.cuda.persistent_rollout")
    assert _above_the_loop_layer(f"{port}.ops.cuda.fused_gkn.fused_weights")
    assert _above_the_loop_layer(f"{port}.train.graphed")
    assert _above_the_loop_layer(f"{port}.parallel")
    assert not _above_the_loop_layer(f"{port}.ops.cuda._launch")
    assert not _above_the_loop_layer(f"{port}.ops.cuda")
    assert not _above_the_loop_layer(f"{port}.utils.profiling.count")
    assert not _above_the_loop_layer("torch.distributed")


@pytest.mark.parametrize("path, allowed", [
    ("ops/edge_conv.py", {"ops.cuda.edge_mlp", "ops.mlp"}),
    ("ops/cuda/edge_mlp.py", {"ops.cuda._launch"}),
])
def test_the_edge_mlp_wrapper_sits_below_the_op_layer(path, allowed):
    """``ops/edge_conv.py`` reaches the hand-written edge MLP through its
    own wrapper module, and that module needs nothing of the port but the
    launch helpers and the counters: neither imports a rollout module,
    and the wrapper no op layer."""
    port = "molecular_dynamics_neural_operator_tpu_torch."
    reached = {m[len(port):] for m in _imported_modules(PORT / path)
               if m.startswith((port + "ops.", port + "rollout",
                                port + "models", port + "serving"))}
    bad = {m for m in reached
           if not any(m == a or m.startswith(a + ".") for a in allowed)}
    assert not bad, f"{path} imports {sorted(bad)}"
    assert allowed <= reached


def test_every_kernel_source_names_what_it_replaces_and_its_bound():
    sources = sorted((PORT / "csrc").glob("*.cu"))
    replaced = {"graph_encode": "ops/pallas/persistent_rollout.py",
                "edge_mlp": "ops/pallas/persistent_rollout.py",
                "conv_head": "ops/pallas/persistent_rollout.py",
                "train_conv_fwd": "ops/pallas/train_conv.py",
                "train_conv_bwd": "ops/pallas/train_conv.py",
                "fused_gkn": "ops/pallas/fused_gkn.py"}
    assert {p.stem for p in sources} == set(replaced)
    for p in sources:
        text = p.read_text()
        assert replaced[p.stem] in text
        assert "Bound:" in text
        assert "cudaGetLastError" in text
    # the native packer is a host helper beside them, not a kernel
    assert (PORT / "csrc" / "packing.cpp").exists()
    assert "packing" not in {p.stem for p in sources}
    # the headers two sources share say which; _build.py hashes them all
    for header in ("edge_mlp.cuh", "conv_stack.cuh"):
        assert "fused_gkn.cu" in (PORT / "csrc" / header).read_text()


def test_the_new_modules_are_among_the_checked_sources():
    checked = {str(p.relative_to(PORT)) for p in SOURCES
               if p.is_relative_to(PORT)}
    assert {"serving/server.py", "serving/__init__.py", "cli/serve.py",
            "cli/__init__.py", "preprocess/grid.py", "preprocess/__init__.py",
            "ops/cuda/fused_gkn.py", "ops/cuda/_plain.py",
            "cli/train.py", "cli/rollout.py", "data/schema.py",
            "data/h5.py", "data/synthetic.py", "presets.py", "configs.py",
            "utils/checkpoint.py", "utils/metrics.py", "utils/profiling.py",
            "utils/movie.py", "utils/latent.py", "utils/backbone.py",
            "serving/export.py", "cli/export.py", "cli/preprocess.py",
            "utils/torch_import.py", "utils/torch_export.py",
            "preprocess/electrostatics.py", "data/packing.py",
            "data/prefetch.py", "parallel/__init__.py", "parallel/comm.py",
            "parallel/mesh.py", "parallel/rollout_sharded.py",
            "parallel/edge_sharded.py",
            "parallel/rollout_edge_sharded.py"} <= checked
    assert ROOT / "tests" / "test_torch_port_parallel_ranks.py" in SOURCES


def test_an_edited_header_rebuilds_every_kernel(tmp_path, monkeypatch):
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import _build

    before = {name: _build._target(name).name for name in _build.SOURCES}
    assert set(_build.SOURCES) == {p.stem
                                   for p in (PORT / "csrc").glob("*.cu")}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in (PORT / "csrc").iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert {n: _build._target(n).name for n in _build.SOURCES} == before
    with open(csrc / "conv_stack.cuh", "a") as f:
        f.write("// edited\n")
    after = {name: _build._target(name).name for name in _build.SOURCES}
    assert all(after[name] != before[name] for name in before)


def test_entry_points_default_to_the_card(monkeypatch):
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
        TrainConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.persistent_rollout import (  # noqa: E501
        make_persistent_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    from molecular_dynamics_neural_operator_tpu_torch.cli import (
        export as cli_export,
        preprocess as cli_preprocess,
        rollout as cli_rollout,
        serve,
        train as cli_train,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        init_distributed,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
        load_bundle,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
        serve_follower,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.torch_import import (  # noqa: E501
        import_reference_checkpoint,
        import_reference_state_dict,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(graph_mode="sparse")
    for make in (lambda: make_rollout_fn(cfg, 2),
                 lambda: make_persistent_rollout_fn(cfg, 2),
                 lambda: RolloutServer({}, cfg),
                 lambda: RolloutServer({}, cfg, impl="persistent", aa=[0]),
                 lambda: serve._load(serve.parse_args([])),
                 lambda: create_train_state(0, cfg, TrainConfig()),
                 lambda: cli_train.main(["--data_path", "x.h5", "--run_path",
                                         "r", "--graph_mode", "sparse"]),
                 lambda: cli_train.main(["--data_path", "x.h5", "--run_path",
                                         "r", "--graph_mode", "sparse",
                                         "--data_parallel"]),
                 lambda: serve.main(["--data_mesh", "2"]),
                 lambda: init_distributed(),
                 lambda: serve_follower({}, cfg, None),
                 lambda: cli_rollout.main(["--data_path", "x.h5",
                                           "--out_path", "o",
                                           "--graph_mode", "sparse"]),
                 lambda: load_params_npz(ROOT / "tools" / "bench_ckpt.npz"),
                 lambda: cli_export.main(["--checkpoint", "x.npz", "--out",
                                          "o"]),
                 lambda: cli_preprocess.main(
                     ["--mode", "dh", "--pdb_files", "x.pdb", "--traj_files",
                      "x.h5", "--scratch_dir", "s", "--results_dir", "r"]),
                 lambda: load_bundle("no_bundle"),
                 lambda: import_reference_state_dict({}, cfg),
                 lambda: import_reference_checkpoint("x.pt", cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    make_rollout_fn(cfg, 2, device="cpu")
    make_persistent_rollout_fn(cfg, 2, device="cpu")
