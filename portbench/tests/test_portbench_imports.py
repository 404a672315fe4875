"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "molecular_dynamics_neural_operator_tpu"}
PORT = "molecular_dynamics_neural_operator_tpu_torch"
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN
    if "tests" not in path.relative_to(HERE).parts:
        text = path.read_text()
        assert "BENCH_r" not in text and "bench.py" not in text


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported(path)
    assert imported(path) <= {"__future__", "math", "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference"), node.module


def test_the_check_compares_whole_names():
    from portbench import run

    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=run.FORBIDDEN.index))
    assert PORT.split(".")[0] not in run.FORBIDDEN
