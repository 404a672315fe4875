"""The control, at a size a test run holds (the published widths, 600
atoms in place of 10,000, calls of 24 steps): the reference put in the
program's place in fp8 fails a limit each cell sets, while the reference
in the configuration's precision, judged the same way, passes them. On
the card, the
same readings at the cells' own size come from ``portbench.control``."""

import json

import pytest

from portbench import control
from portbench.tests import tiny

BENCH = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]




def numbers(read: dict) -> list:
    """The numbers a reading compares, each with a limit of its own."""
    return [n for n in read["limits"] if n in read]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("control"), widths=True)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit(root, cell):
    read = control.readings(cell, 11, 1, "fp8", "cpu", root)
    assert any(read[n] > read["limits"][n] for n in numbers(read)), read
    same = control.readings(cell, 11, 1, "bfloat16", "cpu", root)
    assert all(same[n] < read["limits"][n] / 10 for n in numbers(same)), same


@pytest.mark.gpu
def test_control_on_the_card(card):
    """The flagship's control at its own size on the card."""
    read = control.readings("bba.rollout.s1", 12, 1, "fp8", "cuda")
    assert any(read[n] > read["limits"][n] for n in numbers(read)), read
