"""The operation and byte counts against hand counts at the flagship's
shapes (BBA: R = 28, T = 10, width 64, ker_width 1024, depth 6, bf16,
one stream) and the published bounds they give."""

import json

import pytest

from portbench.counts import gkn, peaks
from portbench.tests.tiny import REPO

MODEL = json.loads((REPO / "portbench/configs/bba_1fme_sparse.json")
                   .read_text())["model"]
REAL = 200


def test_edge_mlp_counts():
    nbytes, ops, peak = gkn.edge_mlp(MODEL, REAL)
    weights = (6 * 1024 * 2 + 1024 * 4) + (1024 * 1024 * 2 + 1024 * 4) \
        + (1024 * 4096 * 2 + 4096 * 4)
    assert nbytes == weights + REAL * (6 * 2 + 4 + 4096 * 2)
    assert ops == 2 * REAL * (6 * 1024 + 1024 * 1024 + 1024 * 4096)
    assert peak == 989e12
    # bound by the weights' bytes: 10.5 MB at 3.35 TB/s, about 3.6 us
    assert peaks.bound_s(nbytes, ops, peak) == pytest.approx(
        nbytes / 3.35e12)
    assert 3.5e-6 < nbytes / 3.35e12 < 3.8e-6


def test_conv_head_counts():
    nbytes, ops, peak = gkn.conv_head(MODEL, REAL)
    fixed = (28 * 64 * 4 + 28 * 4 + 2 * (64 * 64 * 2 + 64 * 4)
             + (64 * 3 + 3) * 4 + 2 * 10 * 28 * 3 * 4 + 28 * 3 * 4)
    assert nbytes == fixed + REAL * (64 * 64 * 2 + 8 + 4)
    assert ops == 12 * (2 * REAL * 4096 + 2 * 28 * 4096) + 28 * 3 * 2 * 64
    assert peak == 989e12


def test_graph_encode_counts():
    nbytes, ops, peak = gkn.graph_encode(MODEL, REAL)
    weights = 4 * (28 * 4 + 96 + 12 + 7 * 64 + 64)
    assert nbytes == (10 * 28 * 3 * 4 + weights + 28 * 4 + 28 * 64 * 4 + 4
                      + REAL * (8 + 4 + 12))
    assert ops == 28 * 28 * 8 + 28 * 10 * 12 * 13 + 28 * 7 * 64 * 2
    assert peak == 67e12


def test_step_flops():
    lstm = 10 * 2 * (2 * 3 * 12)
    enc = 28 * (lstm + 2 * 9 + 2 * 7 * 64)
    mlp = 2 * REAL * (6 * 1024 + 1024 * 1024 + 1024 * 4096)
    convs = 12 * (2 * REAL * 4096 + 2 * 28 * 4096)
    head = 28 * 2 * 64 * 3
    assert gkn.step_flops(MODEL, REAL) == enc + mlp + convs + head
    # about 10.7 MFLOP an edge
    assert 10.5e6 < gkn.step_flops(MODEL, REAL) / REAL < 10.8e6


def test_kernel_bound_sums_steps():
    one = peaks.bound_s(*gkn.conv_head(MODEL, 190))
    two = peaks.bound_s(*gkn.conv_head(MODEL, 210))
    assert gkn.kernel_bound_s("conv_head", MODEL, [190, 210]) == \
        pytest.approx(one + two)
