"""Every file the benchmark names parses, the harness finds each by
name, and BENCHMARK.json keeps to the benchmark's contract."""

import importlib.util
import json
import re

import pytest

from portbench import run
from portbench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    body = json.loads((REPO / cfg["file"]).read_text())
    assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert cfg["file"].startswith("portbench/configs/")
    for key in ("model", "weights", "limits"):
        assert key in body
    assert (REPO / body["reference"]).exists()
    for key in cfg["reduced"]:
        assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
        assert "width" not in key


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = json.loads((REPO / "portbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    entry = run.load_module(REPO / "portbench" / "entries"
                            / f"{mix['entry']}.py", "entry_" + mix["entry"])
    for fn in ("setup", "window", "release", "judge", "end_to_end", "work"):
        assert callable(getattr(entry, fn))
    e2e = {m["name"] for m in run.end_to_end_for(BENCH, cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.per_layer_for(BENCH, cell["name"], e2e)


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_is_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    path = REPO / "portbench" / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    cells = {w["name"]: w for w in BENCH["workloads"]}
    for cell in metric["workloads"]:
        e2e = {m["name"] for m in run.end_to_end_for(BENCH, cell)}
        assert metric["moves"] in e2e


def test_end_to_end_bounds_and_layers():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    layers = (REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in layers, m["layer"]
