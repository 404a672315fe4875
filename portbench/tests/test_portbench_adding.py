"""A later change adds a configuration, a cell, a per-layer metric, a
kind of traffic and a source of start windows by adding files and
BENCHMARK.json entries alone: dropped into a copy, they are found by name
and run at a tiny size on the CPU, and no file the copy already had
changes."""

import hashlib
import json

from portbench.tests import tiny

READER = '''"""Mean real edges a step of the window, as counted."""


def read(run):
    reals = run.work.get("real_edges")
    return None if reals is None else float(reals.mean())
'''

KIND = '''"""Calls in pairs from one window: ``pool`` windows, each twice."""

import numpy as np


def make(mix, model, starts, rng, seconds):
    drawn = [starts.draw() for _ in range(mix["pool"])]
    return {"windows": np.stack([w[None] for w in drawn for _ in range(2)]),
            "steps_per_call": mix["steps_per_call"]}
'''

SOURCE = '''"""A straight chain 3.8 A apart, shaken by 0.3 A in every frame."""

import numpy as np


class Source:
    def __init__(self, spec, model, rng):
        self.rng, self.t = rng, model["window_size"]
        r = model["num_residues"]
        self.line = np.zeros((r, 3), np.float32)
        self.line[:, 0] = np.arange(r) * 3.8
        self.aa = rng.integers(0, 20, r).astype(np.int32)

    def draw(self):
        shake = self.rng.normal(scale=0.3, size=(self.t,) + self.line.shape)
        return (self.line[None] + shake).astype(np.float32)
'''


def digest(root):
    return {str(p.relative_to(root)):
            hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_added_files_are_found_and_run(tmp_path):
    root = tiny.make(tmp_path)
    bench_path = root / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    before = digest(root)

    base = json.loads((root / bench["configs"][0]["file"]).read_text())
    base["name"] = "throwaway"
    base["model"]["depth"] = 1
    (root / "portbench/configs/throwaway.json").write_text(json.dumps(base))
    (root / "portbench/traffic/throwaway_calls.json").write_text(json.dumps({
        "entry": "rollout_scan", "kind": "throwaway_pairs",
        "steps_per_call": 12, "pool": 2, "clip": 100.0,
        "start": {"source": "throwaway_line"}, "check": {"calls": 2}}))
    (root / "portbench/traffic/kinds/throwaway_pairs.py").write_text(KIND)
    (root / "portbench/traffic/starts/throwaway_line.py").write_text(SOURCE)
    (root / "portbench/metrics/edges_per_step.py").write_text(READER)
    bench["configs"].append({
        "name": "throwaway", "source": "https://example.org/throwaway",
        "file": "portbench/configs/throwaway.json", "reduced": [],
        "why": "a test's configuration"})
    bench["workloads"].append({
        "name": "throwaway.calls", "config": "throwaway",
        "traffic": "throwaway_calls", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"][0]["workloads"].append("throwaway.calls")
    bench["per_layer"].append({
        "name": "edges_per_step", "unit": "edges", "better": "higher",
        "source": "program_counter", "layer": "Model step",
        "moves": bench["end_to_end"][0]["name"],
        "workloads": ["throwaway.calls"]})
    bench_path.write_text(json.dumps(bench))

    after = digest(root)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}

    res = tiny.execute(root, "throwaway.calls", trace=0)
    assert res["correct"] is True
    assert set(res["metrics"]) == {bench["end_to_end"][0]["name"], "setup_s"}
    res = tiny.execute(root, "throwaway.calls", trace=1)
    assert res["correct"] is True
    # the line's frames: each residue and its neighbours two apart (about
    # 134 contacts), where the chain's frames hold 170 and more
    assert 100 <= res["metrics"]["edges_per_step"]["value"] <= 160
