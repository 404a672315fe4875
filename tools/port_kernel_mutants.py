#!/usr/bin/env python3
"""Mutation check of the port's kernels on an NVIDIA GPU: the three of the
rollout step and the two of the training conv stack, with the wrapper that
launches the latter.

    python3 tools/port_kernel_mutants.py

Makes twelve deliberately broken copies of the repository in a temporary
directory (one source line changed in each: see MUTANTS), builds each on
the card and runs ``chip_smoke.py --only <the mutant's path>`` in it. Every
copy must exit non-zero; the script prints each copy's exit code and
failure line and exits 0 only if all twelve failed. A pattern that no longer
matches the source raises: bring the pattern up to date with the kernel.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "molecular_dynamics_neural_operator_tpu_torch/"

# (what is broken, file in the package, the line as it is, the line as
# broken, the chip_smoke.py path that must fail)
MUTANTS = [
    ("graph_encode: the last row's offset one slot too far",
     "csrc/graph_encode.cu",
     "      rowoff[i] = acc;", "      rowoff[i] = acc + (i == R - 1);",
     "rollout"),
    ("graph_encode: the LSTM's last step skipped",
     "csrc/graph_encode.cu",
     "    for (int t = 0; t < T; ++t) {", "    for (int t = 0; t < T - 1; ++t) {",
     "rollout"),
    ("edge_mlp: k-tile 1 of every product skipped", "csrc/edge_mlp.cuh",
     "        wgmma_ss(acc[j], da,",
     "        if (kt != 1) wgmma_ss(acc[j], da,", "rollout"),
    ("edge_mlp: B tile read one swizzle row off", "csrc/edge_mlp.cuh",
     "kk * 2048, 1024 >> 4)", "kk * 2048 + 128, 1024 >> 4)", "rollout"),
    ("edge_mlp: first layer (narrow kernel) without its ReLU",
     "csrc/edge_mlp.cuh",
     "      if (relu) v[i] = relu_nan(v[i]);\n"
     "      if (row_mask) v[i] = v[i] * mk;",
     "      if (row_mask) v[i] = v[i] * mk;", "rollout"),
    ("conv stack: the last incoming edge of one node dropped",
     "csrc/conv_stack.cuh", "        L.lmsk[i] = L.gmsk[e];",
     "        L.lmsk[i] = (rank == 0 && n == 0 && i == L.nstart[n + 1] - 1)"
     " ? 0.f : L.gmsk[e];", "rollout"),
    ("conv stack, tensor-core body: the x buffers not swapped for layer 3",
     "csrc/conv_stack.cuh", "(unsigned)(layer & 1 ? l.xb : l.xa)",
     "(unsigned)((layer & 1) && layer != 3 ? l.xb : l.xa)", "rollout"),
    ("conv stack, CUDA-core body: the x buffers not swapped after layer 3",
     "csrc/conv_stack.cuh", "{ float* t = xc; xc = xn; xn = t; }",
     "if (layer != 3) { float* t = xc; xc = xn; xn = t; }", "rollout"),
    ("training forward, tensor-core body: stack layer 4 not written",
     "csrc/conv_stack.cuh", "        if (stack != nullptr && t == 0) {",
     "        if (stack != nullptr && t == 0 && layer != 3) {", "train"),
    ("training backward: one out-edge of one node dropped in the sweep "
     "(the last one rank 0's first node holds in registers)",
     "csrc/conv_stack_bwd.cuh", "          if (e < nheld) add(d);",
     "          if (e < nheld && !(rank == 0 && it.j == L.mynode[0] &&"
     " e == nheld - 1)) add(d);", "train"),
    ("training backward: layer 3 left out of the dK sum",
     "csrc/conv_stack_bwd.cuh", "ldmatrix_x4_trans(b, lay < nlayers ?",
     "ldmatrix_x4_trans(b, lay < nlayers && lay != 3 ?", "train"),
    ("training forward: the activation stack kept in one buffer per shape "
     "and reused by the next call (a step's backward reads its stack before "
     "the next forward, the curriculum's K backwards after all K forwards)",
     "ops/cuda/train_conv.py",
     "    stack = torch.empty(b, 2 * depth + 1, r, w, device=dev)",
     "    stack = _plans.setdefault((\"stack\", b, depth, r, w), "
     "torch.empty(b, 2 * depth + 1, r, w, device=dev))", "train"),
]


def mutate(text: str, old: str, new: str) -> str:
    """``text`` with the first ``old`` replaced; raises if there is none."""
    if old not in text:
        raise ValueError(f"pattern not in the source any more: {old!r}")
    return text.replace(old, new, 1)


def main() -> int:
    work = Path(tempfile.mkdtemp(prefix="port_mutants_"))
    passed = []
    for i, (name, target, old, new, path) in enumerate(MUTANTS):
        copy = work / f"mutant{i}"
        shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
            "build", ".git", "__pycache__", "runs"))
        source = copy / PKG / target
        source.write_text(mutate(source.read_text(), old, new))
        run = subprocess.run([sys.executable, "chip_smoke.py", "--only",
                              path], cwd=copy, capture_output=True,
                             text=True)
        fails = [line for line in run.stdout.splitlines() if "FAIL" in line]
        print(f"mutant {i} ({name}): exit {run.returncode}; "
              f"{fails[-1] if fails else run.stdout[-300:] + run.stderr[-600:]}",
              flush=True)
        if run.returncode == 0:
            passed.append(name)
    shutil.rmtree(work, ignore_errors=True)
    print("A MUTANT PASSED: " + "; ".join(passed) if passed
          else "ALL MUTANTS FAILED THE SMOKE RUN")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
