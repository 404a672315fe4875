#!/usr/bin/env python3
"""Where the time of the port's cluster conv stack goes on one NVIDIA GPU
(an H100): SM clocks by phase and by warp.

    python3 tools/port_conv_stack_profile.py

Builds the port's kernels with ``-DMDNO_CONV_PROFILE`` added to the flags
(a build of its own beside the plain one: the flags are part of a
library's name) and, at the bench shapes in bf16 on the checkpoint's step
buffers, prints the clusters the card holds at once, the device time of
the profiled ``conv_head`` at 1 and 8 streams under each plan (narrow: 8
blocks a stream; wide: 16), and at one stream the SM clocks between the
marks that ``conv_stack.cuh`` documents: the prologue, a layer's phases,
and layer 3 warp by warp. The marks cost time: take ``conv_head``'s
own time from ``chip_smoke.py``. Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from molecular_dynamics_neural_operator_tpu_torch.data import (  # noqa: E402
    synthetic_trajectory,
)
from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (  # noqa: E402
    _build,
    edge_mlp as em,
    persistent_rollout as pr,
)
from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_params_npz,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    print(f"card: {cs.card_line()}")
    dev = torch.device("cuda")
    traj = synthetic_trajectory(num_frames=4000, num_residues=28, seed=13)
    params = load_params_npz(cs.CKPT, device=dev)
    cfg = cs.bench_cfg("bfloat16")
    _build.FLAGS = (*_build.FLAGS, "-DMDNO_CONV_PROFILE")
    lib = _build.load_kernels()["conv_head"]
    prepared = pr.PreparedRollout(params, cfg, np.asarray(traj.aminoacids),
                                  cs.THRESHOLD, cs.CLIP, dev)
    for wide, name in ((False, "narrow (8-block)"), (True, "wide (16-block)")):
        n = pr.conv_head_clusters(28, cfg.width, cfg.max_edges,
                                  torch.bfloat16, wide=wide)
        print(f"the card holds {n} {name} clusters at once")
    for plan, nb in (("narrow", 8), ("wide", 16)):
        # each plan at both stream counts, whatever the wrapper's rule picks
        pr.conv_head_plan = lambda streams, wide, plan=plan: plan
        for s in (1, 8):
            win = torch.as_tensor(np.stack(
                [traj.positions[500 * i:500 * i + cfg.window_size]
                 for i in range(s)]), device=dev)
            bufs = prepared.buffers(s, 28)
            coords = torch.empty(s, 28, 3, device=dev)
            pr.graph_encode(win, prepared.weights, cs.THRESHOLD, bufs)
            em.edge_mlp_stack(bufs.ef.view(s * cfg.max_edges, 6),
                              prepared.weights["mlp"], bufs.mask.view(-1),
                              bufs.h1, bufs.h2, bufs.kmat)
            ms = cs.device_ms(lambda: pr.conv_head(
                bufs, prepared.weights, cfg, cs.CLIP, win, coords))
            print(f"{plan} plan: conv_head at {s} stream(s): "
                  f"{ms * 1e3:.2f} us")
            if s == 1:
                pr.conv_head(bufs, prepared.weights, cfg, cs.CLIP, win,
                             coords)
                torch.cuda.synchronize()
                print_marks(lib, cfg, nb)
    return 0


def print_marks(lib, cfg, nb: int) -> None:
    """The clock marks of the last launch at one stream on clusters of nb
    blocks."""
    marks = (ctypes.c_longlong * 64)()
    lib.mdno_conv_profile(marks)
    t = list(marks)
    print("  prologue, SM clocks from the start: degrees and "
          f"x0 {t[1] - t[0]}, nodes dealt {t[2] - t[0]}, edge "
          f"lists {t[3] - t[0]}, cluster up {t[4] - t[0]}, K "
          f"staged {t[5] - t[0]}")
    layers = range(2 * cfg.depth)
    msgs = [t[6 + 3 * i] - t[5 + 3 * i] for i in layers]
    wait = [t[8 + 3 * i] - t[7 + 3 * i] for i in layers]
    print(f"  a layer, mean SM clocks of block 0's first warp: "
          f"its items {np.mean(msgs):.0f}, its wait for the "
          f"layer's x' from all blocks {np.mean(wait):.0f}; "
          f"the whole call {t[5 + 6 * cfg.depth] - t[0]}")
    wm = (ctypes.c_longlong * (16 * 32 * 8))()
    lib.mdno_conv_warp_profile(wm)
    w = np.array(list(wm)).reshape(16, 32, 8)[:nb, :8]
    busy = w[:, :, 6] - w[:, :, 1] > 300  # warps with items
    t0 = w[:, :, 0][busy].min()
    names = ((0, "waits for x from"), (1, "has x at"),
             (2, "root product and edges held in registers "
                 "done at"), (3, "staged edges done at"),
             (5, "x' sent at"))
    print("  layer 3, SM clocks from the moment the first warp "
          "of the stream is ready for it; a row is a block, a "
          f"column a warp ({2 if nb == 8 else 4} warps a node; - has no "
          "item)")
    for k, name in names:
        print(f"  {name}")
        for b in range(nb):
            print("   ", " ".join(
                f"{v - t0:5d}" if ok else "    -"
                for v, ok in zip(w[b, :, k], busy[b])))
    done = w[:, :, 3][busy] - t0
    print(f"  layer 3's longest item done at {done.max()}, the median "
          f"at {int(np.median(done))}")


if __name__ == "__main__":
    sys.exit(main())
