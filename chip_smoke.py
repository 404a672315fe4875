#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``molecular_dynamics_neural_operator_tpu_torch/csrc``
and drives the port's three main paths at full width (BBA: 28 residues,
window 10, width 64, ker_width 1024, depth 6, predict_delta, bf16, data
from ``synthetic_trajectory(num_frames=4000, seed=13)``):

- rollout: the single-stream free rollout of ``bench.py`` (sparse graph
  with 224 edge slots, clip 100, the trained ``tools/bench_ckpt.npz``);
- training: teacher-forced train steps at batch 128 with 256 edge slots,
  from seeded ``gkn_init`` weights, through ``create_train_state``,
  ``make_train_step`` and ``train_epoch``, then K = 4 curriculum steps
  through ``make_curriculum_train_step`` and ``train_curriculum_recipe``;
- serving: concurrent requests through ``RolloutServer`` in process, on
  the rollout kernels (``impl="persistent"``, also with
  ``electrostatics="dh"``) and on the plain scan with the fused kernel
  (``impl="scan"``, ``conv_impl="pallas"``);
- the CLIs: ``cli/train.py``'s ``train_from_trajectory`` and
  ``cli/rollout.py``'s ``rollout_from_trajectory`` with the trajectory
  held in memory (the card's machine has no h5py to read ``--data_path``);
- the dense graph of the BBA preset, the CLIs' default, and the remaining
  GKN options (``window_diff``, the blocked layout, the segment scatter,
  int8 kernels, ``legacy_no_lstm``);
- large systems: the cell-list rebuild at 10,000 atoms, the
  ``SOLVATED_10K`` preset's rollout at full width and the config-5
  training shape;
- the FNO at the training CLI's defaults on BBA;
- serving bundles (``torch.export`` of one rollout step), the
  Debye-Hückel preprocessing grids and the host input pipeline (producer
  thread, native packer);
- the parallel modules on several ranks (``torch.distributed``): the
  data-parallel train steps, the stream- and edge-sharded rollouts and
  the mesh server.

Phases, each fatal:

1. device: a CUDA card is required; prints its name and power limit.
2. kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs at the bench shapes (1 and 4 streams in f32; 1, 3, 4 and 8
   in bf16: 224, 672, 896 and 1,792 edge rows with their real masks, which
   take different tilings of the edge MLP); the three-launch
   ``edge_mlp_stack`` against three plain layers; conv_head also with
   seeded random weights, whose conv stack stays alive where the
   checkpoint's does not, and on edge lists made to stress the way it
   deals edges to blocks (a hub whose in-degree exceeds what a block
   stages and holds at a time, a node without incoming edges, every slot
   taken with the overflow flagged).
3. full slice: the kernel rollout against the plain rollout over 128
   steps in f32 and bf16 (and 4 streams in bf16); the bf16 single-stream
   run is the main path, and every kernel must have launched in it.
4. timing: steps/s of both rollouts, and per kernel its time, its plain
   version's time, a library call's time where one computes the same
   function, and the least time the card could take (its bound).
   Then past 28 residues: ``graph_encode`` at 80 and 512 residues (dh off
   and on, f32 and bf16, 1 and 8 streams) against its plain version, with
   its bf16 times; the kernel rollout at 80 residues against the plain one
   (128 steps in bf16, 512 in f32), with the step's device time; and the
   largest residue count whose kernel rollout ``conv_head``'s plan takes
   at the flagship width, run for 16 steps.

5. train_conv vs plain: the forward kernel (output and activation stack)
   and the backward kernel (dx0, dkt, droot1/2, dbias1/2) of the training
   conv stack against their plain versions at the training shapes, f32
   and bf16.
6. training run: ``TRAIN_STEPS`` train steps in bf16 with
   ``train_conv_impl="pallas"`` (the main path; both kernels must have
   launched) and again with ``"xla"`` from the same state and batches:
   mean losses and updated parameters compared, every loss finite; one
   eval step on a held-out batch; the same steps with the edge MLP on the
   exact f32 path instead of the tensor cores.
7. training timing: device time of both kernels, their plain versions and
   bounds, the clusters the card holds at once and the waves of a batch,
   wall time of a train step on each path, samples/s, peak memory, and a
   ``torch.profiler`` breakdown of one train step (device time by kernel,
   the device's busy share).
8. serve, kernel vs plain: ``graph_encode`` with the Debye-Hückel branch
   (f32 and bf16, 1 and 4 streams) and ``fused_edge_conv_stack`` (f32 and
   bf16, 1 and 8 streams, on seeded weights whose conv layers are all
   alive, on the checkpoint, and on the stress edge lists of phase 2)
   against their plain versions.
9. serving run: (a) eight 256-step requests at once and then a mixed,
   staggered trace of twelve on ``impl="persistent"`` with the checkpoint,
   every result held against a dedicated single-stream kernel rollout;
   (b) four 128-step requests with ``electrostatics="dh"`` on seeded live
   weights, held against the dedicated kernel rollout and the plain
   rollout; (c) four 64-step requests with one sequence each on
   ``impl="scan"`` with ``conv_impl="pallas"``, held against the same
   server with ``conv_impl="xla"``. Launch counts are set to 0 before each
   run and read after it; ``stats`` must read as the trace implies.
10. serve timing: served steps/s, occupancy, the device's busy share, and
   the two new kernels' times with their plain versions and bounds.
11. curriculum: (a) one f32 K = 4 step with full backpropagation at
   B = 32 on the kernel path against the per-layer path: the same rebuilt
   edge lists at every step, then the loss and every gradient leaf;
   (b) ``TRAIN_STEPS`` K = 4 curriculum steps in bf16 (delta loss, clip
   1000) with full backpropagation and with ``grad_steps=1`` on both paths,
   held as the teacher-forced run is held, with K forward and K or 1
   backward launches a step; (c) ``train_curriculum_recipe`` for 8 steps
   on a Langevin trajectory with ``graph_frame="rebuild"``: finite losses,
   the switch to K after the warm-up and the launches changing with it.
12. curriculum timing: samples/s, device time and busy share of both K = 4
   steps beside the teacher-forced step, and the cost of the optimizer's
   finiteness guard (``skip_nonfinite_updates``). Phases 11 and 12 run
   with the training path, after phase 7.
13. cli.train: ``train_from_trajectory`` at the flagship's width (bf16,
   B = 128, 256 edge slots, ``--predict_delta --kernel_init_scale 0.1
   --lr 3e-5``) into a temporary run directory: a teacher-forced epoch, a
   ``--rollout_steps 4 --loss_space delta`` epoch, an epoch resumed from
   the first run's ``last.npz``, and the first epoch again with
   ``--train_conv_impl xla``. Finite losses; each run's launches exactly
   as its steps, eval and latent batches imply; the kernel run's mean
   epoch loss within TOL_TRAIN_LOSS of the per-layer run's; the resumed
   step and Adam count carry on; ``config.json`` reads back to the run's
   configs; ``best.npz``/``last.npz`` restore; the movie maps and latents
   are written; the epoch loop's latent sweep (batches of 256 and the
   remainder) on the final parameters, kernels against the per-layer
   path, each batch within TOL_TC_BF16 of its scale. Prints samples/s and
   steps/s of each epoch and its time beyond the steps.
14. cli.rollout: ``rollout_from_trajectory`` of ``tools/bench_ckpt.npz``
   for 128 steps with ``--impl persistent`` against ``--impl scan``, f32
   and bf16 at one stream and bf16 at four: exact launch counts, the same
   edge lists, coordinates within TOL_ROLL; then 16 steps of phase 13's
   ``best.npz``. Prints the summaries' steps/s. Phases 13 and 14 run
   last but for 15 and 16; their launches are added to the ``kernels``
   line.
15. dense (the BBA preset: the dense graph, the default of both CLIs):
   (a) the card's bf16 dense aggregation (``torch.bmm`` to f32 and its
   backward) against its plain f32 products; (b) one batch of 128 through
   the dense per-layer forward and the sparse forward on the training
   kernels from the same adjacency: f32 outputs, loss and every gradient
   leaf within TOL_DENSE, no training-kernel launch on the dense side,
   bf16 reported; (c) ``train_from_trajectory`` with the default graph
   flags (dense, B = 128, 24 steps) against the same epoch with
   ``--graph_mode sparse``, within TOL_TRAIN_LOSS, no training-kernel
   launch; (d) ``rollout_from_trajectory`` with the default graph flags,
   128 steps of the bench checkpoint on the dense scan against ``--impl
   persistent`` at E = 224 (128/384/128 launches; the bf16 dense scan
   makes its kernel tensor through the hand-written edge MLP, 3 launches
   a step, the f32 one launches nothing): in f32 the same contact
   maps at every step and coordinates within TOL_DENSE_ROLL, bf16
   reported; (e) four requests through a dense ``RolloutServer(impl=
   "scan")``, each within TOL_ROLL of a dedicated dense rollout; then,
   with no claim, the dense teacher step's wall and device time and busy
   share beside the sparse kernel and per-layer steps, and the dense and
   sparse plain scans' steps/s.
16. options: ``window_diff`` (train steps on the kernels against the
   per-layer path, held as phase 6; ``impl="scan"`` serving with the
   fused kernel against ``conv_impl="xla"``, as phase 9c); the blocked
   layout at 448 slots (the "blocked" reduction against one-hot products
   of the same graphs in f32, the training kernels against their plain
   versions on the blocked batch, train steps as phase 6); the segment
   scatter at 600 residues against a forced one-hot (forward and
   gradient, f32); the int8 codes of a real kernel tensor within half a
   step, a 128-step int8 scan rollout against bf16 (reported) and both
   rates; ``legacy_no_lstm`` on the card against the CPU (forward and
   gradient, f32).

17. large systems (of the kernels only the hand-written edge MLP, which
   makes the bf16 10k step's kernel tensor: exactly 3 launches a step,
   each run counted from just before it to just after; nothing else):
   (a) the cell list at 10,000 atoms on the card against the port's CPU
   cell list (edges, mask and both flags exactly, two frames as one
   batch) and, per node, against an all-pairs search in row blocks, on
   the loose chain of ``tools/scale_smoke.py`` and the config-5 breathing
   grid (``tools/config5_campaign.py``), at the campaign's settings
   (``LARGE_CELLS``) and with room for the chain; too small capacities
   raise ``cell_overflow`` and ``degree_overflow``. (b) ``SOLVATED_10K``
   at full width (bf16, dh, seeded weights with ``kernel_init_scale``
   1/(8·depth), the clip 1000): 16 steps on each system with every
   step's flags, no overflow on the grid's first frame, the "blocked"
   hint; 4 f32 steps with the blocked reduction against a forced segment
   scatter on the same graphs (1e-5 of the coordinates' scale); steps/s,
   device ms of a step by part (rebuild, dh, edge MLP, convs), peak
   memory. (c) the config-5 training shape (f32, width
   32, ker_width 128, depth 4, dh, blocked, KD-tree graphs): one K = 4
   step with ``grad_steps=1`` at 1,200 atoms on the card against the CPU
   (the same rebuilt edge lists, the loss and every gradient leaf within
   TOL_CURRICULUM_GRAD of its norm), then 6 steps at 10,000 atoms with
   their time and peak memory. (d) ``rollout_from_trajectory`` with
   ``--neighbor_impl cell_list`` on the bench checkpoint for 128 f32
   steps against the ranked rebuild: the same contact maps at every
   step, coordinates within TOL_ROLL. (e) ``edge_mlp_stack`` at the 10k
   step's 480,000 rows (its persistent plan) against three plain layers
   on the same inputs (phase 2's tolerance), its first 1,792 rows the
   small plans' to the bit; its time, the plain layers', the library's
   and the bound, the ``kernels`` line's ``edge_mlp_persistent``.
18. FNO (the CLI's defaults: R = 28, window 10, width 32, modes 12,
   depth 4, f32, B = 128; no kernel on the path): (a) ``_spectral_conv``
   fft against dft and the card's fft against the CPU's at R = 28 and
   160, with cuFFT's own ``irfft2`` of the same spectrum reported; (b) one
   train step, card against CPU, with ``spectral_impl`` "auto" and "fft":
   loss and every gradient leaf; (c) ``train_from_trajectory --operator
   fno``: an epoch and a ``--rollout_steps 4`` epoch on the card, the
   first on the CPU too (loss within TOL_TRAIN_LOSS), ``config.json``'s
   fno section, ``best.npz``/``last.npz``, the movie; (d) 128 steps of
   ``fno_rollout_scan`` of the trained weights, card against CPU; (e) a
   train step's samples/s, device time and busy share, rollout steps/s,
   the spectral conv's times.
19. export, preprocessing and the host pipeline (of the kernels only the
   hand-written edge MLP, 3 launches a bf16 step of a flagship bundle or
   of the in-process rollout it is held against, counted call by call;
   nothing else): (a) serving bundles
   (``serving/export.py``) of the flagship with ``tools/bench_ckpt.npz``,
   exported on the card: 128 steps with ``collect="both"`` at one stream
   and at S = 8 in chunks of 4, and with hot-swapped seeded live weights,
   each bit-equal to the in-process ``make_rollout_fn`` (coordinates,
   contact maps, final window, overflow); a bundle traced on the CPU and
   moved to the card (bit-equal, or within TOL_ROLL with the same maps);
   an FNO bundle at the CLI defaults, bit-equal to ``fno_rollout_scan``;
   ``python -m ...cli.export`` with its self-test on the card; the export
   seconds, the bundle's bytes by file, its steps/s beside the in-process
   plain path's. Each bundle call replays CUDA graphs of its step and is
   held also against ``ServingBundle.eager`` (the step loop issued from
   Python), bit for bit, the FNO's with hot-swapped weights too; the
   rates are graphed and eager, at one stream, at S = 8 and for the FNO.
   (b) ``batched_debye_huckel_grids`` on the deck's
   97 x 65 x 65 grid for 64 BBA frames and 2 frames of the 10,000-atom
   config-5 grid, held against a float64 oracle and the port on the CPU
   at a seeded sample of grid points (TOL_DH of max |phi|), and
   ``sample_grid_trilinear`` at the atoms (TOL_TRILINEAR); ms a frame,
   peak memory, the special-function bound; ``cli.preprocess --mode
   apbs`` with stub programs. (c) the native packer's batches against the
   numpy path's (bit for bit, with host ms a batch), then a CLI epoch on
   the per-layer path with the producer thread and the packer against the
   same epoch without them (loss within TOL_TRAIN_LOSS), each epoch's
   time beyond its steps.

20. parallel (``parallel/``; no kernel of its own, the training kernels
   and the fused kernel on every rank): two ranks share the card through
   gloo (NCCL refuses two ranks on one GPU), spawned by
   ``torch.multiprocessing``: (a) the data-parallel teacher step at
   B = 128 (64 a rank) on the training kernels against the
   single-process B = 128 step: the loss within TOL_TRAIN_LOSS, every
   gradient leaf within TOL_TRAIN_MOVE of its norm, each leaf's Adam
   movement as phase 6 holds it, the ranks' parameters bit-equal, 1 + 1
   launches a rank; (b) the same for a K = 4 delta curriculum step (4 +
   4); both steps run op by op on the gloo group
   (``ops/cuda/graphs.py::step_stays_eager``); (c) one NCCL rank alone:
   an all-reduce on the card, a CUDA graph holding one raw
   ``dist.all_reduce`` replayed on new inputs against the same ops issued
   eagerly, the teacher step bit-equal to the plain step, then the
   graphed data-parallel teacher (with input noise) and K = 4 steps at
   B = 128 on the training kernels against their bodies issued op by op
   (``step.eager``) over ``TRAIN_STEPS`` batches with a NaN in one, equal
   to the bit, the NaN batch leaving the state as it was, and the
   training kernels' launches from the replays; (d) the stream-sharded
   rollout of 8 streams over the ranks, bench checkpoint, the fused
   kernel, 128 steps, against the unsharded rollout (f32 within TOL_ROLL
   with the same edge lists, bf16 within phase 9c's tolerance,
   bit-equality reported); (e) the mesh server, eight requests of 7 to
   300 steps, each against a dedicated rollout (``hold_result``,
   TOL_ROLL); (f) ``SOLVATED_10K`` with phase 17's settings, its edges
   over the ranks and the cell list rebuilt by atom slice, against the
   single-process rollout (16 bf16 steps, 4 f32 steps within TOL_F32 of
   scale), a step's wall ms, the part spent in the collectives and rank
   0's device busy share (it stays eager by the cell list); the steps'
   wall and device ms issued op by op beside the single-process step,
   the part spent in the collectives. ``--ranks N`` runs (a), (b), (d),
   (e), (f) on N ranks; with a card each they take NCCL, the sharded
   steps of (a) and (b) replay CUDA graphs, and (g) runs: the graphed
   data-parallel teacher (input noise), K = 4 and FNO steps at the
   flagship's width (B = 128 over the ranks) and the edge-sharded train
   step over a ("data", "model") mesh, each against its body issued op
   by op over ``TRAIN_STEPS`` batches with a NaN in rank 0's rows of
   one, equal to the bit, the ranks' states bit-equal after, then wall
   ms graphed and eager and rank 0's device busy share. The
   single-process steps it is held against are the steps issued op by
   op (``step.eager``). A failing or hung rank ends every rank by the
   spawn's deadline, and the failure names the rank.
21. CUDA graphs (every step loop above replays them on the card; here
   each is held against its loop issued op by op): (a) the graphed
   ``PreparedRollout`` against its eager step loop, bit for bit, f32 and
   bf16 at 1, 4 and 8 streams, 128 steps (two 64-step blocks) and 100 (a
   block and a tail), the same launches, the second call of each under
   ``torch.cuda.set_sync_debug_mode("error")``; (b) bench-slope steps/s
   (64 and 576 steps) graphed and eager at 1 and 4 streams beside the
   device-time ceiling and the busy share; (c) served results on graphed
   segments, each equal to the bit to a dedicated eager rollout (the
   checkpoint on ``impl="persistent"``: eight 256-step requests and a
   mixed trace of twelve; dh in f32 and bf16; ``impl="scan"`` with the
   fused kernel against the eager scan of the same streams), and the
   8-stream served steps/s with graphed and with eager segments; (d) the
   graphed teacher-forced step (with input noise), the K = 4 curriculum
   step and the FNO step against their eager steps over ``TRAIN_STEPS``
   batches from one state, one batch with a NaN under
   ``skip_nonfinite_updates``: losses within TOL_TRAIN_LOSS and
   movements within TOL_TRAIN_MOVE (bit-equality reported), over the NaN
   batch parameters, moments and apply count bit-unchanged and the skip
   counted, every graphed step after the first under the sync check,
   each graphed and each eager teacher and K = 4 step launching exactly
   its training kernels (the ``kernels`` line counts the graphed steps'
   alone); wall ms graphed and eager beside the device busy ms, and the
   device time of the copy into the graph's static state; (e) the FNO
   step's per-step wall times with the allocator's device allocations
   and the garbage collector's runs during each; (f) a kernel rollout
   and a fused scan rollout kept across graphed train steps, each equal
   to the bit to the eager rollout of the trained parameters.
22. the dense graph's loops as CUDA graphs (of the kernels only the
   hand-written edge MLP, 3 launches a bf16 kernel tensor, each rollout
   of (a) counted call by call; nothing else): (a) the dense scan
   rollout (BBA preset,
   the bench checkpoint) graphed against its loop issued op by op, bit
   for bit, f32 and bf16, one stream and eight in chunks of four, 100
   steps collecting coordinates and contact maps, the second call under
   the sync check; (b) its steps/s graphed and eager at 1 and 4 streams,
   bf16 and f32, beside a step's device time and the busy share; (c) a
   dense bf16 ``RolloutServer(impl="scan")`` serving eight two-segment
   requests on graphed and on eager segments, every result equal to the
   bit to the eager scan of the same streams, and the served steps/s of
   both; (d) the dense teacher-forced step and K = 4 curriculum step at
   B = 128 bf16 against their eager steps over ``TRAIN_STEPS`` batches
   with a NaN in one, equal to the bit, the NaN batch leaving the state
   as it was, wall ms graphed and eager beside the device busy ms; (e)
   the ``SOLVATED_10K`` step issued op by op, its device busy ms over its
   wall ms (the figure ``ops/cuda/graphs.py::stays_eager`` cites).

The last lines are the ``kernels`` JSON (seven kernels, and the edge
MLP's persistent plan at 480,000 rows from phase 17), the card, and
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA card.
``--only rollout``, ``--only train``, ``--only serve``, ``--only cli``,
``--only dense``, ``--only options``, ``--only large``, ``--only fno``,
``--only export``, ``--only parallel`` or ``--only graphs`` (phases
21 and 22 and the bundles of 19a) runs one path's phases (for
development; the ``kernels`` line then lists that path's kernels, the
edge MLP's persistent plan for ``large``, none for ``cli``, ``dense``,
``options``, ``fno``, ``export``, ``parallel`` and ``graphs``, which
time no kernel). Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "tools" / "bench_ckpt.npz"
PKG = "molecular_dynamics_neural_operator_tpu_torch"
TPU_KERNEL = "molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py"
TPU_TRAIN_KERNEL = "molecular_dynamics_neural_operator_tpu/ops/pallas/train_conv.py"
THRESHOLD = 8.0
CLIP = 100.0
STEPS = 128
TRAIN_STEPS = 4
TRAIN_BATCH = 128
TRAIN_LR = 3e-5
# Published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them,
# device memory.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12

# Tolerances, each with its reason.
# f32 sums of up to 1024 products are taken in another order by the kernel
# than by the plain version: a few units in the last place of f32 (~1e-7
# relative) per sum, so 1e-5 of the output's scale.
TOL_F32 = 1e-5
# bf16 outputs of the edge MLP are rounded from f32 sums taken in another
# order: a sum that lands near a rounding boundary flips by one bf16 unit,
# 2^-8 of the value, so 2^-7 of the output's scale.
TOL_BF16 = 2.0 ** -7
# One conv_head step is held on the head's own output, head_scale * fc2(x),
# the coordinates minus the prior (4.8e-4 A on the bench checkpoint, far
# below the ~10 A coordinates; ~2e9 with random weights). Its error may be
# TOL_HEAD of that output's max: in f32 the 12 layers add ulp-level
# differences (~1e-6 relative); in bf16 a message rounding that flips by
# one bf16 unit (2^-8 relative) is averaged over a node's edges and the
# layers, well under 1e-2.
# The output is then added to the prior and rounded to f32, so 2 units in
# the last place of the largest coordinate come on top.
TOL_HEAD_F32 = 1e-4
TOL_HEAD_BF16 = 1e-2
COORD_ULPS = 2
# Training run, kernel path against per-layer path over TRAIN_STEPS
# steps in bf16 from the same state and batches. Both paths round at the
# same places and differ in the order of f32 sums, so now and then a bf16
# rounding flips. The mean losses are sums over 128 examples of outputs
# that carry such flips through 12 layers: they agree to about 1e-3; 2e-2
# would not hold a wrong gradient, which moves every parameter by up to
# lr per step, four times over. Adam divides each gradient by its own
# running magnitude, so where an element of the gradient is near zero a
# flip changes, even reverses, its update of about lr: single elements may
# differ by as much as they moved. So each leaf's movement is held as a
# whole, the L2 norm of the difference over the L2 norm of the movement:
# 1.4e-2 at most on an H100 (5.6e-3 while the forward kernel summed in the
# per-layer path's order), held to 5e-2. A wrong gradient of one leaf
# moves it in unrelated directions, a difference of about 1.4 of the norm;
# the edge MLP on the exact f32 path instead of the tensor cores, which
# rounds the gradient at one more place, already shows as 0.10.
TOL_TRAIN_LOSS = 2e-2
TOL_TRAIN_MOVE = 5e-2
# Coordinates over the 128-step rollout, both compute types: the kernels
# are deterministic and the two paths differed by at most 8e-7 A on an H100
# (f32 0, bf16 at 1 stream 0, at 4 streams 8e-7); 1e-5 A is ~10 units in
# the last place of a 10 A coordinate and 2 % of one step's displacement
# (4.8e-4 A), so a head output wrong by a few percent would exceed it.
TOL_ROLL = 1e-5


# set in the spawned ranks of phase 20 but rank 0, whose lines alone print
QUIET = {"on": False}


def log(msg: str) -> None:
    if not QUIET["on"]:
        print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def bench_cfg(cd: str):
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )

    return ModelConfig(compute_dtype=cd, graph_mode="sparse", max_edges=224,
                       predict_delta=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_ms(fn, reps: int = 20, iters: int = 5) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph and replayed ``iters`` times between CUDA events, so host
    overhead does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got - ref|, that over max(1, max |ref|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


# ---- phase 2 ------------------------------------------------------------

def check_conv_head(weights, cfg, clip, windows, edges, mask, inv_deg, x0,
                    kmat, tag: str) -> float:
    """conv_head against its plain version on one step's inputs, held on
    the head's own output. Returns the max abs error of the coordinates."""
    from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
        residual_prior,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    s, _, r, _ = windows.shape
    bufs = pr.alloc_buffers(cfg, s, r, windows.device)
    for dst, src in ((bufs.edges, edges), (bufs.mask, mask),
                     (bufs.inv_deg, inv_deg), (bufs.x0, x0),
                     (bufs.kmat, kmat)):
        dst.copy_(src)
    win_k, win_p = windows.clone(), windows.clone()
    coords_k = torch.empty(s, r, 3, device=windows.device)
    pr.conv_head(bufs, weights, cfg, clip, win_k, coords_k)
    coords_p = pr.conv_head_plain(x0, kmat, edges, mask, inv_deg, weights,
                                  cfg, clip, win_p)
    torch.cuda.synchronize()
    # the head's own output: coordinates minus the prior both paths add
    head_out = (coords_p - residual_prior(cfg, windows)).abs().max().item()
    ulp = torch.finfo(torch.float32).eps * coords_p.abs().max().item()
    tol = ((TOL_HEAD_F32 if cfg.compute_dtype == "float32" else TOL_HEAD_BF16)
           * head_out + COORD_ULPS * ulp)
    err = (coords_k - coords_p).abs().max().item()
    win_err = (win_k - win_p).abs().max().item()
    # a tolerance as large as the head's output could not see a wrong head
    require(tol < 0.1 * head_out, f"conv_head check too loose: tolerance "
            f"{tol} against a head output of {head_out} ({tag})")
    require(err <= tol, f"conv_head coords error {err} > {tol} ({tag})")
    require(torch.equal(win_k[:, :-1], win_p[:, :-1]) and win_err <= tol,
            f"conv_head window slide differs ({tag})")
    plan = pr.conv_head_plan(s, pr.wide_clusters(
        r, cfg.width, cfg.max_edges, kmat.dtype, windows.device))
    log(f"conv_head {tag} ({plan} plan: "
        f"{16 if plan == 'wide' else 8}-block clusters): coords max abs "
        f"err {err:.3e} A = {err / head_out:.2e} of the head output's max "
        f"{head_out:.3e} A (tolerance {tol:.3e} A)")
    return err


def exact_stats(stats: dict, tag: str, queued: bool = False) -> dict:
    """A server's ``stats`` but ``queue_wait_s``, the counts a run must
    repeat exactly, after requiring that time to be finite and at least 0
    (above 0 where ``queued``: requests waited for a stream)."""
    wait = stats["queue_wait_s"]
    require(math.isfinite(wait) and (wait > 0.0 if queued else wait >= 0.0),
            f"{tag}: queue_wait_s {wait}")
    return {k: v for k, v in stats.items() if k != "queue_wait_s"}


def rollout_launches(n: int, cfg, streams: int, r: int = 28) -> dict:
    """The rollout kernels' launch counts of n steps of ``cfg`` at
    ``streams`` streams of r residues: ``conv_head_wide`` counts the steps
    whose conv_head took the wide plan, by the wrapper's rule."""
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        compute_dtype,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    wide = pr.wide_clusters(r, cfg.width, cfg.max_edges, compute_dtype(cfg),
                            torch.device("cuda", torch.cuda.current_device()))
    return {"graph_encode": n, "edge_mlp": 3 * n, "conv_head": n,
            "conv_head_wide": n if pr.conv_head_plan(streams, wide) == "wide"
            else 0}


HUB_DEGREE = 60  # above the K rows a block stages and holds in registers (23 + 12)


def stress_graphs(windows, max_edges: int):
    """Edge lists (name, edges (S, 2, E) int32, mask (S, E)) that stress how
    the conv stack deals edges to blocks: (a) node 3 a hub with HUB_DEGREE
    incoming edges, more than a block stages in shared memory and more than
    it holds messages for at a time, node 5 with none, 150 real edges in
    random slots; (b) every slot taken, the contact list of a 12 A
    threshold cut at ``max_edges`` (the overflow the encoder would flag)."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
        contact_map,
        padded_edges_device,
    )

    s, _, r, _ = windows.shape
    dev = windows.device
    rng = np.random.default_rng(17)
    edges = np.zeros((s, 2, max_edges), np.int32)
    mask = np.zeros((s, max_edges), np.float32)
    for i in range(s):
        slots = rng.permutation(max_edges)[:150]
        src = rng.integers(0, r, 150)
        dst = rng.choice([j for j in range(r) if j not in (3, 5)], 150)
        dst[:HUB_DEGREE] = 3
        edges[i, 0, slots], edges[i, 1, slots], mask[i, slots] = src, dst, 1.0
    hub = (torch.as_tensor(edges, device=dev), torch.as_tensor(mask, device=dev))
    require(int((hub[0][0, 1][hub[1][0] > 0] == 3).sum()) == HUB_DEGREE
            and not bool((hub[0][:, 1][hub[1] > 0] == 5).any()),
            "the hub edge list is not what it says")
    full_edges, full_mask, count = padded_edges_device(
        contact_map(windows[:, -1], 12.0), max_edges, return_count=True)
    require(bool((count > max_edges).all()) and bool((full_mask == 1).all()),
            f"a 12 A threshold does not fill the {max_edges} slots: {count}")
    return [("hub of in-degree %d, a node with none" % HUB_DEGREE, *hub),
            ("every slot taken, overflow cut", full_edges.to(torch.int32),
             full_mask)]


def hold_graph_encode(windows, weights, max_edges: int, cd, tol: float,
                      tag: str) -> tuple:
    """graph_encode against its plain version on ``windows``: edges, mask,
    count, overflow, inv_deg and ef equal, x0 within ``tol`` of its scale.
    Returns (x0 max abs error, the plain outputs)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    cfg = weights["cfg"]
    s, _, r, _ = windows.shape
    bufs = pr.alloc_buffers(dataclasses.replace(cfg, max_edges=max_edges), s,
                            r, windows.device)
    pr.graph_encode(windows, weights, THRESHOLD, bufs)
    plain = pr.graph_encode_plain(windows, weights, THRESHOLD, max_edges, cd)
    edges, mask, count, over, inv_deg, ef, x0 = plain
    torch.cuda.synchronize()
    for name, got, ref in (("edges", bufs.edges, edges),
                           ("mask", bufs.mask, mask),
                           ("count", bufs.count.long(), count),
                           ("inv_deg", bufs.inv_deg, inv_deg),
                           ("ef", bufs.ef, ef)):
        require(torch.equal(got, ref), f"graph_encode {name} differs ({tag})")
    require(bool(bufs.overflow[0] > 0) == bool(over.any()),
            f"graph_encode overflow differs ({tag})")
    err, rel = rel_err(bufs.x0, x0)
    require(rel <= tol, f"graph_encode x0 error {err} ({tag})")
    return err, plain


def check_kernels(params, aa, windows, cd: str) -> dict:
    """Each kernel against its plain version on the same inputs. Returns
    the max abs errors by kernel name."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
        edge_features_from_edges,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        edge_mlp as em,
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        sparse_inv_degree,
    )

    cfg = bench_cfg(cd)
    dev = windows.device
    s, _, r, _ = windows.shape
    e = cfg.max_edges
    tag = f"{cd} S={s}"
    weights = pr.rollout_weights(params, cfg, aa, dev)
    bufs = pr.alloc_buffers(cfg, s, r, dev)
    x0_err, (edges, mask, count, _, inv_deg, ef, x0) = hold_graph_encode(
        windows, weights, e, bufs.ef.dtype, TOL_F32, tag)
    log(f"graph_encode {tag}: edges/mask/count/inv_deg/ef exact "
        f"(count {count.tolist()}), x0 max abs err {x0_err:.3e}")

    tol = TOL_F32 if cd == "float32" else TOL_BF16
    a = ef.reshape(s * e, 6)
    mlp_err = 0.0
    for i, layer in enumerate(weights["mlp"]):
        relu, rm = i < 2, (mask.reshape(-1) if i == 2 else None)
        got = em.edge_mlp(a, layer["w"], layer["b"], relu, rm)
        ref = em.edge_mlp_plain(a, layer["w"], layer["b"], relu, rm)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        require(bool(torch.isfinite(got).all()), f"edge_mlp layer {i} "
                f"not finite ({tag})")
        require(rel <= tol, f"edge_mlp layer {i} error {err} > "
                f"{tol} x scale ({tag})")
        log(f"edge_mlp layer {i} {tag}: max abs err {err:.3e} "
            f"({rel:.2e} of scale)")
        mlp_err = max(mlp_err, err)
        a = ref

    # the step's own entry: one call, three launches
    h1 = torch.empty(s * e, cfg.ker_width, dtype=ef.dtype, device=dev)
    h2, kmat = torch.empty_like(h1), torch.empty_like(a)
    em.edge_mlp_stack(ef.reshape(s * e, 6), weights["mlp"], mask.reshape(-1),
                      h1, h2, kmat)
    torch.cuda.synchronize()
    err, rel = rel_err(kmat, a)
    # two more layers of flipped roundings than a single layer carries
    require(rel <= 3 * tol, f"edge_mlp_stack error {err} ({tag})")
    log(f"edge_mlp_stack {tag}, M = {s * e} rows: max abs err {err:.3e} "
        f"({rel:.2e} of scale)")
    mlp_err = max(mlp_err, err)

    head_err = check_conv_head(weights, cfg, CLIP, windows, edges, mask,
                               inv_deg, x0, a, f"{tag} bench_ckpt")
    # On bench_ckpt.npz the last conv layer's ReLU gives zero at every node,
    # so the head's output is fc2's bias and no error in K or in the
    # messages can reach it. A seeded random model at the same shapes keeps
    # every layer alive; its activations grow about 6x per layer (to ~2e9
    # at the head), so it runs without the clip, held relative to the
    # head's output like the checkpoint.
    rnd = pr.rollout_weights(gkn_init(cfg, seed=0, device=dev), cfg, aa, dev)
    edges, mask, _, _, inv_deg, ef, x0 = pr.graph_encode_plain(
        windows, rnd, THRESHOLD, e, bufs.ef.dtype)
    a = ef.reshape(s * e, 6)
    for i, layer in enumerate(rnd["mlp"]):
        a = em.edge_mlp_plain(a, layer["w"], layer["b"], i < 2,
                              mask.reshape(-1) if i == 2 else None)
    check_conv_head(rnd, cfg, None, windows, edges, mask, inv_deg, x0, a,
                    f"{tag} random weights, no clip")
    for name, g_edges, g_mask in stress_graphs(windows, e):
        g_ef = edge_features_from_edges(windows[:, -1], g_edges).to(ef.dtype)
        g_a = g_ef.reshape(s * e, 6)
        for i, layer in enumerate(rnd["mlp"]):
            g_a = em.edge_mlp_plain(g_a, layer["w"], layer["b"], i < 2,
                                    g_mask.reshape(-1) if i == 2 else None)
        check_conv_head(rnd, cfg, None, windows, g_edges, g_mask,
                        sparse_inv_degree(g_edges, g_mask, r), x0, g_a,
                        f"{tag} random weights, {name}")
    return {"graph_encode": x0_err, "edge_mlp": mlp_err,
            "conv_head": head_err}


# ---- phase 3 ------------------------------------------------------------

def check_rollout(params, aa, window0, cd: str, main_path: bool, cfg=None,
                  steps: int = STEPS, borderline_flips: bool = False) -> dict:
    """Kernel rollout vs plain rollout over ``steps`` steps (the bench
    configuration unless ``cfg`` is given): no overflow, the same edge list
    at every step, coordinates within TOL_ROLL. With ``borderline_flips``
    the edge lists of at most ``MAX_FLIP_STEPS`` steps may differ, at pairs
    whose distance in the plain rollout lies within 2 sqrt(3) TOL_ROLL of
    the threshold: a coordinate difference that the tolerance allows moves
    such a pair across it."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
        contact_map,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    cfg = cfg or bench_cfg(cd)
    batched = window0.dim() == 4
    tag = (f"{cd} {'S=%d' % window0.shape[0] if batched else 'single stream'}"
           f", R={window0.shape[-2]}, E={cfg.max_edges}")
    dev = window0.device
    run = pr.make_persistent_rollout_fn(cfg, steps, THRESHOLD, CLIP, device=dev)
    if main_path:
        pr.reset_launch_counts()
    coords, final, diags = run(params, aa, window0)
    torch.cuda.synchronize()
    counts = pr.launch_counts()
    ref, ref_final, ref_diags = make_rollout_fn(
        cfg, steps, THRESHOLD, clip=CLIP, batched=batched,
        device=dev)(params, aa, window0)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(coords).all()), f"non-finite coords ({tag})")
    require(not bool(diags["edge_overflow"].any()),
            f"edge overflow in the kernel rollout ({tag})")
    require(not bool(ref_diags["edge_overflow"].any()),
            f"edge overflow in the plain rollout ({tag})")
    step_axis = 1 if batched else 0
    require(torch.equal(final, torch.cat(
        [window0, coords], dim=step_axis).narrow(
            step_axis, steps, cfg.window_size)), f"final window ({tag})")
    # the graph of step k is built from the frame predicted at step k - 1
    frames_k = torch.cat([window0.narrow(step_axis, -1, 1), coords],
                         dim=step_axis)
    frames_p = torch.cat([window0.narrow(step_axis, -1, 1), ref],
                         dim=step_axis)
    maps_k = contact_map(frames_k, THRESHOLD)
    flip = maps_k != contact_map(frames_p, THRESHOLD)
    differing = int(flip.flatten(step_axis + 1).any(-1).sum())
    margin = None
    if differing and borderline_flips:
        dist = (frames_p[..., :, None, :] - frames_p[..., None, :, :]).norm(
            dim=-1)
        margin = (dist[flip] - THRESHOLD).abs().max().item()
    # steps whose graph is not the previous step's
    changed = int((maps_k.narrow(step_axis, 1, steps) != maps_k.narrow(
        step_axis, 0, steps)).flatten(step_axis + 1).any(-1).sum())
    err = (coords - ref).abs().max().item()
    drift = (coords.narrow(step_axis, -1, 1)
             - window0.narrow(step_axis, -1, 1)).abs().max().item()
    step_move = frames_p.diff(dim=step_axis).abs().amax(-1).amax(-1)
    log(f"rollout {tag}: {steps} steps, coords max abs err {err:.3e} A "
        f"(trajectory moved {drift:.3f} A; one step moves a coordinate by "
        f"up to {step_move.mean().item():.3e} A on average, "
        f"{step_move.max().item():.3e} at most), steps whose edge list differs: {differing}; "
        f"the rebuilt graph changed at {changed} of {steps} steps"
        + ("" if batched else f", edge count {int(maps_k[0].sum())} at the "
           f"start, {int(maps_k.sum((-1, -2)).max())} at most"))
    if margin is not None:
        log(f"rollout {tag}: at the {differing} steps whose edge lists "
            f"differ, every differing pair lies within {margin:.3e} A of "
            f"the threshold in the plain rollout")
        require(differing <= MAX_FLIP_STEPS
                and margin <= 2 * 3 ** 0.5 * TOL_ROLL, f"edge lists differ "
                f"at {differing} steps (at most {MAX_FLIP_STEPS} may) by "
                f"pairs up to {margin} A from the threshold ({tag})")
    else:
        require(differing == 0,
                f"edge lists differ at {differing} steps ({tag})")
    require(err <= TOL_ROLL, f"rollout error {err} > {TOL_ROLL} ({tag})")
    return counts


# ---- phase 4b: graph_encode and the kernel rollout past 28 residues --------

# graph_encode is held at these residue counts (12 edge slots a residue: no
# synthetic frame has that many contacts; R = 512 is the one-hot scatter's
# bound, the largest the model takes on the sparse path).
LARGE_R = (80, 512)
# The rollout at 80 residues: 1,024 edge slots (12.8 a residue; the
# synthetic protein's frames have 634 to 714 contacts, so nothing
# overflows), on the checkpoint, held to TOL_ROLL: STEPS steps in bf16
# with the same edge list at every step, and R80_STEPS steps in f32, long
# enough for the rebuilt graph to change again and again, where an edge
# list may differ only at a pair on the threshold (``borderline_flips``),
# and at no more than MAX_FLIP_STEPS of the steps (one step did on an
# H100, by a pair 4.8e-7 A from the threshold).
R80_EDGES = 1024
R80_STEPS = 512
MAX_FLIP_STEPS = 1
# the largest kernel rollout is probed with this many edge slots a residue
MAX_R_SLOTS = 16


def large_windows(r: int, streams: int, dev):
    """(windows (streams, 10, r, 3), aa) from synthetic_trajectory(seed=13)
    at r residues."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        synthetic_trajectory,
    )

    traj = synthetic_trajectory(num_frames=400, num_residues=r, seed=13)
    t_len = bench_cfg("bfloat16").window_size
    windows = torch.as_tensor(np.stack(
        [traj.positions[50 * i:50 * i + t_len] for i in range(streams)]),
        device=dev)
    return windows, torch.as_tensor(traj.aminoacids, device=dev)


def check_large_encoders(dev) -> None:
    """graph_encode at LARGE_R residues, dh off and on, f32 and bf16, 1 and
    8 streams, against its plain version; the bf16 times."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    for r in LARGE_R:
        windows8, aa = large_windows(r, 8, dev)
        e = 12 * r
        for dh in (False, True):
            for cd in ("float32", "bfloat16"):
                cfg = live_cfg(cd, electrostatics="dh" if dh else "none",
                               max_edges=e)
                weights = pr.rollout_weights(gkn_init(cfg, seed=0, device=dev),
                                             cfg, aa, dev)
                cd_t = torch.float32 if cd == "float32" else torch.bfloat16
                for s in (1, 8):
                    windows = windows8[:s].contiguous()
                    tag = f"R={r} E={e} dh={dh} {cd} S={s}"
                    err, plain = hold_graph_encode(
                        windows, weights, e, cd_t, TOL_X0_DH if dh else TOL_F32,
                        tag)
                    count = plain[2]
                    require(bool((count <= e).all()), f"overflow ({tag})")
                    msg = (f"graph_encode {tag}: edges/mask/count/inv_deg/ef "
                           f"exact (count {int(count.min())} to "
                           f"{int(count.max())}), x0 max abs err {err:.3e}")
                    if cd == "bfloat16":
                        bufs = pr.alloc_buffers(cfg, s, r, dev)
                        ms = device_ms(lambda: pr.graph_encode(
                            windows, weights, THRESHOLD, bufs))
                        plan = pr.graph_encode_plan(windows.shape[1], r,
                                                    cfg.embedding_dim,
                                                    cfg.width, dh)
                        msg += (f"; {ms * 1e3:.2f} us on the device "
                                f"({plan['threads']} threads, "
                                f"{plan['smem']} bytes of shared memory a "
                                f"block)")
                    log(msg)


def conv_head_fits(r: int, e: int) -> bool:
    """True if conv_head's plan at the flagship width in bf16 takes r
    residues and e edge slots and the card holds one of its clusters (a
    probe: the C call's refusal is its answer)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    n = ctypes.c_int(0)
    rc = pr._kernel("conv_head_clusters")(r, bench_cfg("bfloat16").width, e,
                                          1, 0, ctypes.byref(n))
    return rc == 0 and n.value >= 1


def check_large_rollouts(ckpt, dev) -> None:
    """The kernel rollout at 80 residues against the plain rollout, and the
    largest residue count a whole kernel rollout takes at the flagship
    width (MAX_R_SLOTS edge slots a residue), run for 16 steps."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    windows, aa = large_windows(80, 1, dev)
    cfg = dataclasses.replace(bench_cfg("bfloat16"), max_edges=R80_EDGES)
    check_rollout(ckpt, aa, windows[0], "bfloat16", False, cfg)
    check_rollout(ckpt, aa, windows[0], "float32", False,
                  dataclasses.replace(cfg, compute_dtype="float32"),
                  R80_STEPS, borderline_flips=True)
    parts = step_device_ms(pr.PreparedRollout(ckpt, cfg, aa, THRESHOLD, CLIP,
                                              dev), 1, windows)
    log(f"one rollout step at R=80, E={R80_EDGES}, bf16, on the device: "
        f"{parts['step'] * 1e3:.2f} us (graph_encode "
        f"{parts['graph_encode'] * 1e3:.2f}, edge_mlp x 3 "
        f"{parts['edge_mlp'] * 1e3:.2f}, conv_head "
        f"{parts['conv_head'] * 1e3:.2f})")

    r_max = 28
    while r_max < 1024 and conv_head_fits(r_max + 4,
                                          MAX_R_SLOTS * (r_max + 4)):
        r_max += 4
    require(r_max >= 80, "conv_head does not take 80 residues")
    windows, aa = large_windows(r_max, 1, dev)
    cfg = dataclasses.replace(bench_cfg("bfloat16"),
                              max_edges=MAX_R_SLOTS * r_max)
    log(f"the largest residue count (in steps of 4) whose whole kernel "
        f"rollout conv_head's plan takes at width 64 in bf16 with "
        f"{MAX_R_SLOTS} edge slots a residue: R = {r_max} (E = "
        f"{cfg.max_edges}); graph_encode takes up to R = 512 and beyond")
    check_rollout(ckpt, aa, windows[0], "bfloat16", False, cfg, 16)


# ---- phase 4 ------------------------------------------------------------

def steps_per_s(make, params, aa, window0, n1: int, n2: int) -> float:
    """Marginal rollout rate from two lengths (as bench.py), min of 3."""
    fns = {n: make(n) for n in (n1, n2)}

    def once(n):
        t0 = time.perf_counter()
        coords = fns[n](params, aa, window0)[0]
        float(coords.sum())
        return time.perf_counter() - t0

    for n in (n1, n2):
        once(n)
    t1 = min(once(n1) for _ in range(3))
    t2 = min(once(n2) for _ in range(3))
    return (n2 - n1) / max(t2 - t1, 1e-9)


def make_library_mlp(ef, mlp, row_mask):
    """The edge MLP as PyTorch's own calls, the yardstick and nothing the
    port uses: three ``torch.addmm`` with the two ReLUs and the row mask,
    bf16 biases, the same function as ``edge_mlp_stack``."""
    bias_cd = [layer["b"].to(ef.dtype) for layer in mlp]
    mask_cd = row_mask.to(ef.dtype)[:, None]

    def library_mlp():
        h1 = torch.relu_(torch.addmm(bias_cd[0], ef, mlp[0]["w"]))
        h2 = torch.relu_(torch.addmm(bias_cd[1], h1, mlp[1]["w"]))
        return torch.addmm(bias_cd[2], h2, mlp[2]["w"]).mul_(mask_cd)

    return library_mlp


def edge_mlp_layer_ms(ef, mlp, row_mask, bufs) -> list:
    """(kernel ms, ``torch.addmm`` ms) of each of the three layers alone,
    on the buffers of a step (h1 and h2 as the stack left them)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        edge_mlp as em,
    )

    bias_cd = [layer["b"].to(ef.dtype) for layer in mlp]
    ins = (ef, bufs.h1, bufs.h2)
    outs = (torch.empty_like(bufs.h1), torch.empty_like(bufs.h2),
            torch.empty_like(bufs.kmat))
    times = []
    for i, layer in enumerate(mlp):
        rm = row_mask if i == 2 else None
        ms = device_ms(lambda: em.edge_mlp(ins[i], layer["w"], layer["b"],
                                           i < 2, rm, out=outs[i]))
        lib = device_ms(lambda: torch.addmm(bias_cd[i], ins[i], layer["w"]))
        times.append((ms, lib))
    return times


def time_kernels(params, aa, window0, counts: dict, errs: dict) -> list:
    """The ``kernels`` records at the main path's shapes."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        edge_mlp as em,
        persistent_rollout as pr,
    )

    cfg = bench_cfg("bfloat16")
    cd = torch.bfloat16
    dev = window0.device
    windows = window0[None].contiguous()
    s, t, r, _ = windows.shape
    e, w, kw = cfg.max_edges, cfg.width, cfg.ker_width
    weights = pr.rollout_weights(params, cfg, aa, dev)
    bufs = pr.alloc_buffers(cfg, s, r, dev)
    pr.graph_encode(windows, weights, THRESHOLD, bufs)
    mlp = weights["mlp"]
    ef = bufs.ef.view(s * e, 6)

    row_mask = bufs.mask.view(-1)

    def kernel_mlp():
        return em.edge_mlp_stack(ef, mlp, row_mask, bufs.h1, bufs.h2,
                                 bufs.kmat)

    def plain_mlp():
        h1 = em.edge_mlp_plain(ef, mlp[0]["w"], mlp[0]["b"], True)
        h2 = em.edge_mlp_plain(h1, mlp[1]["w"], mlp[1]["b"], True)
        return em.edge_mlp_plain(h2, mlp[2]["w"], mlp[2]["b"], False, row_mask)

    library_mlp = make_library_mlp(ef, mlp, row_mask)
    kernel_mlp()
    layers = edge_mlp_layer_ms(ef, mlp, row_mask, bufs)
    log("edge_mlp at one stream, the three launches apart: "
        + ", ".join(f"layer {i} {ms * 1e3:.2f} us (torch.addmm alone "
                    f"{lib * 1e3:.2f} us)" for i, (ms, lib) in enumerate(layers)))
    clusters = pr.conv_head_clusters(r, w, e, cd)
    wide = pr.conv_head_clusters(r, w, e, cd, wide=True)
    log(f"conv_head: the card holds {clusters} of its 8-block clusters and "
        f"{wide} of its 16-block ones at once "
        f"(cudaOccupancyMaxActiveClusters): up to {wide} streams take the "
        f"wide plan, more the narrow one")
    win_k = windows.clone()
    coords = torch.empty(s, r, 3, device=dev)

    # Both slide win_k in place, so each call first restores the window:
    # the copy is part of the conv_head time in the ``kernels`` line, as it
    # always was. The kernel alone is timed beside it on a line of its own.
    def head_kernel():
        win_k.copy_(windows)
        pr.conv_head(bufs, weights, cfg, CLIP, win_k, coords)

    def head_plain():
        win_k.copy_(windows)
        pr.conv_head_plain(bufs.x0, bufs.kmat, bufs.edges, bufs.mask,
                           bufs.inv_deg, weights, cfg, CLIP, win_k)

    alone = device_ms(lambda: pr.conv_head(bufs, weights, cfg, CLIP, win_k,
                                           coords))
    log(f"conv_head at one stream without the copy that restores its window "
        f"(the window only feeds the prior): {alone * 1e3:.2f} us; with the "
        f"copy, as in the kernels line: {device_ms(head_kernel) * 1e3:.2f} us")

    def encode_plain():
        pr.graph_encode_plain(windows, weights, THRESHOLD, e, cd)

    # Least work for this run's data: inputs read once, outputs written
    # once, and per-edge work counted for the real edges only (the padded
    # slots carry no information).
    real = int(bufs.count.clamp(max=e).sum())
    cdb = torch.finfo(cd).bits // 8
    enc_w = [weights["emb_aa"], *weights["lstm"].values(),
             *weights["lstm_fc"].values(), *weights["fc1"].values()]
    ge_bytes = (nbytes(windows, *enc_w, bufs.inv_deg, bufs.x0, bufs.count)
                + real * (2 * 4 + 4 + 6 * cdb))
    ge_ops = s * (r * r * 8 + r * t * 12 * 13 + r * 7 * w * 2)
    widths = [(6, kw), (kw, kw), (kw, w * w)]
    # the function 6 -> kw -> kw -> w^2: edge features and row mask in,
    # weights and biases, K out; h1 and h2 need not leave the chip
    mlp_bytes = (sum(nbytes(layer["w"], layer["b"]) for layer in mlp)
                 + real * (6 * cdb + 4 + w * w * cdb))
    mlp_ops = 2 * real * sum(k * n for k, n in widths)
    ch_bytes = (nbytes(bufs.x0, bufs.inv_deg, *weights["conv1"].values(),
                       *weights["conv2"].values(), *weights["fc2"].values(),
                       windows, windows, coords)
                + real * (w * w * cdb + 2 * 4 + 4))
    ch_ops = (2 * cfg.depth * (2 * real * w * w + 2 * s * r * w * w)
              + s * r * 3 * 2 * w)

    def record(name, src, replaces, kernel_fn, plain_fn, lib_fn, nbyt, ops,
               peak):
        t_bytes, t_ops = nbyt / HBM_BYTES_PER_S, ops / peak
        rec = {
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/{src}",
            "replaces": f"{TPU_KERNEL}:{replaces}",
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": device_ms(kernel_fn),
            "plain_ms": device_ms(plain_fn),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": device_ms(lib_fn) if lib_fn else None,
        }
        log(f"{name}: {rec['ms'] * 1e3:.2f} us (plain "
            f"{rec['plain_ms'] * 1e3:.2f} us, bound "
            f"{rec['bound_ms'] * 1e3:.3f} us by {rec['bound_by']}"
            + (f", library {rec['library_ms'] * 1e3:.2f} us" if lib_fn
               else "") + ")")
        return rec

    step_ms = device_ms(lambda: pr.step(bufs, weights, cfg, THRESHOLD, CLIP,
                                        win_k, coords))
    log(f"one rollout step (5 launches) on the device: {step_ms * 1e3:.2f} us")
    one = torch.zeros(1, device=dev)
    log(f"the floor of a launch in this timer, one one-element PyTorch "
        f"kernel: {device_ms(lambda: one.add_(1.0)) * 1e3:.2f} us")
    return step_ms, [
        record("graph_encode", "graph_encode.cu", 164,
               lambda: pr.graph_encode(windows, weights, THRESHOLD, bufs),
               encode_plain, None, ge_bytes, ge_ops, PEAK_FLOPS[torch.float32]),
        record("edge_mlp", "edge_mlp.cu", 264, kernel_mlp, plain_mlp,
               library_mlp, mlp_bytes, mlp_ops, PEAK_FLOPS[cd]),
        record("conv_head", "conv_head.cu", 282, head_kernel, head_plain,
               None, ch_bytes, ch_ops, PEAK_FLOPS[cd]),
    ]


# ---- phases 5-7: the training path --------------------------------------

# Tolerances of the training conv stack, each relative to the largest
# magnitude of the tensor it is held on (with seeded gkn_init weights the
# activations grow about 6x per layer, so absolute errors say nothing).
# f32: the kernel sums an edge's 64 products, a node's messages and the
# 12 layers of dK in another order than the plain version: ulp-level
# differences (~1e-7) that 12 layers compound, far below 1e-4.
TOL_TC_F32 = 1e-4
# bf16: the same f32 sums land now and then on the other side of a bf16
# rounding boundary where x, a message, dz or dxs is rounded: one unit,
# 2^-8 of that value, averaged over a node's edges and carried through the
# layers; 1e-2 of the tensor's scale holds that and would not hold a wrong
# edge, layer or cast.
TOL_TC_BF16 = 1e-2


def train_cfg(cd: str, impl: str = "pallas", kernel_init_scale: float = 1.0):
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )

    return ModelConfig(compute_dtype=cd, graph_mode="sparse", max_edges=256,
                       predict_delta=True, train_conv_impl=impl,
                       kernel_init_scale=kernel_init_scale)


def training_cfgs(impl: str = "pallas"):
    """The training run's model and trainer. With the torch-default init
    the conv stack's activations grow about 6x per layer, and Adam's first
    steps at the default lr of 0.01 then overflow f32 at the second step,
    on every path (``probe_default_recipe`` logs it). The run therefore
    uses the configuration's own knobs for that: ``kernel_init_scale`` 0.1
    and lr 3e-5; every other field keeps its default."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        TrainConfig,
    )

    return (train_cfg("bfloat16", impl, kernel_init_scale=0.1),
            TrainConfig(batch_size=TRAIN_BATCH, lr=TRAIN_LR))


def train_conv_operands(params, cfg, batch):
    """The operands the training forward hands to ``train_conv``, made by
    the port's own modules from a device batch (exact f32 products)."""
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        compute_dtype,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
        _encode_nodes,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        sparse_inv_degree,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.mlp import mlp_apply
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        featurize_batch,
    )

    cd = compute_dtype(cfg)
    with torch.no_grad():
        gb = featurize_batch(cfg, batch)
        x0 = _encode_nodes(params, cfg, gb.aa, gb.window).contiguous()
        kt = mlp_apply(params["edge_kernel"], gb.graph.edge_feats,
                       compute_dtype=cd).to(cd)
        kt = (kt * gb.graph.mask[..., None].to(cd)).contiguous()
        inv_deg = sparse_inv_degree(gb.graph.edges, gb.graph.mask,
                                    gb.aa.shape[0]).contiguous()
    return (x0, kt, gb.graph.edges.to(torch.int32).contiguous(),
            gb.graph.mask.to(torch.float32).contiguous(), inv_deg,
            params["conv1"]["root"], params["conv1"]["bias"],
            params["conv2"]["root"], params["conv2"]["bias"])


def scaled_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def check_train_conv(params, batch, cd: str) -> dict:
    """Both training kernels against their plain versions on one batch.
    Returns the max abs errors of the output and of dx0."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )

    cfg = train_cfg(cd)
    tol = TOL_TC_F32 if cd == "float32" else TOL_TC_BF16
    ops = train_conv_operands(params, cfg, batch)
    x0, kt, edges, mask, inv_deg, root1, _, root2, _ = ops
    out, stack = tc.train_conv_forward(*ops, cfg.depth)
    out_p, stack_p = tc.train_conv_forward_plain(*ops, cfg.depth)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(stack).all()),
            f"train_conv_fwd stack not finite ({cd})")
    require(torch.equal(out, stack[:, -1]),
            f"train_conv_fwd out is not the last layer of its stack ({cd})")
    require(torch.equal(stack[:, 0], x0),
            f"train_conv_fwd stack does not start at x0 ({cd})")
    worst = 0.0
    for layer in range(1, stack.shape[1]):
        err, rel = scaled_err(stack[:, layer], stack_p[:, layer])
        worst = max(worst, rel)
        require(rel <= tol, f"train_conv_fwd layer {layer}: error {err} is "
                f"{rel:.2e} of the layer's max, over {tol} ({cd})")
    out_err, out_rel = scaled_err(out, out_p)
    log(f"train_conv_fwd {cd} B={x0.shape[0]} E={kt.shape[1]}: out max abs "
        f"err {out_err:.3e} = {out_rel:.2e} of its max "
        f"{out_p.abs().max().item():.3e}; worst layer of the stack "
        f"{worst:.2e} (tolerance {tol})")

    # the backward on the plain version's stack, so that both take the
    # relu mask from the same activations
    gen = torch.Generator(device=x0.device).manual_seed(5)
    g_out = torch.randn(out.shape, generator=gen, device=x0.device)
    bwd_args = (g_out, stack_p, kt, edges, mask, inv_deg, root1, root2,
                cfg.depth)
    got = tc.train_conv_backward(*bwd_args)
    ref = tc.train_conv_backward_plain(*bwd_args)
    torch.cuda.synchronize()
    names = ("dx0", "dkt", "droot1", "dbias1", "droot2", "dbias2")
    report = []
    errs = {}
    for name, g, r in zip(names, got, ref):
        require(g.shape == r.shape and g.dtype == r.dtype,
                f"train_conv_bwd {name}: {g.shape} {g.dtype} against "
                f"{r.shape} {r.dtype} ({cd})")
        require(bool(torch.isfinite(g).all()),
                f"train_conv_bwd {name} not finite ({cd})")
        err, rel = scaled_err(g, r)
        errs[name] = err
        report.append(f"{name} {rel:.2e}")
        require(rel <= tol, f"train_conv_bwd {name}: error {err} is "
                f"{rel:.2e} of its max, over {tol} ({cd})")
    # the padded slots' dK rows are xs (x) dm of node 0, not zero
    pad = batch["mask"] == 0
    if bool(pad.any()):
        e_pad, r_pad = scaled_err(got[1][pad], ref[1][pad])
        require(r_pad <= tol, f"train_conv_bwd dkt of padded slots: "
                f"{r_pad:.2e} ({cd})")
        report.append(f"dkt[padded] {r_pad:.2e} (max "
                      f"{ref[1][pad].float().abs().max().item():.2e})")
    log(f"train_conv_bwd {cd}: error over max, " + ", ".join(report)
        + f" (tolerance {tol})")
    return {"train_conv_fwd": out_err, "train_conv_bwd": errs["dx0"]}


# Widths past the tensor-core body's 64 in both compute types, up to the
# CUDA-core bodies' 128 columns in f32, and one that is not a multiple of 8
# (train_conv pads it to 64): train_conv under autograd, output and all six
# gradients, against the plain version's on the first WIDE_BATCH examples.
WIDE_CASES = ((72, "bfloat16"), (96, "float32"), (128, "float32"),
              (60, "float32"))
WIDE_BATCH = 32
GRAD_SLOTS = (0, 1, 5, 6, 7, 8)  # x0, kt, root1, bias1, root2, bias2


def check_train_conv_widths(batch) -> None:
    """The training kernels at any width (``WIDE_CASES``): one launch of
    each, the same output and gradients as the plain version."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )

    part = {k: v[:WIDE_BATCH] for k, v in batch.items()}
    for width, cd in WIDE_CASES:
        cfg = dataclasses.replace(train_cfg(cd), width=width)
        ops = train_conv_operands(gkn_init(cfg, seed=0, device="cuda"), cfg,
                                  part)
        gen = torch.Generator(device="cuda").manual_seed(7)
        g_out = torch.randn(ops[0].shape, generator=gen, device="cuda")
        res = []
        for fn in (tc.train_conv, tc.train_conv_plain):
            args = [t.detach().clone().requires_grad_(i in GRAD_SLOTS)
                    for i, t in enumerate(ops)]
            tc.reset_launch_counts()
            out = fn(*args, cfg.depth)
            (out * g_out).sum().backward()
            torch.cuda.synchronize()
            res.append(([out.detach()] + [args[i].grad for i in GRAD_SLOTS],
                        tc.launch_counts()))
        (got, n), (ref, n_plain) = res
        require(n == {"train_conv_fwd": 1, "train_conv_bwd": 1}
                and sum(n_plain.values()) == 0,
                f"train_conv at width {width} ({cd}) launched {n}, the plain "
                f"version {n_plain}")
        tol = TOL_TC_F32 if cd == "float32" else TOL_TC_BF16
        report = []
        for name, g, r in zip(("out", "dx0", "dkt", "droot1", "dbias1",
                               "droot2", "dbias2"), got, ref):
            require(g.shape == r.shape and bool(torch.isfinite(g).all()),
                    f"train_conv {name} at width {width} ({cd}): shape "
                    f"{tuple(g.shape)} against {tuple(r.shape)}, or not "
                    f"finite")
            _, rel = scaled_err(g, r)
            report.append(f"{name} {rel:.2e}")
            require(rel <= tol, f"train_conv {name} at width {width} ({cd}):"
                    f" {rel:.2e} of its max, over {tol}")
        plan = tc.train_conv_plan(ops[0].shape[1], -(-width // 8) * 8,
                                  ops[1].shape[1], cfg.depth, ops[1].dtype)
        log(f"train_conv at width {width} ({cd}, B={WIDE_BATCH}, plan "
            f"{plan}): error over max, " + ", ".join(report)
            + f" (tolerance {tol})")


def tree_items(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from tree_items(v, name)
        else:
            yield name, v


def run_train_steps(state0, step, tcfg, ds, indices, rollout_horizon=0):
    """One step per batch of ``indices`` through train_epoch from
    ``state0``: (state, metrics)."""
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_epoch,
    )

    state, metrics = train_epoch(state0, step, ds, indices, tcfg.batch_size,
                                 seed=tcfg.seed,
                                 rollout_horizon=rollout_horizon)
    torch.cuda.synchronize()
    return state, metrics


def compare_training_runs(state0, kernel, plain, tag: str):
    """The kernel path's (state, mean metrics) against the per-layer
    path's from the same ``state0``: mean losses within TOL_TRAIN_LOSS,
    and each leaf's movement within TOL_TRAIN_MOVE of its norm (the L2
    norm of the difference over the L2 norm of the per-layer path's
    movement). Returns (worst ratio, its leaf, the largest movement, the
    largest single difference)."""
    (state_k, m_k), (state_x, m_x) = kernel, plain
    for k in ("rel_l2", "mse"):
        rel = abs(m_k[k] - m_x[k]) / abs(m_x[k])
        require(rel <= TOL_TRAIN_LOSS, f"{tag}: mean {k} differs by "
                f"{rel:.2e} between the kernel and the per-layer path")
    worst, worst_name, moved, max_abs = 0.0, "", 0.0, 0.0
    for (name, a), (_, b), (_, c) in zip(tree_items(state_k.params),
                                         tree_items(state_x.params),
                                         tree_items(state0.params)):
        require(bool(torch.isfinite(a).all()), f"{tag}: {name} not finite")
        move = (b - c).norm().item()
        require(move > 0, f"{tag}: {name} did not move")
        rel = (a - b).norm().item() / move
        moved = max(moved, (a - c).abs().max().item())
        max_abs = max(max_abs, (a - b).abs().max().item())
        if rel > worst:
            worst, worst_name = rel, name
    require(worst <= TOL_TRAIN_MOVE, f"{tag}: the movement of {worst_name} "
            f"differs by {worst:.3e} of its norm")
    return worst, worst_name, moved, max_abs


def check_training(ds, train_idx, valid_idx) -> dict:
    """The training run on both paths; returns the main path's launch
    counts."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops import mlp
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_train_step,
    )

    (cfg_k, tcfg), (cfg_x, _) = training_cfgs(), training_cfgs("xla")
    indices = train_idx[:TRAIN_STEPS * TRAIN_BATCH]
    state0, tx, _ = create_train_state(
        tcfg.seed, cfg_k, tcfg, steps_per_epoch=TRAIN_STEPS)

    tc.reset_launch_counts()
    state_k, m_k = run_train_steps(state0, make_train_step(cfg_k, tx), tcfg,
                                   ds, indices)
    counts = tc.launch_counts()
    state_x, m_x = run_train_steps(state0, make_train_step(cfg_x, tx), tcfg,
                                   ds, indices)
    with mlp.exact_products():
        state_e, m_e = run_train_steps(state0, make_train_step(cfg_k, tx),
                                       tcfg, ds, indices)
    log(f"training run, {TRAIN_STEPS} steps at B={TRAIN_BATCH} bf16: "
        f"kernel path {m_k}; per-layer path {m_x}; kernel path with the "
        f"exact f32 edge MLP {m_e}; launches {counts}")
    for name, m in (("kernel", m_k), ("per-layer", m_x), ("exact", m_e)):
        require(all(np.isfinite(m[k]) for k in ("rel_l2", "mse")),
                f"non-finite training loss on the {name} path: {m}")
    require(state_k.step == TRAIN_STEPS, "the step count did not advance")
    worst, worst_name, moved, max_abs = compare_training_runs(
        state0, (state_k, m_k), (state_x, m_x), "training run")
    exact_gap = max(
        (a - b).norm().item() / (b - c).norm().item()
        for (_, a), (_, b), (_, c) in zip(tree_items(state_k.params),
                                          tree_items(state_e.params),
                                          tree_items(state0.params)))
    log(f"updated parameters, kernel against per-layer path: the movement "
        f"of a leaf differs by at most {worst:.3e} of its L2 norm (at "
        f"{worst_name}; tolerance {TOL_TRAIN_MOVE}); largest single "
        f"difference {max_abs:.3e} where parameters moved by up to "
        f"{moved:.3e}; tensor-core against exact edge MLP: {exact_gap:.3e} "
        f"of a leaf's movement, mean rel_l2 "
        f"{abs(m_k['rel_l2'] - m_e['rel_l2']) / abs(m_e['rel_l2']):.2e} "
        f"relative")

    held_out = to_device(ds.get_batch(valid_idx[:TRAIN_BATCH]), "cuda")
    ev = make_eval_step(cfg_k)(state_k.params, held_out)
    ev = {k: float(v) for k, v in ev.items()}
    log(f"eval step on a held-out batch: {ev}")
    require(ev["n"] == TRAIN_BATCH and np.isfinite(ev["rel_l2"])
            and np.isfinite(ev["mse"]), f"eval step: {ev}")
    return counts


def probe_default_recipe(batch) -> None:
    """Logs, and does not judge, the loss of three train steps with
    ``TrainConfig`` defaults (lr 0.01) from the torch-default init."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        TrainConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg = train_cfg("bfloat16")
    state, tx, _ = create_train_state(0, cfg, TrainConfig())
    step = make_train_step(cfg, tx)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["rel_l2"]))
    log(f"for the record, TrainConfig defaults (lr 0.01) from the "
        f"torch-default init, rel_l2 of three steps on one batch: {losses}")


def wall_ms(step, state, batch, n: int = 6) -> float:
    """Wall time in ms of one ``step(state, batch)``, the state carried
    from step to step, after a warm-up step; the device idle at the end."""
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profile_step(step, state, batch, wall: float, tag: str,
                 steps: int = 3) -> float:
    """Where one step's time goes, from ``torch.profiler`` over ``steps``
    steps after a warm-up: device time by kernel name, the device's busy
    share of ``wall`` (a step's wall time with the profiler off), and the
    device kernels a step launches. Returns the device busy ms a step. A
    step that replays a CUDA graph is profiled in its form issued op by
    op (``step.eager``: the same kernels), so that every kernel has its
    name."""
    from torch.profiler import ProfilerActivity, profile

    step = getattr(step, "eager", step)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0]
    require(bool(rows), "torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile of one {tag}: device busy {busy:.2f} ms of the "
        f"{wall:.2f} ms a step takes with the profiler off "
        f"({busy / wall:.2f}), in {sum(r[2] for r in rows):.0f} device "
        f"kernels and copies")
    for name, ms, n in rows[:12]:
        log(f"  {ms:7.3f} ms  x{n:5.1f}  {name[:90]}")
    return busy


def profile_train_step(batch, wall: float) -> float:
    """Phase 7: the profile of one teacher-forced train step on the kernel
    path; returns its device busy ms."""
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg, tcfg = training_cfgs()
    state, tx, _ = create_train_state(0, cfg, tcfg)
    return profile_step(make_train_step(cfg, tx), state, batch, wall,
                        "train step (kernel path)")


def time_training(params, ds, train_idx, counts: dict, errs: dict):
    """The ``kernels`` records of the two training kernels and the wall
    time in ms of a train step on the kernel path; logs the other paths'
    step times, samples/s and peak memory."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops import mlp
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )

    cfg = train_cfg("bfloat16")
    batch = to_device(ds.get_batch(train_idx[:TRAIN_BATCH]), "cuda")
    ops = train_conv_operands(params, cfg, batch)
    x0, kt, edges, mask, inv_deg, root1, bias1, root2, bias2 = ops
    out, stack = tc.train_conv_forward(*ops, cfg.depth)
    g_out = torch.randn_like(out)
    bwd_args = (g_out, stack, kt, edges, mask, inv_deg, root1, root2,
                cfg.depth)
    outs = tc.train_conv_backward(*bwd_args)

    # least work for this run's data: each input read once, each output
    # written once; of K only the real edges' rows (the padded rows are
    # zero), of dK every row, since the function returns them all
    b, e, w, r = x0.shape[0], kt.shape[1], cfg.width, x0.shape[1]
    real = int(batch["mask"].sum())
    resident = tc.train_conv_clusters(r, w, e, cfg.depth, kt.dtype)
    log("clusters the card holds at once (one an example) at B="
        f"{b}: " + ", ".join(
            f"{name} {n}, so {-(-b // n)} waves" for name, n in
            resident.items()))
    cdb = kt.element_size()
    small = nbytes(x0, edges, inv_deg, bias1, bias2) + 2 * w * w * cdb
    fwd_bytes = small + real * w * w * cdb + nbytes(out, stack)
    bwd_bytes = (nbytes(g_out, stack, edges, inv_deg) + 2 * w * w * cdb
                 + real * w * w * cdb + nbytes(*outs))
    layers = 2 * cfg.depth
    fwd_ops = layers * (2 * real * w * w + 2 * b * r * w * w)
    # dxs and dK per edge, droot and dz @ root^T per node
    bwd_ops = layers * (4 * real * w * w + 4 * b * r * w * w)
    peak = PEAK_FLOPS[torch.float32]  # each K element meets one operand

    def record(name, src, line, kernel_fn, plain_fn, nbyt, n_ops):
        t_bytes, t_ops = nbyt / HBM_BYTES_PER_S, n_ops / peak
        rec = {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
            "replaces": f"{TPU_TRAIN_KERNEL}:{line}",
            "launches": counts[name], "max_abs_err": errs[name],
            "ms": device_ms(kernel_fn, reps=5, iters=3),
            "plain_ms": device_ms(plain_fn, reps=1, iters=2),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        log(f"{name}: {rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f} ms, "
            f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}: "
            f"{nbyt / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP, {real} real "
            f"edges in {b * e} slots)")
        return rec

    kernels = [
        record("train_conv_fwd", "train_conv_fwd.cu", 214,
               lambda: tc.train_conv_forward(*ops, cfg.depth),
               lambda: tc.train_conv_forward_plain(*ops, cfg.depth),
               fwd_bytes, fwd_ops),
        record("train_conv_bwd", "train_conv_bwd.cu", 272,
               lambda: tc.train_conv_backward(*bwd_args),
               lambda: tc.train_conv_backward_plain(*bwd_args),
               bwd_bytes, bwd_ops),
    ]
    del outs, stack, out

    def step_ms(impl: str, n: int = 6) -> float:
        cfg_i, tcfg = training_cfgs(impl)
        state, tx, _ = create_train_state(0, cfg_i, tcfg)
        return wall_ms(make_train_step(cfg_i, tx), state, batch, n)

    torch.cuda.reset_peak_memory_stats()
    k_ms = step_ms("pallas")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    x_ms = step_ms("xla", n=3)
    with mlp.exact_products():
        e_ms = step_ms("pallas", n=3)
    both = kernels[0]["ms"] + kernels[1]["ms"]
    log(f"one train step at B={TRAIN_BATCH} bf16 (wall, device idle at the "
        f"end): kernel path {k_ms:.2f} ms = {TRAIN_BATCH / k_ms * 1e3:,.0f} "
        f"samples/s, of which the two kernels take {both:.2f} ms "
        f"({both / k_ms:.2f}); per-layer path {x_ms:.2f} ms; kernel path "
        f"with the exact f32 edge MLP {e_ms:.2f} ms; peak memory of the "
        f"kernel path {peak_gb:.2f} GB; one launch of each kernel per step")
    return kernels, k_ms


# ---- phases 11-12: the K-step curriculum ---------------------------------

CURRICULUM_K = 4
CURRICULUM_CLIP = 1000.0
# The f32 gradient check: one K = 4 step, full backpropagation, on the
# kernel path against the per-layer path at B = 32 with TF32 off. Both
# compute the same f32 function with sums in another order: about 1e-7
# relative per sum, which the four chained steps and their rebuilt edge
# features carry into every gradient leaf; 1e-4 of a leaf's norm holds
# that, and a wrong gradient of any one step (a kernel output missing, a
# saved tensor overwritten) moves a leaf by a good part of its norm.
GRAD_BATCH = 32
TOL_CURRICULUM_GRAD = 1e-4
RECIPE_STEPS = 8
RECIPE_WARMUP = 4


def curriculum_step(cfg, tx, grad_steps, **kw):
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        make_curriculum_train_step,
    )

    return make_curriculum_train_step(
        cfg, tx, rollout_steps=CURRICULUM_K, coord_clip=CURRICULUM_CLIP,
        loss_space="delta", grad_steps=grad_steps, **kw)


class RecordGraphs:
    """Within the block, every graph the curriculum rebuilds is kept:
    ``graphs`` holds (edges, mask) in the order built."""

    def __enter__(self):
        from molecular_dynamics_neural_operator_tpu_torch.train import (
            curriculum,
        )

        self.module, self.build = curriculum, curriculum._build_graph
        self.graphs = []

        def recording(cfg, frame, threshold):
            graph, overflow = self.build(cfg, frame, threshold)
            self.graphs.append((graph.edges.clone(), graph.mask.clone()))
            return graph, overflow

        curriculum._build_graph = recording
        return self

    def __exit__(self, *exc):
        self.module._build_graph = self.build


def check_curriculum_grads(ds, train_idx) -> None:
    """Phase 11a: one f32 K = 4 step with full backpropagation at
    B = GRAD_BATCH on the kernel path against the per-layer path: the
    same rebuilt edge lists at every step first, then the loss, the MSE
    and every gradient leaf within TOL_CURRICULUM_GRAD of its norm."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        curriculum_loss_batched,
        featurize_batch,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        value_and_grad,
    )

    batch = to_device(ds.get_batch(train_idx[:GRAD_BATCH],
                                   rollout_horizon=CURRICULUM_K), "cuda")
    res = {}
    for impl in ("pallas", "xla"):
        cfg = train_cfg("float32", impl, kernel_init_scale=0.1)
        params = gkn_init(cfg, seed=0, device="cuda")
        tc.reset_launch_counts()
        with RecordGraphs() as rec:
            (loss, (m, ov)), grads = value_and_grad(
                lambda p: curriculum_loss_batched(
                    p, cfg, featurize_batch(cfg, batch), batch["y_seq"],
                    coord_clip=CURRICULUM_CLIP, loss_space="delta",
                    return_overflow=True), params)
        torch.cuda.synchronize()
        res[impl] = (float(loss), float(m), bool(ov), rec.graphs,
                     dict(tree_items(grads)), tc.launch_counts())
    (l_k, m_k, ov_k, gr_k, g_k, n_k), (l_x, m_x, ov_x, gr_x, g_x, n_x) = (
        res["pallas"], res["xla"])
    require(n_k == {"train_conv_fwd": CURRICULUM_K,
                    "train_conv_bwd": CURRICULUM_K}
            and sum(n_x.values()) == 0,
            f"f32 K={CURRICULUM_K} step: launches {n_k} on the kernel path, "
            f"{n_x} on the per-layer path")
    require(len(gr_k) == len(gr_x) == CURRICULUM_K - 1,
            f"rebuilt {len(gr_k)} and {len(gr_x)} graphs")
    for t, ((e_k, mk_k), (e_x, mk_x)) in enumerate(zip(gr_k, gr_x)):
        require(torch.equal(e_k, e_x) and torch.equal(mk_k, mk_x),
                f"f32 K={CURRICULUM_K} step: the edge lists rebuilt at step "
                f"{t + 2} differ between the kernel and the per-layer path "
                f"({int((e_k != e_x).any(dim=1).sum())} slots)")
    require(not ov_k and not ov_x, "edge overflow in the f32 curriculum step")
    report, worst = [], (0.0, "")
    for name, gx in g_x.items():
        gk = g_k[name]
        norm = gx.norm().item()
        require(norm > 0 and bool(torch.isfinite(gk).all()),
                f"f32 K={CURRICULUM_K} gradient of {name}: norm {norm}, or "
                f"not finite on the kernel path")
        rel = (gk - gx).norm().item() / norm
        worst = max(worst, (rel, name))
        report.append(f"{name} {rel:.1e}")
    rel_l = abs(l_k - l_x) / abs(l_x)
    rel_m = abs(m_k - m_x) / abs(m_x)
    log(f"f32 K={CURRICULUM_K} curriculum step at B={GRAD_BATCH}, kernel "
        f"against per-layer path: the same edge lists at all "
        f"{len(gr_k)} rebuilds; loss {l_k:.6f} against {l_x:.6f} "
        f"({rel_l:.2e}), mse {rel_m:.2e}; gradient difference over norm: "
        + ", ".join(report) + f" (tolerance {TOL_CURRICULUM_GRAD}); "
        f"launches {n_k}")
    require(rel_l <= TOL_CURRICULUM_GRAD and rel_m <= TOL_CURRICULUM_GRAD,
            f"f32 K={CURRICULUM_K} loss differs by {rel_l:.2e}, mse by "
            f"{rel_m:.2e}")
    require(worst[0] <= TOL_CURRICULUM_GRAD,
            f"f32 K={CURRICULUM_K} gradient of {worst[1]} differs by "
            f"{worst[0]:.2e} of its norm")


def check_curriculum(ds, train_idx) -> dict:
    """Phase 11b: TRAIN_STEPS K = 4 curriculum steps in bf16 (delta loss,
    the clip) through train_epoch, with full backpropagation and with
    grad_steps=1, on the kernel path (the main path) and the per-layer
    path from the same state and batches, held as the teacher-forced run
    is held. Returns the kernel path's launch counts."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
    )

    (cfg_k, tcfg), (cfg_x, _) = training_cfgs(), training_cfgs("xla")
    indices = train_idx[:TRAIN_STEPS * TRAIN_BATCH]
    state0, tx, _ = create_train_state(
        tcfg.seed, cfg_k, tcfg, steps_per_epoch=TRAIN_STEPS)
    total = {"train_conv_fwd": 0, "train_conv_bwd": 0}
    for grad_steps, backward in ((None, CURRICULUM_K), (1, 1)):
        tag = (f"K={CURRICULUM_K} "
               + ("full BPTT" if grad_steps is None else "grad_steps=1"))
        tc.reset_launch_counts()
        kernel = run_train_steps(state0, curriculum_step(cfg_k, tx,
                                                         grad_steps),
                                 tcfg, ds, indices, CURRICULUM_K)
        counts = tc.launch_counts()
        plain = run_train_steps(state0, curriculum_step(cfg_x, tx,
                                                        grad_steps),
                                tcfg, ds, indices, CURRICULUM_K)
        for name, (state, m) in (("kernel", kernel), ("per-layer", plain)):
            require(all(np.isfinite(m[k]) for k in ("rel_l2", "mse"))
                    and state.step == TRAIN_STEPS,
                    f"{tag} on the {name} path: {m}, step {state.step}")
        want = {"train_conv_fwd": CURRICULUM_K * TRAIN_STEPS,
                "train_conv_bwd": backward * TRAIN_STEPS}
        require(counts == want, f"{tag}: launches {counts}, expected {want} "
                f"({CURRICULUM_K} forward and {backward} backward a step)")
        worst, worst_name, moved, max_abs = compare_training_runs(
            state0, kernel, plain, tag)
        log(f"curriculum run, {tag}, {TRAIN_STEPS} steps at B={TRAIN_BATCH} "
            f"bf16: kernel path {kernel[1]}; per-layer path {plain[1]}; "
            f"launches {counts}; a leaf's movement differs by at most "
            f"{worst:.3e} of its norm (at {worst_name}; tolerance "
            f"{TOL_TRAIN_MOVE}); largest single difference {max_abs:.3e} "
            f"where parameters moved by up to {moved:.3e}")
        for name in total:
            total[name] += counts[name]
    return total


def check_curriculum_recipe() -> dict:
    """Phase 11c: ``train_curriculum_recipe`` for RECIPE_STEPS steps, a
    teacher-forced warm-up of RECIPE_WARMUP then K = 4 with grad_steps=1,
    ``graph_frame="rebuild"``, gradient clip and non-finite skip, on a
    Langevin trajectory: finite logged losses, the switch to K after
    RECIPE_WARMUP steps, and the launches of each step changing with it.
    Returns the launch counts."""
    import contextlib
    import io

    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        langevin_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        recipe,
        train_curriculum_recipe,
        train_valid_split,
    )

    cfg, tcfg = training_cfgs()
    tcfg = dataclasses.replace(tcfg, grad_clip_norm=1.0,
                               skip_nonfinite_updates=True)
    traj = langevin_trajectory(num_frames=400, num_residues=28, seed=13)
    ds = WindowDataset(traj, window_size=cfg.window_size,
                       graph_mode="sparse", max_edges=cfg.max_edges)
    train_idx, _ = train_valid_split(len(ds))

    per_step, make = [], recipe.make_curriculum_train_step

    def counted(cfg_x, tx, rollout_steps, **kw):
        step = make(cfg_x, tx, rollout_steps=rollout_steps, **kw)

        def run(state, batch):
            before = tc.launch_counts()
            out = step(state, batch)
            after = tc.launch_counts()
            per_step.append((rollout_steps, tuple(after[n] - before[n]
                                                  for n in after)))
            return out
        return run

    recipe.make_curriculum_train_step = counted
    out = io.StringIO()
    tc.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(out):
            state, seconds, loss = train_curriculum_recipe(
                cfg, tcfg, ds, train_idx, steps=RECIPE_STEPS,
                k=CURRICULUM_K, min_warmup=RECIPE_WARMUP, log_every=2,
                graph_frame="rebuild", seed=tcfg.seed)
    finally:
        recipe.make_curriculum_train_step = make
    counts = tc.launch_counts()
    logged = [line for line in out.getvalue().splitlines() if "step " in line]
    for line in logged:
        log(f"recipe: {line}")
    losses = [float(line.split("loss ")[1].split()[0]) for line in logged]
    ks = [k for k, _ in per_step]
    log(f"recipe on langevin_trajectory(400, 28, seed=13): {RECIPE_STEPS} "
        f"steps in {seconds:.1f} s, final loss {loss}; K and (forward, "
        f"backward) launches of each step: {per_step}")
    require(len(losses) == RECIPE_STEPS // 2
            and all(np.isfinite(x) for x in losses) and np.isfinite(loss),
            f"recipe losses {losses}, final {loss}")
    want_k = [1] * RECIPE_WARMUP + [CURRICULUM_K] * (RECIPE_STEPS
                                                     - RECIPE_WARMUP)
    require(ks == want_k and state.step == RECIPE_STEPS,
            f"recipe ran K {ks}, expected {want_k}")
    want = ([(1, (1, 1))] * RECIPE_WARMUP
            + [(CURRICULUM_K, (CURRICULUM_K, 1))] * (RECIPE_STEPS
                                                      - RECIPE_WARMUP))
    require(per_step == want, f"recipe launches {per_step}, expected {want}")
    return counts


def time_curriculum(ds, train_idx, teacher_ms: float,
                    teacher_busy: float) -> None:
    """Phase 12: wall time, samples/s, device time and busy share of one
    K = 4 curriculum step on the kernel path, full BPTT and grad_steps=1,
    beside the teacher-forced step of this run; then the cost of the
    optimizer's finiteness guard (``skip_nonfinite_updates``) on the
    grad_steps=1 step, off and on in turns."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
    )

    cfg, tcfg = training_cfgs()
    batch = to_device(ds.get_batch(train_idx[:TRAIN_BATCH],
                                   rollout_horizon=CURRICULUM_K), "cuda")

    def fresh(grad_steps, skip=False):
        tcfg_i = dataclasses.replace(tcfg, skip_nonfinite_updates=skip)
        state, tx, _ = create_train_state(0, cfg, tcfg_i)
        return curriculum_step(cfg, tx, grad_steps), state

    log(f"teacher-forced step of this run: {teacher_ms:.2f} ms wall, "
        f"{teacher_busy:.2f} ms device, "
        f"{TRAIN_BATCH / teacher_ms * 1e3:,.0f} samples/s")
    for grad_steps in (None, 1):
        tag = (f"K={CURRICULUM_K} curriculum step ("
               + ("full BPTT" if grad_steps is None else "grad_steps=1")
               + ", kernel path)")
        torch.cuda.reset_peak_memory_stats()
        step, state = fresh(grad_steps)
        wall = wall_ms(step, state, batch)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        busy = profile_step(*fresh(grad_steps), batch, wall, tag)
        log(f"{tag} at B={TRAIN_BATCH} bf16: {wall:.2f} ms wall = "
            f"{TRAIN_BATCH / wall * 1e3:,.0f} samples/s, {busy:.2f} ms device "
            f"= {busy / teacher_busy:.2f} x the teacher-forced step's, busy "
            f"share {busy / wall:.2f}, peak memory {peak_gb:.2f} GB")
    times = {False: [], True: []}
    for skip in (False, True, True, False, False, True):
        times[skip].append(wall_ms(*fresh(1, skip), batch, n=20))
    off, on = np.median(times[False]), np.median(times[True])
    log(f"skip_nonfinite_updates on the grad_steps=1 step (an isfinite "
        f"reduction and selects on the card, no host read), 20 steps each, "
        f"in turns "
        f"off, on, on, off, off, on: off {times[False]} ms, on "
        f"{times[True]} ms; medians {off:.2f} and {on:.2f} ms, "
        f"{on - off:+.2f} ms a step")


# ---- phases 8-10: the serving path --------------------------------------

TPU_FUSED_KERNEL = "molecular_dynamics_neural_operator_tpu/ops/pallas/fused_gkn.py"
SEGMENT = 64
SATURATED_STEPS = 256   # eight such requests at once
MIXED_HORIZONS = (7, 64, 100, 300)
DH_STEPS = 128
# graph_encode with the Debye-Hückel branch: x0 = relu(fc1([emb; lstm; phi]))
# with phi a sum over 27 sources of l_B q exp(-kappa d) / d. The kernel's
# expf, sqrtf and division round in the last place unlike PyTorch's and the
# sum runs in another order: about 1e-6 of phi, which one fc1 row carries
# into x0. Held to 1e-5 of x0's scale, as the LSTM's transcendentals are.
# The contact test does not read phi, so the graph stays equal to the bit.
TOL_X0_DH = 1e-5
# A rollout on live weights, kernels against the plain version over n steps:
# each step's head output may differ by TOL_HEAD_* of its size (reasons
# above), and the differences add up along the trajectory, so n steps are
# held to TOL_HEAD_* x n x the largest displacement of one step.
# Seeded weights on which the bench rollout stays finite, inside the clip,
# without edge overflow and with every conv layer alive at every node:
LIVE = dict(kernel_init_scale=0.1, head_scale=0.05)


def live_cfg(cd: str, **kw):
    import dataclasses

    return dataclasses.replace(bench_cfg(cd), **LIVE, **kw)


def layers_alive(params, cfg, aa, window) -> bool:
    """True if after every conv layer every node has a positive feature."""
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        compute_dtype,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
        _encode_nodes,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        edge_conv_sparse,
        edge_kernel_matrices,
        sparse_inv_degree,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
        _build_graph,
    )

    cd = compute_dtype(cfg)
    graph, _ = _build_graph(cfg, window[-1], THRESHOLD)
    x = _encode_nodes(params, cfg, aa, window)
    k = edge_kernel_matrices(params["edge_kernel"], graph.edge_feats,
                             cfg.width, cd)
    inv = sparse_inv_degree(graph.edges, graph.mask, window.shape[-2])
    alive = True
    for layer in range(2 * cfg.depth):
        conv = params["conv1" if layer < cfg.depth else "conv2"]
        x = torch.relu(edge_conv_sparse(conv, x, k, graph.edges, graph.mask,
                                        inv, "onehot", cd))
        alive = alive and bool((x.amax(-1) > 0).all())
    return alive


def check_graph_encode_dh(params, aa, windows, cd: str) -> float:
    """graph_encode with dh against its plain version; returns the max
    abs error of x0."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    cfg = live_cfg(cd, electrostatics="dh")
    dev = windows.device
    s, _, r, _ = windows.shape
    tag = f"dh {cd} S={s}"
    weights = pr.rollout_weights(params, cfg, aa, dev)
    cd_t = torch.float32 if cd == "float32" else torch.bfloat16
    err, plain = hold_graph_encode(windows, weights, cfg.max_edges, cd_t,
                                   TOL_X0_DH, tag)
    x0 = plain[-1]
    rel = err / max(1.0, x0.abs().max().item())
    # the potential must matter: without charges x0 moves by far more
    no_q = dict(weights, charges=torch.zeros_like(weights["charges"]))
    moved = (pr.graph_encode_plain(windows, no_q, THRESHOLD, cfg.max_edges,
                                   cd_t)[-1] - x0).abs().max().item()
    require(moved > 1e3 * max(err, 1e-7), f"the potential moves x0 by only "
            f"{moved}: the check could not see a wrong phi ({tag})")
    log(f"graph_encode {tag}: edges/mask/count/inv_deg/ef exact, x0 max abs "
        f"err {err:.3e} ({rel:.2e} of scale, tolerance {TOL_X0_DH}); the "
        f"potential moves x0 by up to {moved:.3e}")
    return err


def fused_operands(params, cfg, aa, windows):
    """The operands the scan path hands to ``fused_edge_conv_stack``, made
    by the plain modules from ``windows`` (S, T, R, 3)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        fused_gkn as fg,
        persistent_rollout as pr,
    )

    dev = windows.device
    weights = pr.rollout_weights(params, cfg, aa, dev)
    cd = weights["mlp"][0]["w"].dtype
    edges, mask, count, _, inv_deg, ef, x0 = pr.graph_encode_plain(
        windows, weights, THRESHOLD, cfg.max_edges, cd)
    ops = (ef.contiguous(), mask.contiguous(),
           edges.to(torch.int32).contiguous(), inv_deg.contiguous(),
           x0.contiguous(), *fg.fused_weights(params, cfg), cfg.depth)
    return ops, int(count.clamp(max=cfg.max_edges).sum())


def check_fused(params, aa, windows, cd: str, what: str,
                graph=None) -> float:
    """fused_edge_conv_stack against its plain version; returns the max
    abs error. ``graph`` (name, edges, mask) replaces the contact graph."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
        edge_features_from_edges,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        fused_gkn as fg,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        sparse_inv_degree,
    )

    cfg = live_cfg(cd) if what == "live" else bench_cfg(cd)
    tag = f"{cd} S={windows.shape[0]} {what} weights"
    ops, _ = fused_operands(params, cfg, aa, windows)
    if graph is not None:
        name, edges, mask = graph
        tag += f", {name}"
        ef = edge_features_from_edges(windows[:, -1], edges).to(ops[0].dtype)
        ops = (ef.contiguous(), mask.contiguous(), edges.contiguous(),
               sparse_inv_degree(edges, mask, windows.shape[2]).contiguous(),
               *ops[4:])
    got = fg.fused_edge_conv_stack(*ops)
    ref = fg.fused_edge_conv_stack_plain(*ops)
    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == torch.float32,
            f"fused_edge_conv_stack gives {got.shape} {got.dtype} ({tag})")
    require(bool(torch.isfinite(got).all()),
            f"fused_edge_conv_stack not finite ({tag})")
    tol = TOL_TC_F32 if cd == "float32" else TOL_TC_BF16
    # relative to the larger of the output's and the input's scale: on the
    # checkpoint the last layer is dead and the output is all zero
    scale = max(ref.abs().max().item(), 1e-30)
    err = (got - ref).abs().max().item()
    alive = int((ref.amax(-1) > 0).sum())
    if what == "live" and graph is None:
        require(alive == ref.shape[0] * ref.shape[1],
                f"only {alive} nodes alive after the last layer ({tag})")
        require(err <= tol * scale, f"fused_edge_conv_stack error {err} is "
                f"{err / scale:.2e} of the output's max ({tag})")
    else:
        x0_scale = ops[4].abs().max().item()
        require(err <= tol * max(scale, x0_scale), f"fused_edge_conv_stack "
                f"error {err} ({tag})")
    log(f"fused_edge_conv_stack {tag}: max abs err {err:.3e} = "
        f"{err / scale:.2e} of the output's max {scale:.3e} (tolerance "
        f"{tol}); nodes alive after the last layer {alive}")
    return err


def same_edge_lists(w0, a, b) -> int:
    """Steps at which the graphs of two rollouts a, b (n, R, 3) from the
    window w0 (T, R, 3) differ."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
        contact_map,
    )

    fa = torch.cat([w0[-1:], a])
    fb = torch.cat([w0[-1:], b])
    same = (contact_map(fa, THRESHOLD)
            == contact_map(fb, THRESHOLD)).flatten(1).all(-1)
    return int((~same).sum())


def hold_result(res, w0, ref, tol: float, tag: str) -> float:
    """One served request against a reference rollout ``ref`` (n, R, 3)
    from w0: finite, inside the clip, no overflow, the final window is the
    last T frames, same edge lists, coordinates within ``tol``."""
    dev = ref.device
    coords = torch.as_tensor(res.coords, device=dev)
    n, t_len = coords.shape[0], w0.shape[0]
    require(coords.shape == ref.shape, f"{tag}: coords {coords.shape}")
    require(bool(torch.isfinite(coords).all()), f"{tag}: not finite")
    require(coords.abs().max().item() < CLIP, f"{tag}: the clip was reached")
    require(res.edge_overflow is False, f"{tag}: edge overflow")
    final = torch.cat([w0, coords])[n:n + t_len]
    require(torch.equal(torch.as_tensor(res.final_window, device=dev), final),
            f"{tag}: final window is not the last {t_len} frames")
    differing = same_edge_lists(w0, coords, ref)
    require(differing == 0, f"{tag}: edge lists differ at {differing} steps")
    err = (coords - ref).abs().max().item()
    require(err <= tol, f"{tag}: error {err} A > {tol}")
    return err


def step_device_ms(prepared, streams: int, windows) -> dict:
    """Device time in ms of one rollout step at ``streams`` streams
    (``step``), of its three parts, of the edge MLP's layers apart
    (``edge_mlp_layers``: kernel and bare ``torch.addmm``) and of the edge
    MLP as PyTorch's own calls at the same rows (``library_mlp``, the
    yardstick)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        edge_mlp as em,
        persistent_rollout as pr,
    )

    win = windows[:streams].clone().contiguous()
    s, _, r, _ = win.shape
    bufs = prepared.buffers(s, r)
    weights, cfg = prepared.weights, prepared.cfg
    coords = torch.empty(s, r, 3, device=win.device)
    e = cfg.max_edges
    ef, row_mask = bufs.ef.view(s * e, 6), bufs.mask.view(-1)
    pr.graph_encode(win, weights, THRESHOLD, bufs)
    return {
        "step": device_ms(lambda: pr.step(bufs, weights, cfg, THRESHOLD,
                                          CLIP, win, coords)),
        "graph_encode": device_ms(lambda: pr.graph_encode(
            win, weights, THRESHOLD, bufs)),
        "edge_mlp": device_ms(lambda: em.edge_mlp_stack(
            ef, weights["mlp"], row_mask, bufs.h1, bufs.h2, bufs.kmat)),
        "edge_mlp_layers": edge_mlp_layer_ms(ef, weights["mlp"], row_mask,
                                             bufs),
        "library_mlp": device_ms(make_library_mlp(ef, weights["mlp"],
                                                  row_mask)),
        "conv_head": device_ms(lambda: pr.conv_head(
            bufs, weights, cfg, CLIP, win, coords)),
    }


def serve_persistent(params, aa_np, traj) -> dict:
    """Phase 9a: the checkpoint on ``impl="persistent"``; returns the
    launch counts of the saturated run."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )

    cfg = bench_cfg("bfloat16")
    dev = torch.device("cuda")
    t_len = cfg.window_size
    prepared = pr.PreparedRollout(params, cfg, aa_np, THRESHOLD, CLIP, dev)

    def dedicated(w0, n):
        return prepared(torch.as_tensor(w0, device=dev), n)[0]

    def serve(requests, staggered: bool):
        """A fresh server per trace, so that ``stats`` are the trace's own.
        The first server of a process also pays for the first pinned
        buffers and the streams' first use; the caller times the second."""
        with RolloutServer(params, cfg, segment_steps=SEGMENT, max_streams=8,
                           threshold=THRESHOLD, clip=CLIP, impl="persistent",
                           aa=aa_np) as srv:
            srv.warmup()
            pr.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if staggered:
                futs = srv.submit_many(requests[:5])
                time.sleep(0.01)
                for r in requests[5:9]:
                    futs.append(srv.submit(*r))
                time.sleep(0.02)
                futs += srv.submit_many(requests[9:])
            else:
                futs = srv.submit_many(requests)
            results = [f.result(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
            return results, wall, srv.stats, pr.launch_counts()

    def hold_all(requests, results, tag):
        worst, exact = 0.0, True
        for i, ((_, w0, n), res) in enumerate(zip(requests, results)):
            ref = dedicated(w0, n)
            err = hold_result(res, torch.as_tensor(w0, device=dev), ref,
                              TOL_ROLL, f"{tag} request {i} ({n} steps)")
            worst = max(worst, err)
            exact = exact and err == 0.0
        return worst, exact

    # saturated: eight 256-step requests at once
    starts = [500 * i for i in range(8)]
    n_sat = SATURATED_STEPS
    requests = [(aa_np, traj.positions[i:i + t_len], n_sat) for i in starts]
    _, cold_wall, _, _ = serve(requests, staggered=False)
    results, wall, stats, counts = serve(requests, staggered=False)
    want = {"segments_run": n_sat // SEGMENT, "steps_computed": 8 * n_sat,
            "steps_served": 8 * n_sat, "requests_completed": 8,
            "requests_admitted": 8, "occupancy": 1.0}
    require(exact_stats(stats, "saturated") == want,
            f"saturated stats {stats}, expected {want}")
    require(counts == rollout_launches(n_sat, cfg, 8),
            f"saturated run launched {counts}")
    worst, exact = hold_all(requests, results, "saturated")
    windows8 = torch.as_tensor(np.stack([r[1] for r in requests]), device=dev)
    parts8 = step_device_ms(prepared, 8, windows8)
    step8 = parts8["step"]
    rate = stats["steps_served"] / wall
    log(f"serve persistent, 8 x {n_sat} steps at once: {rate:,.0f} served "
        f"steps/s in all ({wall * 1e3:.1f} ms; the process's first server "
        f"took {cold_wall * 1e3:.1f} ms for the same trace), occupancy "
        f"{stats['occupancy']:.3f}, {stats['segments_run']} segments; one "
        f"8-stream step takes {step8 * 1e3:.2f} us on the device "
        f"(graph_encode {parts8['graph_encode'] * 1e3:.2f}, edge_mlp x 3 "
        f"{parts8['edge_mlp'] * 1e3:.2f} against "
        f"{parts8['library_mlp'] * 1e3:.2f} for three torch.addmm with the "
        f"ReLUs and the row mask at the same 1,792 rows; its layers apart "
        + ", ".join(f"{ms * 1e3:.2f} (torch.addmm alone {lib * 1e3:.2f})"
                    for ms, lib in parts8["edge_mlp_layers"])
        + f"; conv_head "
        f"{parts8['conv_head'] * 1e3:.2f} with "
        f"{pr.conv_head_clusters(28, cfg.width, cfg.max_edges, torch.bfloat16)}"
        f" clusters resident at once), so the "
        f"device was busy {n_sat * step8 / 1e3 / wall:.3f} of the time; every "
        f"result against a dedicated single-stream kernel rollout: max abs "
        f"err {worst:.3e} A ({'equal to the bit' if exact else 'not bitwise'}"
        f"), same edge lists; launches {counts}")

    # mixed: twelve requests on eight streams, staggered, four horizons
    horizons = list(MIXED_HORIZONS)
    mixed = [(aa_np, traj.positions[300 * i:300 * i + t_len],
              horizons[i % 4]) for i in range(12)]
    results, wall, stats, mcounts = serve(mixed, staggered=True)
    total = sum(r[2] for r in mixed)
    exact_stats(stats, "mixed", queued=True)
    require(stats["steps_served"] == total
            and stats["requests_completed"] == 12
            and stats["steps_computed"] >= total
            and stats["steps_computed"] % SEGMENT == 0
            and stats["segments_run"] >= -(-max(horizons) // SEGMENT)
            and mcounts["graph_encode"] == stats["segments_run"] * SEGMENT,
            f"mixed stats {stats}, launches {mcounts}")
    worst, exact = hold_all(mixed, results, "mixed")
    log(f"serve persistent, mixed trace of 12 requests ({total} steps, "
        f"horizons {horizons}): {total / wall:,.0f} served steps/s "
        f"({wall * 1e3:.1f} ms), stats {stats}; against dedicated rollouts "
        f"max abs err {worst:.3e} A "
        f"({'equal to the bit' if exact else 'not bitwise'})")
    return counts


def serve_dh(aa_np, traj) -> tuple[dict, float]:
    """Phase 9b: ``electrostatics="dh"`` on seeded live weights through
    ``impl="persistent"``; returns the launch counts and the largest
    error against the plain rollout."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )

    dev = torch.device("cuda")
    aa = torch.as_tensor(aa_np, device=dev)
    steps = DH_STEPS
    worst_plain = 0.0
    for cd in ("float32", "bfloat16"):
        cfg = live_cfg(cd, electrostatics="dh")
        params = gkn_init(cfg, seed=0, device=dev)
        require(params["fc1"]["w"].shape[0] == 8, "fc1 has no row for phi")
        t_len = cfg.window_size
        requests = [(aa_np, traj.positions[i:i + t_len], steps)
                    for i in (0, 1000, 2000, 3000)]
        with RolloutServer(params, cfg, segment_steps=SEGMENT, max_streams=4,
                           threshold=THRESHOLD, clip=CLIP, impl="persistent",
                           aa=aa_np) as srv:
            srv.warmup()
            pr.reset_launch_counts()
            results = [f.result(timeout=300)
                       for f in srv.submit_many(requests)]
            stats, counts = srv.stats, pr.launch_counts()
        segs = steps // SEGMENT
        require(exact_stats(stats, "dh") == {
            "segments_run": segs, "steps_computed": 4 * steps,
            "steps_served": 4 * steps, "requests_completed": 4,
            "requests_admitted": 4, "occupancy": 1.0}, f"dh stats {stats}")
        require(counts == rollout_launches(steps, cfg, 4),
                f"dh run launched {counts}")
        prepared = pr.PreparedRollout(params, cfg, aa_np, THRESHOLD, CLIP,
                                      dev)
        plain = make_rollout_fn(cfg, steps, THRESHOLD, clip=CLIP, device=dev)
        head_tol = TOL_HEAD_F32 if cd == "float32" else TOL_HEAD_BF16
        worst_k = moved = 0.0
        for i, ((_, w0, n), res) in enumerate(zip(requests, results)):
            w0 = torch.as_tensor(w0, device=dev)
            tag = f"dh {cd} request {i}"
            err_k = hold_result(res, w0, prepared(w0, n)[0], TOL_ROLL,
                                f"{tag} against the dedicated kernel rollout")
            ref, ref_final, diags = plain(params, aa, w0)
            require(not bool(diags["edge_overflow"]), f"{tag}: overflow in "
                    "the plain rollout")
            step_move = torch.cat([w0[-1:], ref]).diff(dim=0).abs().max().item()
            tol = head_tol * n * step_move
            err_p = hold_result(res, w0, ref, tol,
                                f"{tag} against the plain rollout")
            require(layers_alive(params, cfg, aa, w0)
                    and layers_alive(params, cfg, aa, ref_final),
                    f"{tag}: a conv layer is dead at some node")
            worst_k = max(worst_k, err_k)
            worst_plain = max(worst_plain, err_p)
            moved = max(moved, (ref[-1] - w0[-1]).abs().max().item())
        log(f"serve persistent with electrostatics='dh', {cd}, seeded "
            f"weights {LIVE}: 4 x {steps} steps, every conv layer alive at "
            f"every node at the first and the last window, trajectories "
            f"moved up to {moved:.3f} A ({step_move:.3e} A a step); max abs "
            f"err against the dedicated kernel rollout {worst_k:.3e} A, "
            f"against the plain rollout {worst_plain:.3e} A (tolerance "
            f"{tol:.3e} A), same edge lists; launches {counts}")
    return counts, worst_plain


def serve_scan_fused(aa_np, traj, **opts) -> tuple[int, float]:
    """Phase 9c: ``impl="scan"`` with ``conv_impl="pallas"`` and one
    sequence per request against ``conv_impl="xla"``, on the seeded live
    weights with the model options ``opts``; returns the fused kernel's
    launch count and the largest error."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )

    dev = torch.device("cuda")
    steps = SEGMENT
    cfg_k = live_cfg("bfloat16", conv_impl="pallas", **opts)
    cfg_x = live_cfg("bfloat16", conv_impl="xla", **opts)
    params = gkn_init(cfg_k, seed=0, device=dev)
    t_len = cfg_k.window_size
    requests = [((aa_np + 3 * i) % 20, traj.positions[j:j + t_len], steps)
                for i, j in enumerate((0, 1000, 2000, 3000))]

    def serve(cfg):
        with RolloutServer(params, cfg, segment_steps=SEGMENT, max_streams=4,
                           threshold=THRESHOLD, clip=CLIP,
                           impl="scan") as srv:
            srv.warmup([4])
            start = fused_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = [f.result(timeout=600)
                       for f in srv.submit_many(requests)]
            wall = time.perf_counter() - t0
            return results, wall, srv.stats, fused_launches() - start

    got, wall_k, stats, launches = serve(cfg_k)
    ref, wall_x, stats_x, launches_x = serve(cfg_x)
    require(exact_stats(stats, "scan") == exact_stats(stats_x, "scan xla")
            and stats["segments_run"] == 1
            and stats["steps_computed"] == 4 * steps
            and stats["occupancy"] == 1.0, f"scan stats {stats} / {stats_x}")
    require(launches == stats["segments_run"] * SEGMENT and launches_x == 0,
            f"the fused kernel launched {launches} times (xla: {launches_x})")
    worst = 0.0
    for i, ((_, w0, n), res, res_x) in enumerate(zip(requests, got, ref)):
        w0 = torch.as_tensor(w0, device=dev)
        want = torch.as_tensor(res_x.coords, device=dev)
        step_move = torch.cat([w0[-1:], want]).diff(dim=0).abs().max().item()
        tol = TOL_HEAD_BF16 * n * step_move
        worst = max(worst, hold_result(
            res, w0, want, tol, f"scan request {i}, pallas against xla"))
    log(f"serve scan, 4 x {steps} steps, one sequence per request, bf16, "
        f"seeded weights {LIVE}, options {opts}: conv_impl='pallas' "
        f"{4 * steps / wall_k:,.0f} "
        f"served steps/s, 'xla' {4 * steps / wall_x:,.0f}; max abs err "
        f"between them {worst:.3e} A (tolerance {tol:.3e} A), same edge "
        f"lists; fused kernel launches {launches}")
    return launches, worst


def time_serve_kernels(aa, window0, dh_counts: dict, dh_err: float,
                       fused_launches: int, fused_err: float) -> list:
    """The ``kernels`` records of the two kernels this path adds, at one
    stream in bf16."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        fused_gkn as fg,
        persistent_rollout as pr,
    )

    cd = torch.bfloat16
    dev = window0.device
    windows = window0[None].contiguous()
    s, t, r, _ = windows.shape

    def record(name, src, replaces, launches, err, kernel_fn, plain_fn, nbyt,
               ops, peak):
        t_bytes, t_ops = nbyt / HBM_BYTES_PER_S, ops / peak
        rec = {
            "name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": device_ms(kernel_fn), "plain_ms": device_ms(plain_fn),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        }
        log(f"{name}: {rec['ms'] * 1e3:.2f} us (plain "
            f"{rec['plain_ms'] * 1e3:.2f} us, bound "
            f"{rec['bound_ms'] * 1e3:.3f} us by {rec['bound_by']}: "
            f"{nbyt / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP)")
        return rec

    # graph_encode with the dh branch
    cfg = live_cfg("bfloat16", electrostatics="dh")
    params = gkn_init(cfg, seed=0, device=dev)
    weights = pr.rollout_weights(params, cfg, aa, dev)
    bufs = pr.alloc_buffers(cfg, s, r, dev)
    pr.graph_encode(windows, weights, THRESHOLD, bufs)
    e, w, kw = cfg.max_edges, cfg.width, cfg.ker_width
    real = int(bufs.count.clamp(max=e).sum())
    cdb = 2
    enc_w = [weights["emb_aa"], weights["charges"],
             *weights["lstm"].values(), *weights["lstm_fc"].values(),
             *weights["fc1"].values()]
    ge_bytes = (nbytes(windows, *enc_w, bufs.inv_deg, bufs.x0, bufs.count)
                + real * (2 * 4 + 4 + 6 * cdb))
    # contact test 8 a pair, potential about 16 a pair, LSTM, fc1 (8 inputs)
    ge_ops = s * (r * r * (8 + 16) + r * t * 12 * 13 + r * 8 * w * 2)
    records = [record(
        "graph_encode_dh", "graph_encode.cu", f"{TPU_KERNEL}:248",
        dh_counts["graph_encode"], dh_err,
        lambda: pr.graph_encode(windows, weights, THRESHOLD, bufs),
        lambda: pr.graph_encode_plain(windows, weights, THRESHOLD, e, cd),
        ge_bytes, ge_ops, PEAK_FLOPS[torch.float32])]

    # fused_edge_conv_stack
    cfg = live_cfg("bfloat16", conv_impl="pallas")
    params = gkn_init(cfg, seed=0, device=dev)
    ops, real = fused_operands(params, cfg, aa, windows)
    ef, mask, edges, inv_deg, x0, *wts, depth = ops
    out = fg.fused_edge_conv_stack(*ops)
    # each input read once, the output written once; of the per-edge inputs
    # the real edges only; h1, h2 and K need not leave the chip
    f_bytes = (nbytes(*wts, inv_deg, x0, out)
               + real * (6 * cdb + 4 + 2 * 4))
    f_ops = (2 * real * (6 * kw + kw * kw + kw * w * w)
             + 2 * depth * (2 * real * w * w + 2 * s * r * w * w))
    records.append(record(
        "fused_edge_conv_stack", "fused_gkn.cu", f"{TPU_FUSED_KERNEL}:189",
        fused_launches, fused_err,
        lambda: fg.fused_edge_conv_stack(*ops),
        lambda: fg.fused_edge_conv_stack_plain(*ops), f_bytes, f_ops,
        PEAK_FLOPS[cd]))
    w1, b1, w2, b2, w3, b3 = wts[:6]
    a = ef.reshape(-1, 6)
    library_mlp = make_library_mlp(
        a, [{"w": w1, "b": b1}, {"w": w2, "b": b2}, {"w": w3, "b": b3}],
        mask.reshape(-1))

    log(f"fused_edge_conv_stack has no library call for the whole function; "
        f"its MLP alone as three torch.addmm with the ReLUs and the row mask: "
        f"{device_ms(library_mlp) * 1e3:.2f} us")
    windows8 = windows.expand(8, -1, -1, -1).contiguous()
    ops8, _ = fused_operands(params, cfg, aa, windows8)
    log(f"fused_edge_conv_stack at 8 streams: "
        f"{device_ms(lambda: fg.fused_edge_conv_stack(*ops8)) * 1e3:.2f} us")
    return records


def serve_phases(traj) -> list:
    """Phases 8-10, the serving path; returns the ``kernels`` records of
    the two kernels it adds."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    dev = torch.device("cuda")
    ckpt = load_params_npz(CKPT, device=dev)
    aa_np = np.asarray(traj.aminoacids)
    aa = torch.as_tensor(aa_np, device=dev)
    t_len = bench_cfg("bfloat16").window_size

    def windows(n):
        step = 4000 // n
        return torch.as_tensor(np.stack(
            [traj.positions[i * step:i * step + t_len] for i in range(n)]),
            device=dev)

    dh_err = fused_err = 0.0
    for cd in ("float32", "bfloat16"):
        dh_params = gkn_init(live_cfg(cd, electrostatics="dh"), seed=0,
                             device=dev)
        live = gkn_init(live_cfg(cd), seed=0, device=dev)
        for n in (1, 4):
            err = check_graph_encode_dh(dh_params, aa, windows(n), cd)
            if cd == "bfloat16" and n == 1:
                dh_err = err
        for n in (1, 8):
            err = check_fused(live, aa, windows(n), cd, "live")
            if cd == "bfloat16" and n == 1:
                fused_err = err
            check_fused(ckpt, aa, windows(n), cd, "bench_ckpt")
        for graph in stress_graphs(windows(2), bench_cfg(cd).max_edges):
            check_fused(live, aa, windows(2), cd, "live", graph)

    counts = serve_persistent(ckpt, aa_np, traj)
    for name, n in counts.items():
        # conv_head_wide counts a plan, not a kernel: segments of 8 streams
        # take the narrow one
        require(n > 0 or name == "conv_head_wide",
                f"kernel {name} was not launched on the serving path")
    dh_counts, _ = serve_dh(aa_np, traj)
    fused_launches, _ = serve_scan_fused(aa_np, traj)
    require(dh_counts["graph_encode"] > 0 and fused_launches > 0,
            "a kernel of the serving path was not launched")
    return time_serve_kernels(aa, windows(1)[0], dh_counts, dh_err,
                              fused_launches, fused_err)



# ---- phases 13-14: the training and rollout CLIs -------------------------

CLI_DATA = "memory:synthetic_trajectory(num_frames=4000,seed=13)"
# the flagship's training flags at full width; the in-memory trajectory
# stands in for --data_path (the card's machine has no h5py)
CLI_TRAIN = ["--data_path", CLI_DATA, "--graph_mode", "sparse",
             "--max_edges", "256", "--predict_delta",
             "--kernel_init_scale", "0.1", "--lr", str(TRAIN_LR),
             "--batch_size", str(TRAIN_BATCH), "--epochs", "1"]
CLI_K = 4
CLI_ROLL_STEPS = 128
CLI_TRAINED_STEPS = 16


def cli_train_run(traj, run_dir, extra, k: int = 0, base=CLI_TRAIN):
    """One ``train_from_trajectory`` call on the flags ``base + extra``
    with the launch counts set to 0 just before it and read just after;
    the new epoch's metrics row printed and checked: finite losses, and
    the launches the epoch implies (on the kernel path K forwards and K
    backwards a train step, K = 1 teacher-forced, and one forward per eval
    batch and per latent batch of 256 frames; none on the per-layer path
    or the dense graph). Returns (args, state, metrics row, launches)."""
    from molecular_dynamics_neural_operator_tpu_torch.cli import (
        train as cli_train,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )

    args = cli_train.parse_args(base + ["--run_path", str(run_dir)]
                                + extra)
    tr_idx, va_idx = train_valid_split(len(traj.positions) - 10)
    if k:
        tr_idx = tr_idx[tr_idx <= len(traj.positions) - 10 - k]
    steps = len(tr_idx) // TRAIN_BATCH
    model = cli_train.build_configs(args)[0]
    kernel = model.train_conv_impl == "pallas" and model.graph_mode == "sparse"
    evals = -(-len(va_idx) // TRAIN_BATCH) + -(-len(va_idx) // 256)
    want = {"train_conv_fwd": (steps * max(k, 1) + evals) * kernel,
            "train_conv_bwd": steps * max(k, 1) * kernel}
    tc.reset_launch_counts()
    state = cli_train.train_from_trajectory(args, traj)
    torch.cuda.synchronize()
    counts = tc.launch_counts()
    row = json.loads((run_dir / "metrics.jsonl").read_text()
                     .splitlines()[-1])
    tag = (f"cli.train {' '.join(extra) or '(teacher-forced)'}, "
           f"{model.graph_mode} graph")
    # the epoch beyond its steps at train_epoch's rate: eval, movie,
    # latents, checkpoints and metric reads, and the first step's warm-up
    loop_s = row["seconds"] - steps / row["steps_per_sec"]
    log(f"{tag}: epoch {row['epoch']}, train rel_l2 "
        f"{row['avg_train_loss']:.6g}, valid {row['avg_valid_loss']:.6g}; "
        f"{steps} steps at B={TRAIN_BATCH}: train_epoch "
        f"{row['examples_per_sec']:,.0f} samples/s, "
        f"{row['steps_per_sec']:.2f} steps/s; the whole epoch "
        f"{row['seconds']:.3f} s = "
        f"{steps * TRAIN_BATCH / row['seconds']:,.0f} samples/s, of which "
        f"{loop_s:.3f} s beyond the steps (the steps take as long at "
        f"{loop_s * row['steps_per_sec']:.0f} steps an epoch); launches "
        f"{counts}")
    require(all(np.isfinite(row[key]) for key in ("avg_train_loss",
                                                  "avg_valid_loss")),
            f"{tag}: non-finite loss {row}")
    require(counts == want, f"{tag}: launches {counts}, expected {want} "
            f"({steps} train steps of K={max(k, 1)}, {evals} eval and "
            "latent batches)")
    return args, state, row, counts


def check_cli_latents(args, traj, params) -> None:
    """The epoch loop's latent sweep (``collect_latents``, batches of 256
    and a remainder) on the final parameters, with the training kernels
    and on the per-layer path over the CLI's own validation range: each
    batch's latents within TOL_TC_BF16 of its scale, and one
    ``train_conv_fwd`` launch a batch on the kernel side."""
    import dataclasses

    from molecular_dynamics_neural_operator_tpu_torch.cli import (
        train as cli_train,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.latent import (
        collect_latents,
    )

    model, data, train = cli_train.build_configs(args)
    ds = WindowDataset(traj, window_size=model.window_size,
                       horizon=data.horizon, threshold=data.threshold,
                       graph_mode=model.graph_mode, max_edges=model.max_edges)
    _, va_idx = train_valid_split(len(ds), data.split_pct, data.split_method,
                                  seed=train.seed)
    n_lat = min(train.latent_frames, len(va_idx))
    lat = {}
    for impl in ("pallas", "xla"):
        before = tc.launch_counts()["train_conv_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat[impl] = collect_latents(
            params, dataclasses.replace(model, train_conv_impl=impl), ds,
            int(va_idx[0]), n_lat)
        lat[impl + "_s"] = time.perf_counter() - t0
        lat[impl + "_launches"] = tc.launch_counts()["train_conv_fwd"] - before
    batches = -(-n_lat // 256)
    require(lat["pallas_launches"] == batches and lat["xla_launches"] == 0,
            f"latent sweep: {lat['pallas_launches']} kernel and "
            f"{lat['xla_launches']} per-layer launches for {batches} batches")
    report = []
    for lo in range(0, n_lat, 256):
        got = torch.as_tensor(lat["pallas"][lo:lo + 256])
        ref = torch.as_tensor(lat["xla"][lo:lo + 256])
        err, rel = scaled_err(got, ref)
        report.append(f"B={len(ref)} {rel:.2e}")
        require(bool(np.isfinite(lat["pallas"][lo:lo + 256]).all())
                and rel <= TOL_TC_BF16, f"latent sweep batch at {lo} "
                f"(B={len(ref)}): error {err} is {rel:.2e} of its max, over "
                f"{TOL_TC_BF16}")
    log(f"cli.train latent sweep of {n_lat} validation windows on the final "
        f"parameters, kernels against the per-layer path, error over max by "
        f"batch: {', '.join(report)} (tolerance {TOL_TC_BF16}); wall "
        f"{lat['pallas_s']:.3f} s on the kernels, {lat['xla_s']:.3f} s "
        f"per-layer")


def cli_train_phase(traj, root) -> dict:
    """Phase 13: ``cli.train``'s ``train_from_trajectory`` on the card at
    the flagship's width: a teacher-forced epoch, a K = 4 curriculum epoch
    (delta loss), an epoch resumed from the first run's last.npz, and the
    first epoch again on the per-layer path. Returns the launches."""
    from molecular_dynamics_neural_operator_tpu_torch import configs
    from molecular_dynamics_neural_operator_tpu_torch.cli import (
        train as cli_train,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        restore_subtree,
    )

    total = {}

    def add(c):
        for name, v in c.items():
            total[name] = total.get(name, 0) + v

    teacher = root / "teacher"
    args, state, row, c = cli_train_run(traj, teacher, [])
    add(c)
    model, data, train = cli_train.build_configs(args)
    require(model.train_conv_impl == "pallas",
            f"--train_conv_impl auto chose {model.train_conv_impl} on the card")
    got = configs.experiment_from_json((teacher / "config.json").read_text())
    require(got == configs.ExperimentConfig(model=model, data=data,
                                            train=train),
            "config.json does not read back to the run's configs")
    for name in ("best.npz", "last.npz"):
        params, meta = restore_subtree(teacher / name,
                                       gkn_init(model, device="cuda"),
                                       ".params", device="cuda")
        for (leaf, a), (_, b) in zip(tree_items(params),
                                     tree_items(state.params)):
            require(torch.equal(a, b), f"{name}: {leaf} differs from the "
                    "run's final parameters")
        require(meta["epoch"] == 0, f"{name}: metadata {meta}")
    maps = list(teacher.glob("epoch0_*"))
    latents = np.load(teacher / "latent_space_epoch0.npy")
    require(bool(maps) and np.isfinite(latents).all(),
            f"movie {maps} or latents not written")
    log(f"cli.train wrote {sorted(p.name for p in teacher.iterdir())}; "
        f"latents {latents.shape}")
    first_step = state.step

    curriculum = root / "curriculum"
    _, cstate, crow, c = cli_train_run(
        traj, curriculum, ["--rollout_steps", str(CLI_K), "--loss_space",
                           "delta"], k=CLI_K)
    add(c)
    require(cstate.opt_state.chain.clip and
            cstate.opt_state.chain.skip_nonfinite,
            f"curriculum chain {cstate.opt_state.chain}")

    _, rstate, rrow, c = cli_train_run(
        traj, teacher, ["--resume", str(teacher / "last.npz"), "--epochs",
                        "2"])
    add(c)
    require(rrow["epoch"] == 1, f"resumed at epoch {rrow['epoch']}")
    check_cli_latents(args, traj, rstate.params)
    require(rstate.step == 2 * first_step
            and rstate.opt_state.count == 2 * first_step,
            f"resume: step {rstate.step}, Adam count "
            f"{rstate.opt_state.count}, from {first_step} in last.npz")

    _, _, xrow, _ = cli_train_run(traj, root / "xla",
                                  ["--train_conv_impl", "xla"])
    rel = abs(row["avg_train_loss"] - xrow["avg_train_loss"]) / abs(
        xrow["avg_train_loss"])
    log(f"cli.train epoch 0, kernel path against per-layer path: mean "
        f"rel_l2 {row['avg_train_loss']:.6g} and {xrow['avg_train_loss']:.6g}"
        f", {rel:.2e} relative (limit {TOL_TRAIN_LOSS}); samples/s "
        f"{row['examples_per_sec']:,.0f} and {xrow['examples_per_sec']:,.0f}")
    require(rel <= TOL_TRAIN_LOSS, f"cli.train: kernel and per-layer epoch "
            f"losses differ by {rel:.2e}")
    return total


def cli_roll_run(traj, out_dir, extra, dense: bool = False):
    """One ``rollout_from_trajectory`` call (``--graph_mode sparse``, or
    the CLI's default dense graph with ``dense``) with the rollout
    kernels' counts set to 0 just before it and read just after:
    (summary, coords, launches)."""
    from molecular_dynamics_neural_operator_tpu_torch.cli import (
        rollout as cli_rollout,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    graph = [] if dense else ["--graph_mode", "sparse"]
    args = cli_rollout.parse_args(
        ["--data_path", CLI_DATA, "--out_path", str(out_dir),
         "--predict_delta"] + graph + extra)
    pr.reset_launch_counts()
    summary = cli_rollout.rollout_from_trajectory(args, traj)
    torch.cuda.synchronize()
    counts = pr.launch_counts()
    coords = torch.as_tensor(np.load(out_dir / "forecast_coords.npy"),
                             device="cuda")
    require(summary["finite"], f"cli.rollout {extra}: not finite")
    return summary, coords, counts


def cli_rollout_phase(traj, root, trained) -> dict:
    """Phase 14: ``cli.rollout``'s ``rollout_from_trajectory`` on the card:
    the bench checkpoint for 128 steps on the kernels against the plain
    rollout, f32 and bf16, one stream and four; then 16 steps of phase
    13's best.npz. Returns the kernels' launches."""
    bench = ["--checkpoint", str(CKPT), "--max_edges", "224", "--clip",
             str(CLIP), "--num_steps", str(CLI_ROLL_STEPS)]
    total = {}
    t_len = bench_cfg("float32").window_size
    for cd, streams in (("float32", 1), ("bfloat16", 1), ("bfloat16", 4)):
        flags = bench + ["--compute_dtype", cd]
        if streams > 1:
            flags += ["--streams", str(streams), "--stream_stride", "1000"]
        tag = f"cli.rollout {cd}, {streams} stream(s)"
        ks, kc, counts = cli_roll_run(
            traj, root / f"k_{cd}_{streams}", flags + ["--impl", "persistent"])
        ps, pc, _ = cli_roll_run(traj, root / f"p_{cd}_{streams}",
                                 flags + ["--impl", "scan"])
        n = CLI_ROLL_STEPS
        want = rollout_launches(n, bench_cfg(cd), streams)
        require(counts == want, f"{tag}: launches {counts}, expected {want}")
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        kcs = kc.reshape(streams, n, *kc.shape[-2:])
        pcs = pc.reshape(streams, n, *pc.shape[-2:])
        for i in range(streams):
            w0 = torch.as_tensor(traj.positions[i * 1000:i * 1000 + t_len],
                                 device="cuda")
            differing = same_edge_lists(w0, kcs[i], pcs[i])
            require(differing == 0, f"{tag}: edge lists differ at "
                    f"{differing} steps in stream {i}")
        err = (kc - pc).abs().max().item()
        rate = "agg_steps_per_s" if streams > 1 else "steps_per_s"
        log(f"{tag}: kernels against the plain rollout over {n} steps, "
            f"coords max abs err {err:.3e} A (limit {TOL_ROLL}); {rate} "
            f"{ks[rate]:,.1f} on the kernels, {ps[rate]:,.1f} plain (one "
            f"call each, the first call's set-up included); launches "
            f"{counts}")
        require(err <= TOL_ROLL, f"{tag}: error {err} A > {TOL_ROLL}")
    out = root / "trained"
    ts, tcoords, counts = cli_roll_run(
        traj, out, ["--checkpoint", str(trained / "best.npz"),
                    "--max_edges", "256", "--num_steps",
                    str(CLI_TRAINED_STEPS), "--impl", "persistent"])
    files = sorted(p.name for p in out.iterdir())
    log(f"cli.rollout of phase 13's best.npz, {CLI_TRAINED_STEPS} steps on "
        f"the kernels: {ts}; wrote {files}; launches {counts}")
    require({"forecast_coords.npy", "per_step_mse.npy",
             "rollout_summary.json"} <= set(files)
            and tcoords.shape == (CLI_TRAINED_STEPS, 28, 3),
            f"trained rollout wrote {files}, coords {tuple(tcoords.shape)}")
    for name, v in counts.items():
        total[name] = total.get(name, 0) + v
    return total


def cli_phases(traj) -> dict:
    """Phases 13 and 14 in a temporary directory; returns every kernel's
    launches on the CLI path."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        root = Path(tmp)
        counts = cli_train_phase(traj, root / "train")
        counts.update(cli_rollout_phase(traj, root / "rollout",
                                        root / "train" / "teacher"))
    log(f"CLI path launches: {counts}")
    return counts


# ---- phases 15-16: the dense graph and the remaining GKN options ---------

# f32, the dense conv over all R sources against the sparse conv on the
# training kernels over the E edges of the same adjacency: the same
# products summed in another order, ulp-level (~1e-7) through 12 layers
# and the backward; 1e-4 of a tensor's scale, of the loss and of each
# gradient leaf's norm would not hold a wrong source, mask or degree.
TOL_DENSE = 1e-4
# f32, the dense scan rollout against the kernel rollout at E = 224 over
# 128 steps: 1e-4 A, ten times the kernel-against-plain limit, for the
# dense sums' other order carried through the steps.
TOL_DENSE_ROLL = 1e-4
# f32, a scatter mode against the one-hot products on the same graphs, and
# the card against the CPU: the same f32 sums in another order (atomic
# adds in "segment"), 1e-5 of the tensor's scale.
TOL_SCATTER = 1e-5
DENSE_SERVE_STEPS = SEGMENT
BLOCKED_EDGES = 448  # 16 slots a residue at R = 28
SEGMENT_R = 600  # past the one-hot scatter's 512 nodes
SEGMENT_SLOTS = 12
SEGMENT_BATCH = 4
LEGACY_BATCH = 4


def dense_cfg(cd: str, **kw):
    """The BBA preset (dense graph, 384 slots for sparse rebuilds) at the
    flagship widths with predict_delta."""
    from molecular_dynamics_neural_operator_tpu_torch.presets import BBA

    return dataclasses.replace(BBA, compute_dtype=cd, predict_delta=True,
                               **kw)


def leaf_gap(grads, ref) -> tuple[float, str]:
    """The largest ||g - r|| / ||r|| over the leaves, and its leaf."""
    ref = dict(tree_items(ref))
    worst = (0.0, "")
    for name, g in tree_items(grads):
        r = ref[name]
        require(bool(torch.isfinite(g).all()), f"gradient {name} not finite")
        worst = max(worst, ((g - r).norm().item()
                            / max(r.norm().item(), 1e-30), name))
    return worst


def check_dense_aggregate() -> None:
    """The bf16 dense aggregation on the card (``torch.bmm`` with f32
    output and its hand-written backward, ``ops/edge_conv.py``) against
    its plain form, f32 products of the bf16-rounded operands: the output
    within TOL_F32 of its scale, the gradients within TOL_BF16 (the card
    rounds dx and dK to bf16 where the cast of an operand does)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        edge_conv_dense,
        masked_dense_kernels,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    r, w, b = 28, 64, 8
    x = torch.randn(b, r, w, generator=gen, device="cuda")
    k = torch.randn(b, r, r, w, w, generator=gen, device="cuda") * 0.05
    adj = (torch.rand(b, r, r, generator=gen, device="cuda") < 0.3).float()
    inv = 1.0 / adj.sum(-2).clamp(min=1.0)
    conv = {"root": torch.randn(w, w, generator=gen, device="cuda") * 0.1,
            "bias": torch.zeros(w, device="cuda")}
    out, grads = {}, {}
    for name, dtype in (("card", torch.bfloat16), ("plain", torch.float32)):
        xs = x.clone().requires_grad_(True)
        ks = k.to(torch.bfloat16).float().requires_grad_(True)
        masked = masked_dense_kernels(ks, adj, dtype)
        y = edge_conv_dense(conv, xs, masked, inv, torch.bfloat16)
        (y * y.detach().cos()).sum().backward()
        out[name], grads[name] = y.detach(), (xs.grad, ks.grad)
    torch.cuda.synchronize()
    err, rel = scaled_err(out["card"], out["plain"])
    gx = scaled_err(grads["card"][0], grads["plain"][0])[1]
    gk = scaled_err(grads["card"][1], grads["plain"][1])[1]
    log(f"dense aggregation bf16, B={b}: the card's bmm against the plain "
        f"f32 products, out {rel:.2e} of its scale (tolerance {TOL_F32}), "
        f"dx {gx:.2e}, dK {gk:.2e} (tolerance {TOL_BF16:.2e})")
    require(rel <= TOL_F32 and gx <= TOL_BF16 and gk <= TOL_BF16,
            f"dense aggregation: out {rel:.2e}, dx {gx:.2e}, dK {gk:.2e}")


def check_dense_against_sparse(traj) -> None:
    """Dense check 1: one batch of B = 128 through the dense per-layer
    forward and through the sparse forward on the training kernels, built
    from the same stored adjacency (384 slots, no overflow): f32 outputs
    within TOL_DENSE of their scale, the loss and every gradient leaf
    within TOL_DENSE of its norm, no training-kernel launch on the dense
    side; bf16 reported."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        featurize_batch,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        loss_and_grads,
    )

    t_len = dense_cfg("float32").window_size
    idx = np.arange(TRAIN_BATCH) * 29
    bd = to_device(WindowDataset(traj, window_size=t_len, graph_mode="dense")
                   .get_batch(idx), "cuda")
    bs = to_device(WindowDataset(traj, window_size=t_len, graph_mode="sparse",
                                 max_edges=384).get_batch(idx), "cuda")
    require(torch.equal(bs["mask"].sum(-1), bd["adj"].sum((-1, -2))),
            "the sparse batch does not hold the dense batch's edges")
    for cd in ("float32", "bfloat16"):
        cfg_d = dense_cfg(cd, kernel_init_scale=0.1)
        cfg_s = dataclasses.replace(cfg_d, graph_mode="sparse",
                                    train_conv_impl="pallas")
        params = gkn_init(cfg_d, seed=0, device="cuda")
        tc.reset_launch_counts()
        (l_d, (_, out_d)), g_d = loss_and_grads(params, cfg_d,
                                                featurize_batch(cfg_d, bd))
        torch.cuda.synchronize()
        dense_counts = tc.launch_counts()
        (l_s, (_, out_s)), g_s = loss_and_grads(params, cfg_s,
                                                featurize_batch(cfg_s, bs))
        torch.cuda.synchronize()
        counts = {n: v - dense_counts[n]
                  for n, v in tc.launch_counts().items()}
        require(sum(dense_counts.values()) == 0
                and counts == {"train_conv_fwd": 1, "train_conv_bwd": 1},
                f"dense {cd}: training-kernel launches {dense_counts} on the "
                f"dense side, {counts} on the sparse side")
        err, rel = scaled_err(out_d, out_s)
        rel_l = abs(float(l_d) - float(l_s)) / abs(float(l_s))
        worst, leaf = leaf_gap(g_d, g_s)
        log(f"dense {cd} B={TRAIN_BATCH}: dense per-layer against sparse on "
            f"the training kernels, same adjacency: out max abs err "
            f"{err:.3e} = {rel:.2e} of its scale, loss {float(l_d):.6f} "
            f"against {float(l_s):.6f} ({rel_l:.2e}), worst gradient leaf "
            f"{leaf} {worst:.2e} of its norm"
            + (f" (tolerance {TOL_DENSE})" if cd == "float32"
               else " (reported)"))
        if cd == "float32":
            require(rel <= TOL_DENSE and rel_l <= TOL_DENSE
                    and worst <= TOL_DENSE,
                    f"dense f32 against sparse: out {rel:.2e}, loss "
                    f"{rel_l:.2e}, {leaf} {worst:.2e}")
            continue
        # the segment scatter sums the messages unrounded, as the dense
        # conv does: the bf16 gap to the kernels is their cast points
        cfg_g = dataclasses.replace(cfg_s, train_conv_impl="xla",
                                    scatter_mode="segment")
        (l_g, (_, out_g)), g_g = loss_and_grads(params, cfg_g,
                                                featurize_batch(cfg_g, bs))
        worst, leaf = leaf_gap(g_d, g_g)
        log(f"dense bf16 against the sparse per-layer segment scatter (the "
            f"same cast points): out {scaled_err(out_d, out_g)[1]:.2e} of "
            f"scale, loss {abs(float(l_d) - float(l_g)) / abs(float(l_g)):.2e}"
            f", worst gradient leaf {leaf} {worst:.2e} of its norm "
            f"(reported)")


def dense_cli_phase(traj, root) -> dict:
    """Dense checks 2-4: ``train_from_trajectory`` and
    ``rollout_from_trajectory`` with the CLIs' default graph flags.
    Returns the rollout kernels' launches."""
    base = ["--data_path", CLI_DATA, "--predict_delta", "--kernel_init_scale",
            "0.1", "--lr", str(TRAIN_LR), "--batch_size", str(TRAIN_BATCH),
            "--epochs", "1"]
    # the default flags train in bf16, where the dense conv sums unrounded
    # messages and the sparse one rounds each (the JAX package's cast
    # points) and Adam's first steps follow the gradients' signs; in f32
    # the two are the same sums. Both held to TOL_TRAIN_LOSS.
    for cd in ("bfloat16", "float32"):
        extra = [] if cd == "bfloat16" else ["--compute_dtype", cd]
        _, _, drow, dcounts = cli_train_run(traj, root / f"dense_{cd}",
                                            extra, base=base)
        _, _, srow, scounts = cli_train_run(
            traj, root / f"sparse_{cd}", extra + ["--graph_mode", "sparse"],
            base=base)
        rel = abs(drow["avg_train_loss"] - srow["avg_train_loss"]) / abs(
            srow["avg_train_loss"])
        log(f"cli.train {'default flags' if not extra else ' '.join(extra)} "
            f"(dense) against --graph_mode sparse: mean rel_l2 "
            f"{drow['avg_train_loss']:.6g} and {srow['avg_train_loss']:.6g}, "
            f"{rel:.2e} relative (limit {TOL_TRAIN_LOSS}); samples/s "
            f"{drow['examples_per_sec']:,.0f} dense, "
            f"{srow['examples_per_sec']:,.0f} sparse on the kernels; "
            f"training-kernel launches {dcounts} and {scounts}")
        require(sum(dcounts.values()) == 0,
                f"the dense epoch launched {dcounts}")
        require(rel <= TOL_TRAIN_LOSS, f"dense and sparse CLI epochs differ "
                f"by {rel:.2e} in {cd}")

    bench = ["--checkpoint", str(CKPT), "--max_edges", "224", "--clip",
             str(CLIP), "--num_steps", str(CLI_ROLL_STEPS)]
    t_len = dense_cfg("float32").window_size
    w0 = torch.as_tensor(traj.positions[:t_len], device="cuda")
    n = CLI_ROLL_STEPS
    total = {}
    for cd in ("float32", "bfloat16"):
        flags = bench + ["--compute_dtype", cd]
        ds_, dc, dn = cli_roll_run(traj, root / f"dense_{cd}", flags,
                                   dense=True)
        ks, kc, kn = cli_roll_run(traj, root / f"kernel_{cd}",
                                  flags + ["--impl", "persistent"],
                                  dense=True)
        want = rollout_launches(n, bench_cfg(cd), 1)
        # the dense scan's kernel tensor: the hand-written edge MLP in bf16
        want_d = {k: scan_launches(n, dense_cfg(cd)).get(k, 0) for k in dn}
        require(dn == want_d and kn == want,
                f"dense rollout {cd}: launches {dn} on the scan, {kn} under "
                f"--impl persistent, expected {want_d} and {want}")
        for name, v in kn.items():
            total[name] = total.get(name, 0) + v
        differing = same_edge_lists(w0, dc, kc)
        err = (dc - kc).abs().max().item()
        log(f"cli.rollout default flags {cd}: the dense scan against the "
            f"kernel rollout at E=224 over {n} steps, contact maps differ at "
            f"{differing} steps, coords max abs err {err:.3e} A"
            + (f" (limit {TOL_DENSE_ROLL})" if cd == "float32"
               else " (reported)")
            + f"; steps/s {ds_['steps_per_s']:,.1f} dense scan, "
            f"{ks['steps_per_s']:,.1f} kernels (one call each, set-up "
            f"included); launches {kn}")
        if cd == "float32":
            require(differing == 0 and err <= TOL_DENSE_ROLL,
                    f"dense rollout f32: maps differ at {differing} steps, "
                    f"error {err} A")
    return total


def check_dense_live_rollout(traj) -> None:
    """The dense scan rollout on the seeded live weights (every conv layer
    alive; the bench checkpoint's last one is dead) against the kernel
    rollout at E = 224, f32, 128 steps: the same contact maps at every
    step and coordinates within TOL_HEAD_F32 x steps x the largest
    displacement of one step, as the serving checks hold live rollouts."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    cfg = live_cfg("float32")
    params = gkn_init(cfg, seed=0, device="cuda")
    aa = torch.as_tensor(traj.aminoacids, device="cuda")
    w0 = torch.as_tensor(traj.positions[:cfg.window_size], device="cuda")
    require(layers_alive(params, cfg, aa, w0), "the live weights' conv "
            "stack has a dead layer")
    with torch.no_grad():
        dense = make_rollout_fn(dataclasses.replace(cfg, graph_mode="dense"),
                                STEPS, THRESHOLD, clip=CLIP)(
            params, aa, w0)[0]
        kern = pr.make_persistent_rollout_fn(cfg, STEPS, THRESHOLD, CLIP)(
            params, aa, w0)[0]
    torch.cuda.synchronize()
    step_move = torch.cat([w0[-1:], kern]).diff(dim=0).abs().max().item()
    tol = TOL_HEAD_F32 * STEPS * step_move
    differing = same_edge_lists(w0, dense, kern)
    err = (dense - kern).abs().max().item()
    log(f"dense scan rollout against the kernel rollout at E=224, f32, "
        f"{STEPS} steps, seeded weights {LIVE}: contact maps differ at "
        f"{differing} steps, coords max abs err {err:.3e} A (tolerance "
        f"{tol:.3e} A)")
    require(differing == 0 and err <= tol, f"dense live rollout: maps differ "
            f"at {differing} steps, error {err} A")


def serve_dense(traj) -> None:
    """Dense check 5: four requests through a dense ``RolloutServer(impl=
    "scan")`` (f32, the bench checkpoint, one segment), each within
    TOL_ROLL of a dedicated dense rollout."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    cfg = dense_cfg("float32")
    params = load_params_npz(CKPT, device="cuda")
    aa = np.asarray(traj.aminoacids, np.int32)
    t_len, n = cfg.window_size, DENSE_SERVE_STEPS
    starts = (0, 1000, 2000, 3000)
    requests = [(aa, traj.positions[j:j + t_len], n) for j in starts]
    with RolloutServer(params, cfg, segment_steps=SEGMENT, max_streams=4,
                       threshold=THRESHOLD, clip=CLIP, impl="scan") as srv:
        srv.warmup([4])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [f.result(timeout=600) for f in srv.submit_many(requests)]
        wall = time.perf_counter() - t0
    roll = make_rollout_fn(cfg, n, THRESHOLD, clip=CLIP)
    worst = 0.0
    aa_t = torch.as_tensor(aa, device="cuda")
    for j, res in zip(starts, results):
        w0 = torch.as_tensor(traj.positions[j:j + t_len], device="cuda")
        with torch.no_grad():
            ref = roll(params, aa_t, w0)[0]
        worst = max(worst, hold_result(res, w0, ref, TOL_ROLL,
                                       f"dense served request at {j}"))
    log(f"dense RolloutServer(impl='scan'), f32, 4 x {n} steps: each within "
        f"{worst:.3e} A of a dedicated dense rollout (limit {TOL_ROLL}), the "
        f"same contact maps; {4 * n / wall:,.0f} served steps/s")


def time_dense(traj) -> None:
    """Timing, no claim: the dense teacher step's wall and device time and
    busy share beside the sparse step on the training kernels and on the
    per-layer path (bf16, B = 128, the training cell's 256 slots); the
    dense and sparse plain scan rollouts' steps/s."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    cfg_k, tcfg = training_cfgs()
    t_len = cfg_k.window_size
    idx = np.arange(TRAIN_BATCH) * 29
    cells = (("dense (per-layer)", dense_cfg("bfloat16", kernel_init_scale=0.1),
              "dense", 384),
             ("sparse on the training kernels", cfg_k, "sparse", 256),
             ("sparse per-layer", training_cfgs("xla")[0], "sparse", 256))
    for tag, cfg, mode, e in cells:
        batch = to_device(WindowDataset(traj, window_size=t_len,
                                        graph_mode=mode, max_edges=e)
                          .get_batch(idx), "cuda")
        torch.cuda.reset_peak_memory_stats()
        state, tx, _ = create_train_state(0, cfg, tcfg)
        step = make_train_step(cfg, tx)
        wall = wall_ms(step, state, batch)
        peak = torch.cuda.max_memory_allocated() / 1e9
        state, tx, _ = create_train_state(0, cfg, tcfg)
        busy = profile_step(make_train_step(cfg, tx), state, batch, wall,
                            f"teacher step, {tag}")
        log(f"teacher step {tag}, B={TRAIN_BATCH} bf16: {wall:.2f} ms wall "
            f"= {TRAIN_BATCH / wall * 1e3:,.0f} samples/s, {busy:.2f} ms "
            f"device, busy share {busy / wall:.2f}, peak memory {peak:.2f} GB")
    params = load_params_npz(CKPT, device="cuda")
    aa = torch.as_tensor(traj.aminoacids, device="cuda")
    window0 = torch.as_tensor(traj.positions[:t_len], device="cuda")
    rates = {}
    for tag, cfg in (("dense", dense_cfg("bfloat16")),
                     ("sparse E=224", bench_cfg("bfloat16"))):
        with torch.no_grad():
            rates[tag] = steps_per_s(
                lambda n, c=cfg: make_rollout_fn(c, n, THRESHOLD, clip=CLIP),
                params, aa, window0, 16, 80)
    log(f"plain scan rollout, bf16, single stream, the bench checkpoint: "
        f"dense {rates['dense']:,.1f} steps/s, sparse E=224 "
        f"{rates['sparse E=224']:,.1f} steps/s (slope between 16 and 80 "
        f"steps, min of 3)")


def dense_phase(traj) -> dict:
    """Phase 15; returns the rollout kernels' launches."""
    import tempfile

    t0 = time.perf_counter()
    check_dense_aggregate()
    check_dense_against_sparse(traj)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dense_") as tmp:
        counts = dense_cli_phase(traj, Path(tmp))
    check_dense_live_rollout(traj)
    serve_dense(traj)
    time_dense(traj)
    log(f"dense path launches: {counts}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


def train_pair(cfg_k, cfg_x, ds, tag: str) -> dict:
    """TRAIN_STEPS train steps from one state on the training kernels
    (``cfg_k``) and on the per-layer path (``cfg_x``), held as phase 6
    holds them; returns the kernel run's launches (TRAIN_STEPS of each)."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
        train_valid_split,
    )

    _, tcfg = training_cfgs()
    train_idx, _ = train_valid_split(len(ds))
    indices = train_idx[:TRAIN_STEPS * TRAIN_BATCH]
    state0, tx, _ = create_train_state(tcfg.seed, cfg_k, tcfg,
                                       steps_per_epoch=TRAIN_STEPS)
    tc.reset_launch_counts()
    kernel = run_train_steps(state0, make_train_step(cfg_k, tx), tcfg, ds,
                             indices)
    counts = tc.launch_counts()
    plain = run_train_steps(state0, make_train_step(cfg_x, tx), tcfg, ds,
                            indices)
    want = {"train_conv_fwd": TRAIN_STEPS, "train_conv_bwd": TRAIN_STEPS}
    require(counts == want, f"{tag}: launches {counts}, expected {want}")
    worst, leaf, _, _ = compare_training_runs(state0, kernel, plain, tag)
    log(f"{tag}: {TRAIN_STEPS} steps at B={TRAIN_BATCH} bf16, kernels "
        f"{kernel[1]}, per-layer {plain[1]}; the movement of {leaf} differs "
        f"by {worst:.3e} of its norm (tolerance {TOL_TRAIN_MOVE}); launches "
        f"{counts}")
    return counts


def check_blocked(traj) -> dict:
    """Options check 2: the blocked layout at BLOCKED_EDGES slots. The
    per-layer "blocked" reduction against the one-hot products of the
    same graphs packed CSR (f32, TOL_SCATTER); the training kernels on the
    blocked batch against their plain versions; then train steps on the
    blocked dataset, kernels against the per-layer one-hot path."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import (
        gkn_apply,
        gkn_init,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        featurize_batch,
    )

    t_len = bench_cfg("float32").window_size
    kw = dict(window_size=t_len, graph_mode="sparse", max_edges=BLOCKED_EDGES)
    ds_b = WindowDataset(traj, edge_layout="blocked", **kw)
    ds_c = WindowDataset(traj, **kw)
    idx = np.arange(TRAIN_BATCH) * 29
    bb = to_device(ds_b.get_batch(idx), "cuda")
    bc = to_device(ds_c.get_batch(idx), "cuda")
    gaps = int((bb["mask"].diff(dim=-1) > 0).sum())
    cfg_b = dataclasses.replace(train_cfg("float32", "xla", 0.1),
                                max_edges=BLOCKED_EDGES,
                                scatter_mode="blocked")
    cfg_c = dataclasses.replace(cfg_b, scatter_mode="auto")
    params = gkn_init(cfg_b, seed=0, device="cuda")
    with torch.no_grad():
        out_b = gkn_apply(params, cfg_b, featurize_batch(cfg_b, bb))
        out_c = gkn_apply(params, cfg_c, featurize_batch(cfg_c, bc))
    torch.cuda.synchronize()
    err, rel = scaled_err(out_b, out_c)
    log(f"blocked layout, {BLOCKED_EDGES} slots ({gaps} padded runs between "
        f"real slots in the batch), f32 B={TRAIN_BATCH}: 'blocked' reduction "
        f"against the one-hot products of the same graphs packed CSR, "
        f"{rel:.2e} of scale (tolerance {TOL_SCATTER})")
    require(gaps > 0 and rel <= TOL_SCATTER,
            f"blocked against onehot: {rel:.2e} ({gaps} gaps)")
    for cd in ("float32", "bfloat16"):
        check_train_conv(params, bb, cd)
    # the kernels round each message in bf16 as the one-hot products do
    # (the "blocked" reduction sums them unrounded), so the per-layer side
    # of the training pair takes the one-hot products of the blocked batch
    cfg_k, _ = training_cfgs()
    cfg_k = dataclasses.replace(cfg_k, max_edges=BLOCKED_EDGES,
                                scatter_mode="blocked")
    return train_pair(cfg_k, dataclasses.replace(
        cfg_k, train_conv_impl="xla", scatter_mode="onehot"), ds_b,
        "blocked-layout training")


def check_segment() -> None:
    """Options check 3: SEGMENT_R residues, SEGMENT_SLOTS slots a residue,
    f32: the forward's "auto" rule (segment) and its loss gradient against
    a forced "onehot", each within TOL_SCATTER of scale."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        synthetic_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        featurize_batch,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        loss_and_grads,
    )

    e = SEGMENT_SLOTS * SEGMENT_R
    cfg = dataclasses.replace(train_cfg("float32", "xla", 0.1),
                              num_residues=SEGMENT_R, max_edges=e)
    traj = synthetic_trajectory(num_frames=60, num_residues=SEGMENT_R,
                                seed=13)
    ds = WindowDataset(traj, window_size=cfg.window_size, graph_mode="sparse",
                       max_edges=e)
    gb = featurize_batch(cfg, to_device(
        ds.get_batch(np.arange(SEGMENT_BATCH) * 10), "cuda"))
    params = gkn_init(cfg, seed=0, device="cuda")
    (l_s, (_, out_s)), g_s = loss_and_grads(params, cfg, gb)
    (l_o, (_, out_o)), g_o = loss_and_grads(
        params, dataclasses.replace(cfg, scatter_mode="onehot"), gb)
    torch.cuda.synchronize()
    _, rel = scaled_err(out_s, out_o)
    rel_l = abs(float(l_s) - float(l_o)) / abs(float(l_o))
    worst = max((scaled_err(g, dict(tree_items(g_o))[name])[1], name)
                for name, g in tree_items(g_s))
    log(f"segment scatter at R={SEGMENT_R}, E={e} ({int(gb.graph.mask.sum())} "
        f"real edges in B={SEGMENT_BATCH}), f32: against a forced onehot, "
        f"out {rel:.2e} of scale, loss {rel_l:.2e}, worst gradient leaf "
        f"{worst[1]} {worst[0]:.2e} of its scale (tolerance {TOL_SCATTER})")
    require(rel <= TOL_SCATTER and rel_l <= TOL_SCATTER
            and worst[0] <= TOL_SCATTER,
            f"segment against onehot: out {rel:.2e}, loss {rel_l:.2e}, "
            f"{worst[1]} {worst[0]:.2e}")


def check_int8(traj) -> None:
    """Options check 4: the int8 codes of a real graph's bf16 kernel tensor
    within half a step (plus one f32 unit in the last place) of the
    kernels; then a 128-step bf16 sparse scan rollout with int8 against
    one without, reported, and both rates. On the seeded live weights:
    the bench checkpoint's last conv layer is dead, so its rollout does
    not see the kernels' rounding."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        edge_kernel_matrices,
        quantize_kernels_int8,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
        _build_graph,
    )

    cfg = live_cfg("bfloat16")
    cfg8 = dataclasses.replace(cfg, kernel_quant="int8")
    params = gkn_init(cfg, seed=0, device="cuda")
    aa = torch.as_tensor(traj.aminoacids, device="cuda")
    window0 = torch.as_tensor(traj.positions[:cfg.window_size], device="cuda")
    with torch.no_grad():
        graph, _ = _build_graph(cfg, window0[-1], THRESHOLD)
        k = edge_kernel_matrices(params["edge_kernel"], graph.edge_feats,
                                 cfg.width, torch.bfloat16).float()
        k8, s = quantize_kernels_int8(k)
        err = (k8.float() * s[..., None, None] - k).abs()
        ulp = torch.nextafter(k.abs(), torch.full_like(k, float("inf"))) \
            - k.abs()
        slack = (s[..., None, None] / 2 + ulp - err).min().item()
        ref = make_rollout_fn(cfg, STEPS, THRESHOLD, clip=CLIP)(
            params, aa, window0)[0]
        q = make_rollout_fn(cfg8, STEPS, THRESHOLD, clip=CLIP)(
            params, aa, window0)[0]
    torch.cuda.synchronize()
    log(f"int8 codes of a graph's kernels ({k.shape[0]} slots, seeded "
        f"weights {LIVE}): "
        f"|k8 s - k| <= s/2 + ulp holds with {slack:.3e} to spare at the "
        f"tightest element; {STEPS}-step bf16 scan rollout with int8 against "
        f"without: coords max abs diff {(q - ref).abs().max().item():.3e} A, "
        f"edge lists differ at {same_edge_lists(window0, q, ref)} steps "
        f"(reported)")
    require(slack >= 0 and bool(torch.isfinite(q).all()),
            f"int8: slack {slack}, finite {bool(torch.isfinite(q).all())}")
    rates = {"bf16": [], "int8": []}
    for tag in ("bf16", "int8", "int8", "bf16"):
        c = cfg8 if tag == "int8" else cfg
        with torch.no_grad():
            rates[tag].append(steps_per_s(
                lambda n, c=c: make_rollout_fn(c, n, THRESHOLD, clip=CLIP),
                params, aa, window0, 16, 80))
    log(f"plain scan rollout, single stream, E=224, seeded weights, in turns "
        f"bf16, int8, int8, bf16: bf16 {rates['bf16']} steps/s, int8 "
        f"{rates['int8']} steps/s")


def check_legacy(traj) -> None:
    """Options check 5: ``legacy_no_lstm`` (f32, flagship widths): the
    forward and the loss gradient of one batch on the card against the
    port's CPU run with the same weights, within TOL_SCATTER of scale."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        featurize_batch,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        loss_and_grads,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        tree_map,
    )

    cfg = dataclasses.replace(train_cfg("float32", "xla", 0.1),
                              legacy_no_lstm=True)
    ds = WindowDataset(traj, window_size=cfg.window_size, graph_mode="sparse",
                       max_edges=cfg.max_edges)
    host = ds.get_batch(np.arange(LEGACY_BATCH) * 97)
    params = gkn_init(cfg, seed=0, device="cuda")
    runs = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t, d=dev: t.to(d), params)
        (l2, (_, out)), grads = loss_and_grads(
            p, cfg, featurize_batch(cfg, to_device(host, dev)))
        runs[dev] = (float(l2), out.cpu(), tree_map(lambda t: t.cpu(), grads))
    (l_c, out_c, g_c), (l_h, out_h, g_h) = runs["cuda"], runs["cpu"]
    _, rel = scaled_err(out_c, out_h)
    rel_l = abs(l_c - l_h) / abs(l_h)
    worst = max((scaled_err(g, dict(tree_items(g_h))[name])[1], name)
                for name, g in tree_items(g_c))
    log(f"legacy_no_lstm f32 B={LEGACY_BATCH}: the card against the CPU, out "
        f"{rel:.2e} of scale, loss {rel_l:.2e}, worst gradient leaf "
        f"{worst[1]} {worst[0]:.2e} of its scale (tolerance {TOL_SCATTER}); "
        f"leaves {sorted(params)}")
    require(rel <= TOL_SCATTER and rel_l <= TOL_SCATTER
            and worst[0] <= TOL_SCATTER,
            f"legacy card against CPU: out {rel:.2e}, loss {rel_l:.2e}, "
            f"{worst[1]} {worst[0]:.2e}")


def options_phase(traj) -> dict:
    """Phase 16; returns the launches of the training and fused kernels."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )

    t0 = time.perf_counter()
    cfg_k, _ = training_cfgs()
    cfg_k = dataclasses.replace(cfg_k, window_diff=True)
    ds = WindowDataset(traj, window_size=cfg_k.window_size,
                       graph_mode="sparse", max_edges=cfg_k.max_edges)
    counts = train_pair(cfg_k, dataclasses.replace(cfg_k,
                                                   train_conv_impl="xla"),
                        ds, "window_diff training")
    fused, _ = serve_scan_fused(np.asarray(traj.aminoacids, np.int32), traj,
                                window_diff=True)
    counts["fused_edge_conv_stack"] = fused
    for name, n in check_blocked(traj).items():
        counts[name] += n
    check_segment()
    check_int8(traj)
    check_legacy(traj)
    log(f"options path launches: {counts}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return counts


# ---- phase 17: large systems, the cell-list rebuild ---------------------

LARGE_N = 10_000
# the rebuild of the config-5 campaign (tools/config5_campaign.py) at
# 10,000 atoms: its cell capacity, and its max_degree rule, the largest
# in-degree of the breathing grid's frames (35) plus 8, rounded up to a
# multiple of 8. Its table of 16,384 buckets puts up to 34 atoms of the
# grid in one bucket (hash collisions of cells that hold up to 21), past
# the capacity; 65,536 buckets hold at most 22.
LARGE_CELLS = dict(max_degree=48, cell_capacity=32, num_cells=65536)
# the loose chain's largest in-degree at 8 A is 101 (an all-pairs count on
# the CPU), past LARGE_CELLS: its rebuild without overflow needs this room
CHAIN_ROOM = dict(max_degree=128, cell_capacity=64, num_cells=65536)
LARGE_STEPS = 16
LARGE_F32_STEPS = 4
C5_SMALL = 1_200
C5_FRAMES = 24
C5_K = 4
C5_STEPS = 6


def serpentine_grid(n: int, spacing: float) -> np.ndarray:
    """The first n points of a boustrophedon walk over a cubic grid:
    consecutive chain indices are neighbouring grid points."""
    side = int(np.ceil(n ** (1 / 3)))
    pts = []
    for z in range(side):
        ys = range(side) if z % 2 == 0 else range(side - 1, -1, -1)
        for yi, y in enumerate(ys):
            fwd = (z * side + yi) % 2 == 0
            for x in (range(side) if fwd else range(side - 1, -1, -1)):
                pts.append((x, y, z))
                if len(pts) == n:
                    return np.asarray(pts, np.float32) * spacing
    return np.asarray(pts[:n], np.float32) * spacing


def breathing_trajectory(base: np.ndarray, num_frames: int, seed: int = 5,
                         amplitude: float = 0.35,
                         dt: float = 0.02) -> np.ndarray:
    """base plus a smooth field of 8 sine modes, (num_frames, N, 3)."""
    rng = np.random.default_rng(seed)
    m = 8
    k = rng.normal(size=(m, 3)).astype(np.float32) * 0.15
    phi = rng.uniform(0, 2 * np.pi, size=m).astype(np.float32)
    psi = rng.uniform(0, 2 * np.pi, size=m).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=m).astype(np.float32)
    e = rng.normal(size=(m, 3)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    spatial = np.sin(base @ k.T + phi)
    t = (np.arange(num_frames, dtype=np.float32) * dt)[:, None]
    temporal = np.sin(w[None] * t + psi[None]) * amplitude
    disp = np.einsum("rm,nm,mc->nrc", spatial, temporal, e)
    return (base[None] + disp).astype(np.float32)


def kdtree_edges(positions: np.ndarray) -> list:
    """Each frame's COO edges at THRESHOLD with self-loops (scipy)."""
    from scipy.spatial import cKDTree

    out = []
    r = positions.shape[1]
    for frame in positions:
        pairs = cKDTree(frame).query_pairs(THRESHOLD, output_type="ndarray")
        src = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(r)])
        dst = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(r)])
        out.append(np.stack([src, dst]).astype(np.int32))
    return out


def loose_chain(n: int, frames: int) -> np.ndarray:
    """The loose random chain of ``tools/scale_smoke.py`` drifting by
    0.05 A a frame, (frames, n, 3)."""
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.normal(size=(n, 3)) * 2.2, axis=0).astype(np.float32)
    return np.stack([base + 0.05 * i for i in range(frames)])


def event_ms(fn, reps: int = 3) -> float:
    """Time of one ``fn()`` call between CUDA events over ``reps`` calls
    after a warm-up; the host stays ahead of the device, so this is the
    device's time where no call reads the device."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fused_launches() -> int:
    """The fused kernel's launches so far (its program counter)."""
    from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

    return profiling.counters().get("fused_edge_conv_stack", 0)


def reset_all_launches() -> None:
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

    pr.reset_launch_counts()
    tc.reset_launch_counts()
    profiling.count("fused_edge_conv_stack", -fused_launches())
    profiling.count("fused_edge_mlp",
                    -profiling.counters().get("fused_edge_mlp", 0))


def all_launches() -> dict:
    """Every kernel's launches so far, and ``fused_edge_mlp``: the kernel
    tensors the plain model step made through the hand-written edge MLP
    (``ops/edge_conv.py::hand_mlp``), three ``edge_mlp`` launches each."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils import profiling

    return {**pr.launch_counts(), **tc.launch_counts(),
            "fused_edge_conv_stack": fused_launches(),
            "fused_edge_mlp": profiling.counters().get("fused_edge_mlp", 0)}


def counted(fn):
    """fn()'s result and what it launched: ``all_launches()`` read just
    before and just after, the names that moved."""
    before = all_launches()
    out = fn()
    torch.cuda.synchronize()
    after = all_launches()
    return out, {k: n - before[k] for k, n in after.items() if n != before[k]}


def scan_launches(n: int, cfg) -> dict:
    """What n steps of the plain model step of ``cfg`` launch on the card
    without a gradient, issued op by op or replayed: where
    ``ops/edge_conv.py::hand_mlp`` takes the kernel tensor (bf16, the
    edge MLP's widths multiples of 64, at most 16 edge features; not the
    fused sparse stack, which makes its own), three ``edge_mlp`` launches
    and one ``fused_edge_mlp`` a kernel tensor, one a step or two where
    conv2 has its own edge kernel; else nothing."""
    hand = (cfg.compute_dtype == "bfloat16" and cfg.ker_width % 64 == 0
            and cfg.width ** 2 % 64 == 0 and cfg.edge_features <= 16
            and (cfg.graph_mode == "dense" or cfg.conv_impl == "xla"))
    k = n * (1 if cfg.tie_edge_kernel or cfg.legacy_no_lstm else 2)
    return {"edge_mlp": 3 * k, "fused_edge_mlp": k} if hand and n else {}


def require_hand_mlp_only(counts: dict, where: str) -> None:
    """A path on which no kernel lies but the hand-written edge MLP that
    makes the plain step's kernel tensor: each of its ``edge_mlp``
    launches is one of the three of a ``fused_edge_mlp`` call."""
    other = {k: v for k, v in counts.items()
             if v and k not in ("edge_mlp", "fused_edge_mlp")}
    require(not other and counts.get("edge_mlp", 0)
            == 3 * counts.get("fused_edge_mlp", 0),
            f"a kernel launched on {where} other than the hand-written "
            f"edge MLP's three a kernel tensor: {counts}")


def hold_against_all_pairs(pos, out, max_degree: int, tag: str):
    """One example's cell list ``out`` of pos (N, 3) on the card against
    an all-pairs search at THRESHOLD in blocks of 1,000 rows: a node with
    at most ``max_degree`` neighbours keeps exactly them, one with more
    keeps ``max_degree`` of them. Returns (largest true degree, nodes past
    max_degree)."""
    n = pos.shape[0]
    kept = torch.zeros(n, n, dtype=torch.bool, device=pos.device)
    real = out.mask > 0
    kept[out.edges[1][real].long(), out.edges[0][real].long()] = True
    require(int(real.sum()) == int(kept.sum()),
            f"{tag}: a node keeps one neighbour twice")
    most, above = 0, 0
    for i in range(0, n, 1000):
        d = pos[i:i + 1000, None, :] - pos[None]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        true = d2 < THRESHOLD * THRESHOLD
        deg = true.sum(dim=1)
        k = kept[i:i + 1000]
        fits = deg <= max_degree
        require(torch.equal(k[fits], true[fits]),
                f"{tag}: nodes {i}..{i + 999} keep other neighbours than "
                "the all-pairs search finds")
        require(not bool((k & ~true).any()),
                f"{tag}: a kept edge is longer than {THRESHOLD} A")
        require(bool((k[~fits].sum(dim=1) == max_degree).all()),
                f"{tag}: a node past max_degree keeps fewer than "
                f"{max_degree} neighbours")
        most = max(most, int(deg.max()))
        above += int((~fits).sum())
    return most, above


def check_cell_lists(dev) -> None:
    """Phase 17a: the cell list on the card against the port's CPU cell
    list (edges, mask and both flags, exactly, two frames as one batch)
    and against an all-pairs search, on the loose chain and the config-5
    grid at 10,000 atoms; too small capacities raise the flags."""
    from molecular_dynamics_neural_operator_tpu_torch.geometry import (
        cell_list_edges,
    )

    grid = breathing_trajectory(serpentine_grid(LARGE_N, 4.0), 2)
    chain = loose_chain(LARGE_N, 2)
    cases = (("loose chain", chain, LARGE_CELLS, None),
             ("loose chain", chain, CHAIN_ROOM, (False, False)),
             ("config-5 grid", grid, LARGE_CELLS, (False, False)),
             ("config-5 grid", grid[:1], dict(LARGE_CELLS, max_degree=32),
              None),
             ("config-5 grid", grid[:1], dict(LARGE_CELLS, cell_capacity=4),
              (True, False)),
             ("config-5 grid", grid[:1], dict(LARGE_CELLS, max_degree=8),
              (False, True)))
    for name, frames, opts, flags in cases:
        tag = f"cell list, {name}, {opts}"
        cpu = cell_list_edges(torch.as_tensor(frames), THRESHOLD, **opts)
        pos = torch.as_tensor(frames, device=dev)
        card = cell_list_edges(pos, THRESHOLD, **opts)
        torch.cuda.synchronize()
        for field in card._fields:
            require(torch.equal(getattr(card, field).cpu(),
                                getattr(cpu, field)),
                    f"{tag}: {field} differs between the card and the CPU")
        got = [(bool(c), bool(d)) for c, d in
               zip(card.cell_overflow, card.degree_overflow)]
        if flags is not None:
            require(all(g == flags for g in got),
                    f"{tag}: flags {got}, expected {flags}")
        held = []
        for b, (cell_over, _) in enumerate(got):
            if not cell_over:
                one = type(card)(*(t[b] for t in card))
                held.append(hold_against_all_pairs(pos[b], one,
                                                   opts["max_degree"], tag))
        ms = event_ms(lambda: cell_list_edges(pos, THRESHOLD, **opts))
        log(f"{tag}: card equals CPU exactly over {frames.shape[0]} "
            f"frame(s); flags (cell, degree) {got}; mean kept degree "
            f"{card.mask.sum().item() / card.mask[..., 0].numel() / LARGE_N:.2f}"
            f"; all-pairs (largest true degree, nodes past max_degree) per "
            f"frame without cell overflow {held}; the batch's rebuild "
            f"{ms:.2f} ms on the card")


def solvated_cfg(cd: str):
    """``SOLVATED_10K`` with dh and the cell list of LARGE_CELLS, at its
    full width. Seeded weights with ``kernel_init_scale`` 1/(8·depth):
    the edge features are raw coordinates, four times the protein's on
    the 85 A grid, and at configs.py's 1/(2·depth) the first f32 step
    already moves atoms by 2e4 A and the second overflows (a CPU run at
    1,500 atoms); at 1/(8·depth) a step moves the grid's atoms by about
    0.1 A."""
    from molecular_dynamics_neural_operator_tpu_torch import presets

    cfg = presets.SOLVATED_10K
    return dataclasses.replace(
        cfg, compute_dtype=cd, electrostatics="dh",
        neighbor_impl="cell_list",
        max_edges=LARGE_N * LARGE_CELLS["max_degree"],
        kernel_init_scale=1.0 / (8 * cfg.depth), **LARGE_CELLS)


def step_flags(params, cfg, aa, window, steps: int):
    """``steps`` rollout steps through ``rollout.scan._step``, the step
    ``rollout_scan`` takes, with the clip CURRICULUM_CLIP: (coords
    (steps, N, 3), each step's overflow flag)."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import scan

    outs, flags = [], []
    for _ in range(steps):
        window, out, ov = scan._step(params, cfg, aa, window, THRESHOLD,
                                     "last", clip=CURRICULUM_CLIP)
        outs.append(out)
        flags.append(ov)
    return torch.stack(outs), [bool(f) for f in flags]


def solvated_rollout(dev):
    """Phase 17b: the SOLVATED_10K preset at its full width with the cell
    list and dh, seeded weights (``solvated_cfg``): 16 bf16 steps with the
    rollout's clip at CURRICULUM_CLIP on the config-5 grid (no overflow on
    its first frame) and on the loose chain (which overflows the
    settings: its largest in-degree is 101, and the seeded model drives
    its 470 A span apart), each step's flags printed, each run launching
    the hand-written edge MLP's three kernels a step and nothing else; 4
    f32 steps with the blocked reduction against a forced segment scatter
    on the same graphs; steps/s, device ms by part, peak memory. Returns
    the edge MLP's weights and the grid's last graph's edge features."""
    from molecular_dynamics_neural_operator_tpu_torch.device import (
        compute_dtype,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn
    from molecular_dynamics_neural_operator_tpu_torch.ops.edge_conv import (
        edge_conv_sparse,
        edge_kernel_matrices,
        sparse_inv_degree,
    )
    from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
        residue_charges,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
        scan,
    )

    cfg = solvated_cfg("bfloat16")
    require(scan.rebuilt_scatter_hint(cfg, LARGE_N) == "blocked",
            "the 10k-atom rebuild does not take the blocked reduction")
    params = gkn.gkn_init(cfg, seed=0, device=dev)
    aa = torch.as_tensor(np.random.default_rng(1).integers(0, 20, LARGE_N),
                         device=dev)
    t = cfg.window_size
    grid = torch.as_tensor(breathing_trajectory(
        serpentine_grid(LARGE_N, 4.0), t), device=dev)
    chain = torch.as_tensor(loose_chain(LARGE_N, t), device=dev)
    _, first = scan._build_graph(cfg, grid[-1], THRESHOLD)
    require(not bool(first), "the config-5 grid's first frame overflows")
    want = scan_launches(LARGE_STEPS, cfg)
    require(want.get("edge_mlp") == 3 * LARGE_STEPS,
            "the 10k step does not take the hand-written edge MLP")
    with torch.no_grad():
        for name, window in (("config-5 grid", grid), ("loose chain", chain)):
            (coords, flags), n = counted(lambda: step_flags(
                params, cfg, aa, window, LARGE_STEPS))
            require(n == want, f"10k rollout on the {name}: launches {n}, "
                    f"expected {want}")
            require(bool(torch.isfinite(coords).all()),
                    f"10k rollout on the {name}: coordinates not finite")
            moved = (coords - window[-1]).abs().amax(dim=(1, 2))
            log(f"SOLVATED_10K bf16 on the {name}, {LARGE_STEPS} steps: "
                f"finite; each step's overflow flag {flags}; largest "
                f"distance from the first frame after steps 1/4/{LARGE_STEPS} "
                f"{moved[0]:.3g}/{moved[3]:.3g}/{moved[-1]:.3g} A")

        roll = make_rollout_fn(cfg, LARGE_STEPS, THRESHOLD,
                               clip=CURRICULUM_CLIP)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (coords, _, diags), n = counted(lambda: roll(params, aa, grid))
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(bool(torch.isfinite(coords).all()),
                "make_rollout_fn on the grid: not finite")
        require(n == want, f"make_rollout_fn on the grid: launches {n}, "
                f"expected {want}")

        # the step by part, on the grid's last frame
        cd = compute_dtype(cfg)
        frame = grid[-1]
        graph, _ = scan._build_graph(cfg, frame, THRESHOLD)
        last_ef = graph.edge_feats
        charges = residue_charges(aa)
        kern = edge_kernel_matrices(params["edge_kernel"], graph.edge_feats,
                                    cfg.width, cd)
        x0 = gkn._encode_nodes(params, cfg, aa, grid)
        inv_deg = sparse_inv_degree(graph.edges, graph.mask, LARGE_N,
                                    "blocked")

        def convs():
            h = x0
            for conv in ("conv1", "conv2"):
                for _ in range(cfg.depth):
                    h = torch.relu(edge_conv_sparse(
                        params[conv], h, kern, graph.edges, graph.mask,
                        inv_deg, "blocked", cd))
            return h

        parts = {
            "rebuild": event_ms(lambda: scan._build_graph(cfg, frame,
                                                          THRESHOLD)),
            "dh": event_ms(lambda: gkn.dh_potential(cfg, charges, frame)),
            "edge MLP": event_ms(lambda: edge_kernel_matrices(
                params["edge_kernel"], graph.edge_feats, cfg.width, cd)),
            "convs": event_ms(convs),
        }
        step = event_ms(lambda: scan._step(params, cfg, aa, grid, THRESHOLD,
                                           "last", clip=CURRICULUM_CLIP))
    log(f"SOLVATED_10K bf16 (width 64, ker_width 1024, depth 6, E = "
        f"{cfg.max_edges:,} slots), make_rollout_fn on the grid: "
        f"{LARGE_STEPS} steps in {dt:.3f} s = {LARGE_STEPS / dt:.2f} "
        f"steps/s (one call, no warm-up of its own), overflow "
        f"{bool(diags['edge_overflow'])}, peak memory {peak:.2f} GB; a step "
        f"{step:.2f} ms of device time (CUDA events), by part: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in parts.items()))

    # f32: the blocked reduction against the segment scatter on each step's
    # graph; the window advances with the blocked output
    from molecular_dynamics_neural_operator_tpu_torch.models.gkn import (
        gkn_apply_single,
        residual_prior,
    )

    cfg32 = solvated_cfg("float32")
    window, worst = grid, (0.0, 0.0)
    with torch.no_grad():
        for i in range(LARGE_F32_STEPS):
            graph, ov = scan._build_graph(cfg32, window[-1], THRESHOLD)
            out_b = gkn_apply_single(params, cfg32, aa, window, graph,
                                     scatter_hint="blocked")
            out_s = gkn_apply_single(params, cfg32, aa, window, graph,
                                     scatter_hint="segment")
            head = (out_s - residual_prior(cfg32, window)).abs().max().item()
            scale = out_s.abs().max().item()
            err = (out_b - out_s).abs().max().item()
            require(err <= TOL_F32 * scale and not bool(ov),
                    f"f32 10k step {i}: blocked against segment {err} > "
                    f"{TOL_F32} of the coordinates' {scale}, overflow "
                    f"{bool(ov)}")
            worst = max(worst, (err / scale, err / head))
            window = torch.cat([window[1:], out_b[None]])
    log(f"SOLVATED_10K f32, {LARGE_F32_STEPS} steps, blocked against "
        f"segment (its atomic adds sum in another order) on the same "
        f"graphs: worst error {worst[0]:.2e} of the coordinates' scale "
        f"(limit {TOL_F32}, the JAX package's tests/test_cells.py), "
        f"{worst[1]:.2e} of the head's output")
    return params["edge_kernel"], last_ef


def hold_large_edge_mlp(mlp_params, ef, launches: int) -> dict:
    """Phase 17e: ``edge_mlp_stack`` at the 10k step's rows (480,000 cell
    list slots, the persistent plan; no row mask, as the model step calls
    it) against three ``edge_mlp_plain`` layers on the same bf16 inputs,
    held as phase 2 holds the stack; its first 1,792 rows against the
    same rows through the small plans, to the bit. Returns its
    ``kernels`` record: device time, the plain layers', three bf16
    ``torch.addmm`` with ReLUs (the library's), the bound, and
    ``launches``: phase 17's steps' (``launches``) and the hold's own
    three."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        edge_mlp as em,
    )

    cd = torch.bfloat16
    mlp = [{"w": mlp_params[f"layer_{i}"]["w"].to(cd).contiguous(),
            "b": mlp_params[f"layer_{i}"]["b"].float().contiguous()}
           for i in range(3)]
    a = ef.to(cd).contiguous()
    m, kw, n = a.shape[0], mlp[1]["w"].shape[0], mlp[2]["w"].shape[1]
    require(m >= 16384, f"the 10k step has {m} rows, fewer than the "
            f"persistent plan's 16,384")
    h1 = torch.empty(m, kw, dtype=cd, device=a.device)
    h2, out = torch.empty_like(h1), torch.empty(m, n, dtype=cd,
                                                device=a.device)

    def kernel_mlp():
        em.edge_mlp_stack(a, mlp, None, h1, h2, out)

    def plain_mlp():
        x = a
        for i, layer in enumerate(mlp):
            x = em.edge_mlp_plain(x, layer["w"], layer["b"], i < 2)
        return x

    bias_cd = [layer["b"].to(cd) for layer in mlp]

    def library_mlp():
        x = a
        for i, layer in enumerate(mlp):
            x = torch.addmm(bias_cd[i], x, layer["w"])
            x = torch.relu(x) if i < 2 else x
        return x

    _, n_launch = counted(kernel_mlp)
    require(n_launch == {"edge_mlp": 3}, f"edge_mlp_stack at {m:,} rows "
            f"launched {n_launch}")
    ref = plain_mlp()
    err, rel = rel_err(out, ref)
    del ref
    require(bool(torch.isfinite(out).all()) and rel <= 3 * TOL_BF16,
            f"edge_mlp_stack at {m:,} rows: error {err} ({rel:.2e} of "
            f"scale)")
    small = 1792
    s_h1, s_h2 = h1[:small].clone(), h2[:small].clone()
    s_out = torch.empty(small, n, dtype=cd, device=a.device)
    em.edge_mlp_stack(a[:small].contiguous(), mlp, None, s_h1, s_h2, s_out)
    require(torch.equal(s_out, out[:small]), f"the persistent plan's first "
            f"{small} rows differ from the small plans'")
    mlp_ops = 2 * m * (a.shape[1] * kw + kw * kw + kw * n)
    mlp_bytes = nbytes(*(t for layer in mlp for t in layer.values())) \
        + m * (a.shape[1] + n) * 2
    t_bytes, t_ops = mlp_bytes / HBM_BYTES_PER_S, mlp_ops / PEAK_FLOPS[cd]
    rec = {
        "name": "edge_mlp_persistent", "route": "cuda",
        "source": f"{PKG}/csrc/edge_mlp.cu", "replaces": f"{TPU_KERNEL}:264",
        "rows": m, "launches": launches + 3, "max_abs_err": err,
        "ms": device_ms(kernel_mlp, reps=5, iters=3),
        "plain_ms": device_ms(plain_mlp, reps=1, iters=2),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": device_ms(library_mlp, reps=2, iters=2),
    }
    log(f"edge_mlp_stack at the 10k step's {m:,} rows (the persistent "
        f"plan): max abs err {err:.3e} ({rel:.2e} of scale) against the "
        f"plain layers, its first {small} rows the small plans' to the bit; "
        f"{rec['ms']:.3f} ms (plain {rec['plain_ms']:.3f} ms, bound "
        f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}, "
        f"{rec['bound_ms'] / rec['ms']:.1%} of it; library "
        f"{rec['library_ms']:.3f} ms)")
    return rec


def config5_data(n: int):
    """The config-5 campaign's system at n atoms: the breathing grid
    (C5_FRAMES frames), its KD-tree edges in the blocked layout, max_degree
    from the data with 8 of headroom, and the campaign's
    ``--kernel_init_scale`` 1/(2*depth), without which the seeded f32
    forward reaches the coordinate clip and every gradient is 0;
    (cfg, dataset)."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        TrajectoryData,
        WindowDataset,
    )

    pos = breathing_trajectory(serpentine_grid(n, 4.0), C5_FRAMES)
    edges = kdtree_edges(pos)
    deg = max(int(np.bincount(e[1], minlength=n).max()) for e in edges)
    max_degree = ((deg + 8 + 7) // 8) * 8
    traj = TrajectoryData(
        positions=pos, edge_indices=edges,
        aminoacids=np.random.default_rng(0).integers(0, 20, n).astype(
            np.int32))
    cfg = ModelConfig(
        compute_dtype="float32", graph_mode="sparse", num_residues=n,
        max_edges=n * max_degree, width=32, ker_width=128, depth=4,
        predict_delta=True, electrostatics="dh", scatter_mode="blocked",
        kernel_init_scale=1.0 / (2 * 4), train_conv_impl="xla",
        neighbor_impl="cell_list",
        max_degree=max_degree, cell_capacity=LARGE_CELLS["cell_capacity"],
        num_cells=LARGE_CELLS["num_cells"])
    ds = WindowDataset(traj, window_size=cfg.window_size,
                       graph_mode="sparse", max_edges=cfg.max_edges,
                       threshold=THRESHOLD, edge_layout="blocked")
    return cfg, ds


def config5_training(dev) -> None:
    """Phase 17c: the config-5 training shape (f32, width 32, ker_width
    128, depth 4, dh, blocked, the cell list; B = 1). At 1,200 atoms one
    K = 4 step with ``grad_steps=1`` on the card against the CPU: the same
    rebuilt edge lists, the loss and every gradient leaf within
    TOL_CURRICULUM_GRAD of its norm. At 10,000 atoms C5_STEPS steps
    through ``make_curriculum_train_step``: finite losses, time, peak
    memory."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        TrainConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        curriculum_loss_batched,
        featurize_batch,
        make_curriculum_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.loop import (
        value_and_grad,
    )

    cfg, ds = config5_data(C5_SMALL)
    host = ds.get_batch(np.array([0]), rollout_horizon=C5_K)
    res = {}
    for where in ("cuda", "cpu"):
        batch = to_device(host, where)
        params = gkn_init(cfg, seed=0, device=where)
        with RecordGraphs() as rec:
            (loss, (m, ov)), grads = value_and_grad(
                lambda p: curriculum_loss_batched(
                    p, cfg, featurize_batch(cfg, batch), batch["y_seq"],
                    coord_clip=CURRICULUM_CLIP, grad_steps=1,
                    return_overflow=True), params)
        res[where] = (float(loss), bool(ov), rec.graphs,
                      {k: v.cpu() for k, v in tree_items(grads)})
    (l_c, ov_c, gr_c, g_c), (l_h, ov_h, gr_h, g_h) = res["cuda"], res["cpu"]
    require(len(gr_c) == len(gr_h) == C5_K - 1,
            f"config 5: rebuilt {len(gr_c)} and {len(gr_h)} graphs")
    for i, ((e_c, m_c), (e_h, m_h)) in enumerate(zip(gr_c, gr_h)):
        require(torch.equal(e_c.cpu(), e_h) and torch.equal(m_c.cpu(), m_h),
                f"config 5 at {C5_SMALL} atoms: the edge lists rebuilt at "
                f"step {i + 2} differ between the card and the CPU")
    require(ov_c == ov_h, f"config 5: overflow {ov_c} on the card, {ov_h} "
            "on the CPU")
    rel_l = abs(l_c - l_h) / abs(l_h)
    gaps = {name: (g_c[name] - g).norm().item() / g.norm().item()
            for name, g in g_h.items() if g.norm().item() > 0}
    worst = max(gaps.items(), key=lambda kv: kv[1])
    log(f"config-5 training shape at {C5_SMALL} atoms (max_degree "
        f"{cfg.max_degree}, E = {cfg.max_edges:,}), K={C5_K}, grad_steps=1, "
        f"card against CPU: the same edge lists at all {len(gr_c)} "
        f"rebuilds (overflow {ov_c}); loss {l_c:.7g} against {l_h:.7g} "
        f"({rel_l:.2e}); worst "
        f"gradient leaf {worst[0]} {worst[1]:.2e} of its norm, "
        f"{len(gaps)} leaves with a gradient (limit {TOL_CURRICULUM_GRAD})")
    require(rel_l <= TOL_CURRICULUM_GRAD and worst[1] <= TOL_CURRICULUM_GRAD,
            f"config 5: loss {rel_l:.2e} or gradient {worst} past "
            f"{TOL_CURRICULUM_GRAD}")

    cfg, ds = config5_data(LARGE_N)
    tcfg = TrainConfig(lr=3e-4, weight_decay=1e-6, batch_size=1,
                       grad_clip_norm=1.0, skip_nonfinite_updates=True)
    state, tx, _ = create_train_state(0, cfg, tcfg, device=dev)
    step = make_curriculum_train_step(
        cfg, tx, rollout_steps=C5_K, threshold=THRESHOLD,
        coord_clip=CURRICULUM_CLIP, grad_steps=1, unroll_scans=True)
    batches = [to_device(ds.get_batch(np.array([i]), rollout_horizon=C5_K),
                         dev) for i in range(C5_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, batches[0])
    losses = [float(m["rel_l2"])]
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms = []
    for b in batches[1:]:
        state, m = step(state, b)
        ms.append(m)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (C5_STEPS - 1)
    losses += [float(x["rel_l2"]) for x in ms]
    overflow = any(bool(x["edge_overflow"]) for x in ms)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"config-5 training shape at {LARGE_N} atoms (max_degree "
        f"{cfg.max_degree}, E = {cfg.max_edges:,}), K={C5_K}, "
        f"grad_steps=1, B=1: losses {[f'{x:.6g}' for x in losses]}, "
        f"overflow {overflow}; the first step {first:.2f} s, then "
        f"{dt * 1e3:.1f} ms a step (wall, with the optimizer's host read); "
        f"peak memory {peak:.2f} GB")
    require(all(np.isfinite(losses)), f"config 5 at 10k: losses {losses}")


def large_cli_phase(traj, root) -> None:
    """Phase 17d: ``rollout_from_trajectory`` with ``--neighbor_impl
    cell_list`` on the bench checkpoint for 128 steps against the ranked
    rebuild, f32: the same contact maps at every step, coordinates within
    TOL_ROLL, no kernel launched."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        ModelConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout.scan import (
        rebuilt_scatter_hint,
    )

    cells = ["--neighbor_impl", "cell_list", "--max_degree", "32",
             "--cell_capacity", "32", "--num_cells", "4096"]
    require(rebuilt_scatter_hint(ModelConfig(
        graph_mode="sparse", neighbor_impl="cell_list"), 28) == "onehot",
        "the BBA cell-list rebuild does not take the one-hot scatter")
    flags = ["--checkpoint", str(CKPT), "--max_edges", "224", "--clip",
             str(CLIP), "--num_steps", str(CLI_ROLL_STEPS),
             "--compute_dtype", "float32", "--impl", "scan"]
    cs, cc, c_counts = cli_roll_run(traj, root / "cell_list", flags + cells)
    rs, rc, r_counts = cli_roll_run(traj, root / "dense_rank", flags)
    t_len = bench_cfg("float32").window_size
    w0 = torch.as_tensor(traj.positions[:t_len], device="cuda")
    differing = same_edge_lists(w0, cc, rc)
    err = (cc - rc).abs().max().item()
    log(f"cli.rollout --neighbor_impl cell_list, f32, {CLI_ROLL_STEPS} "
        f"steps of the bench checkpoint against the ranked rebuild: "
        f"contact maps differ at {differing} steps, coords max abs err "
        f"{err:.3e} A (limit {TOL_ROLL}); steps/s {cs['steps_per_s']:,.1f} "
        f"against {rs['steps_per_s']:,.1f} (one call each); launches "
        f"{c_counts} and {r_counts}")
    require(differing == 0 and err <= TOL_ROLL,
            f"cell-list CLI rollout: {differing} steps, error {err}")
    require(not any(c_counts.values()) and not any(r_counts.values()),
            "the scan rollouts launched a rollout kernel")


def large_phase(traj) -> dict:
    """Phase 17. Of the kernels only the hand-written edge MLP lies on its
    path: it makes the bf16 10k step's kernel tensor (480,000 rows, the
    persistent plan), three launches a step. Returns {"kernels": [the
    persistent plan's record]}."""
    import tempfile

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    reset_all_launches()
    _, n_cells = counted(lambda: check_cell_lists(dev))
    mlp_params, ef = solvated_rollout(dev)
    _, n_train = counted(lambda: config5_training(dev))
    require(not n_cells and not n_train,
            f"a kernel launched by the cell lists ({n_cells}) or the "
            f"config-5 training ({n_train})")
    counts = all_launches()
    require_hand_mlp_only(counts, "the large-system path")
    # the f32 cell-list CLI holds its own launches at none (its runs
    # zero the rollout kernels' counts first)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_large_") as tmp:
        large_cli_phase(traj, Path(tmp))
    rec = hold_large_edge_mlp(mlp_params, ef, counts["edge_mlp"])
    log(f"large-system path launches: {counts}, every edge_mlp launch the "
        f"10k step's kernel tensor; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return {"kernels": [rec]}


# ---- phase 18: the FNO ----------------------------------------------------

FNO_BATCH = 128
FNO_ROLL_STEPS = 128
FNO_EXACT_STEPS = 16
# card against CPU, and the fft form against the dft form: f32 transforms
# and complex products summed in other orders, ~1e-7 of the output's
# scale per layer through 4 layers; 1e-5 of scale is a hundred times that,
# while a wrong mode block or a wrong inverse moves the output by its own
# size
TOL_FNO = 1e-5
# the same, per gradient leaf, over the leaf's norm (the f32 training
# limit of phase 11a)
TOL_FNO_GRAD = 1e-4
# the 128-step rollout of the trained FNO, card against CPU, each step
# against the largest distance: the first 16 steps within TOL_FNO; later
# each step's ~1e-7 difference is fed back and may grow by the map's gain,
# so the whole rollout is held to 1e-3 of scale, still a hundredth of the
# ~1e-1 change that a wrong transform makes in one step
TOL_FNO_ROLL = 1e-3
FNO_CLI = ["--data_path", CLI_DATA, "--operator", "fno", "--epochs", "1",
           "--batch_size", str(FNO_BATCH)]


def fno_cfg(**kw):
    """The CLI's FNO on BBA: width 32, modes 12, depth 4, window 10."""
    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        FNOConfig,
    )

    return FNOConfig(in_channels=10, num_residues=28, **kw)


class GradRecorder:
    """An optimizer that keeps the gradients as its state and leaves the
    parameters as they are: after ``step(state, batch)`` the new state's
    ``opt_state`` holds the step's gradients."""

    def update(self, grads, opt_state, params):
        from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
            tree_map,
        )

        return tree_map(torch.zeros_like, grads), grads


def check_spectral(dev) -> dict:
    """Phase 18a: ``_spectral_conv`` at the CLI's width and modes, fft
    against dft on the card and the card's fft against the CPU's, at
    R = 28 (B = 128) and R = 160 (B = 16); cuFFT's own two-axis C2R of the
    same spectrum reported beside the written-out inverse. Returns the
    forms' device µs at R = 28."""
    from molecular_dynamics_neural_operator_tpu_torch.models import fno

    cfg = fno_cfg()
    sp = fno.fno_init(cfg, seed=0, device=dev)["spectral_0"]
    sp_cpu = {k: v.cpu() for k, v in sp.items()}
    us = {}
    for r, b in ((28, FNO_BATCH), (160, 16)):
        x = torch.as_tensor(np.random.default_rng(r).normal(
            size=(b, r, r, cfg.width)).astype(np.float32), device=dev)
        with torch.no_grad():
            out = {impl: fno._spectral_conv(sp, x, cfg.modes1, cfg.modes2,
                                            impl)
                   for impl in ("fft", "dft")}
            cpu = fno._spectral_conv(sp_cpu, x.cpu(), cfg.modes1, cfg.modes2,
                                     "fft")
            # the spectrum the fft form inverts, through cuFFT's C2R
            w = torch.complex(sp["w_real"], sp["w_imag"])
            xf = torch.fft.rfft2(x, dim=(-3, -2))
            out_f = torch.zeros_like(xf)
            m1, m2 = cfg.modes1, cfg.modes2
            out_f[..., :m1, :m2, :] = fno._mix(xf[..., :m1, :m2, :], w)
            out_f[..., -m1:, :m2, :] = fno._mix(xf[..., -m1:, :m2, :],
                                                w.conj())
            c2r = torch.fft.irfft2(out_f, s=(r, r), dim=(-3, -2))
        scale = max(1.0, out["dft"].abs().max().item())
        e_forms = (out["fft"] - out["dft"]).abs().max().item() / scale
        e_cpu = (out["fft"].cpu() - cpu).abs().max().item() / scale
        e_c2r = (c2r - out["fft"]).abs().max().item() / scale
        times = {impl: 1e3 * event_ms(
            lambda impl=impl: fno._spectral_conv(sp, x, m1, m2, impl), 20)
            for impl in ("fft", "dft")}
        log(f"FNO spectral conv at R={r}, B={b}, width {cfg.width}, modes "
            f"{m1}: fft against dft {e_forms:.2e} of scale, the card's fft "
            f"against the CPU's {e_cpu:.2e} (limit {TOL_FNO}); cuFFT's "
            f"irfft2 of the same non-Hermitian spectrum differs from the "
            f"written-out inverse by {e_c2r:.2e} of scale; device time fft "
            f"{times['fft']:.1f} us, dft {times['dft']:.1f} us")
        require(e_forms <= TOL_FNO and e_cpu <= TOL_FNO,
                f"spectral conv at R={r}: forms {e_forms:.2e}, card against "
                f"CPU {e_cpu:.2e}")
        if r == 28:
            us = times
    return us


def check_fno_step(ds) -> None:
    """Phase 18b: one train step at B = 128, card against CPU from the
    same weights and batch: the loss within TOL_FNO, every gradient leaf
    within TOL_FNO_GRAD of its norm, with ``spectral_impl`` "auto" (the
    dft form at R = 28) and "fft"."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import fno
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    host = ds.get_batch(np.linspace(0, len(ds) - 1, FNO_BATCH).astype(int))
    for impl in ("auto", "fft"):
        cfg = fno_cfg(spectral_impl=impl)
        res = {}
        for where in ("cuda", "cpu"):
            step = fno.make_fno_window_train_step(cfg, GradRecorder()).eager
            state, m = step(TrainState(fno.fno_init(cfg, seed=0,
                                                    device=where),
                                       None, 0, 0), to_device(host, where))
            res[where] = (float(m["rel_l2"]),
                          {k: v.cpu() for k, v in tree_items(state.opt_state)})
        (l_c, g_c), (l_h, g_h) = res["cuda"], res["cpu"]
        rel_l = abs(l_c - l_h) / abs(l_h)
        gaps = {k: (g_c[k] - g).norm().item() / g.norm().item()
                for k, g in g_h.items() if g.norm().item() > 0}
        worst = max(gaps.items(), key=lambda kv: kv[1])
        log(f"FNO train step ({impl}), B={FNO_BATCH}, card against CPU: "
            f"loss {l_c:.7g} against {l_h:.7g} ({rel_l:.2e}, limit "
            f"{TOL_FNO}); worst gradient leaf {worst[0]} {worst[1]:.2e} of "
            f"its norm over {len(gaps)} leaves (limit {TOL_FNO_GRAD})")
        require(rel_l <= TOL_FNO and worst[1] <= TOL_FNO_GRAD,
                f"FNO step ({impl}): loss {rel_l:.2e}, gradient {worst}")


def fno_cli_run(traj, run_dir, extra):
    """One ``train_from_trajectory`` of ``--operator fno``: (args, state,
    the epoch's metrics row)."""
    from molecular_dynamics_neural_operator_tpu_torch.cli import (
        train as cli_train,
    )

    args = cli_train.parse_args(FNO_CLI + ["--run_path", str(run_dir)]
                                + extra)
    state = cli_train.train_from_trajectory(args, traj)
    torch.cuda.synchronize()
    row = json.loads((run_dir / "metrics.jsonl").read_text()
                     .splitlines()[-1])
    require(all(np.isfinite(row[k]) for k in ("avg_train_loss",
                                               "avg_valid_loss")),
            f"cli.train --operator fno {extra}: losses {row}")
    return args, state, row


def fno_cli_phase(traj, root):
    """Phase 18c: ``cli.train --operator fno`` on the card (an epoch and a
    ``--rollout_steps 4`` epoch) and the first epoch on the CPU: finite
    losses, config.json's fno section, best.npz and last.npz restore, the
    movie, the epoch loss within TOL_TRAIN_LOSS of the CPU's. Returns the
    card's trained state."""
    from molecular_dynamics_neural_operator_tpu_torch import configs
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
    )

    steps = len(train_valid_split(len(traj.positions) - 10)[0]) // FNO_BATCH
    runs = {}
    for tag, extra in (("card", []), ("card K=4", ["--rollout_steps", "4"]),
                       ("cpu", ["--device", "cpu"])):
        run_dir = root / tag.replace(" ", "_").replace("=", "")
        t0 = time.perf_counter()
        args, state, row = fno_cli_run(traj, run_dir, extra)
        runs[tag] = (args, state, row, run_dir)
        log(f"cli.train --operator fno {' '.join(extra)}: train rel_l2 "
            f"{row['avg_train_loss']:.6g}, valid "
            f"{row['avg_valid_loss']:.6g}; {steps} steps at "
            f"B={FNO_BATCH}, the epoch {row['seconds']:.3f} s = "
            f"{steps * FNO_BATCH / row['seconds']:,.0f} samples/s "
            f"(the call {time.perf_counter() - t0:.2f} s)")
    args, state, row, run_dir = runs["card"]
    got = configs.experiment_from_json((run_dir / "config.json").read_text())
    require(got.fno == fno_cfg(), f"config.json's fno section {got.fno}")
    for name in ("best.npz", "last.npz"):
        back, meta = restore_checkpoint(run_dir / name, state)
        require(meta.get("epoch") == 0 and all(
            torch.equal(a, b) for (_, a), (_, b) in
            zip(tree_items(back.params), tree_items(state.params))),
            f"{name} does not restore the run's parameters")
    movie = Path(row.get("movie", ""))
    require(movie.exists(), f"no movie written ({row.get('movie')})")
    cpu_loss = runs["cpu"][2]["avg_train_loss"]
    rel = abs(row["avg_train_loss"] - cpu_loss) / abs(cpu_loss)
    log(f"cli.train --operator fno: config.json's fno section reads back, "
        f"best.npz and last.npz restore, the movie is {movie.name}; the "
        f"card's epoch loss {rel:.2e} from the CPU's (limit "
        f"{TOL_TRAIN_LOSS})")
    require(rel <= TOL_TRAIN_LOSS, f"FNO epoch: card against CPU {rel:.2e}")
    return state


def check_fno_rollout(traj, params) -> float:
    """Phase 18d: 128 steps of ``fno_rollout_scan`` of the trained
    parameters, card against CPU. Returns the card's steps/s."""
    from molecular_dynamics_neural_operator_tpu_torch.models import fno

    cfg = fno_cfg()
    ch0 = fno.distance_matrix_channels(torch.as_tensor(traj.positions[:10]))
    with torch.no_grad():
        card, _ = fno.fno_rollout_scan(params, cfg, ch0.cuda(),
                                       FNO_ROLL_STEPS)
        cpu, _ = fno.fno_rollout_scan({k: {n: t.cpu() for n, t in v.items()}
                                       for k, v in params.items()}, cfg, ch0,
                                      FNO_ROLL_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fno.fno_rollout_scan(params, cfg, ch0.cuda(), FNO_ROLL_STEPS)
        torch.cuda.synchronize()
        rate = FNO_ROLL_STEPS / (time.perf_counter() - t0)
    scale = max(1.0, cpu.abs().max().item())
    err = (card.cpu() - cpu).abs().flatten(1).amax(dim=1) / scale
    log(f"fno_rollout_scan, {FNO_ROLL_STEPS} steps of the trained FNO, card "
        f"against CPU: error over scale {scale:.1f} A, first "
        f"{FNO_EXACT_STEPS} steps {err[:FNO_EXACT_STEPS].max().item():.2e} "
        f"(limit {TOL_FNO}), all {err.max().item():.2e} (limit "
        f"{TOL_FNO_ROLL}), at steps 32/64/128 "
        f"{err[31].item():.2e}/{err[63].item():.2e}/{err[-1].item():.2e}; "
        f"finite {bool(torch.isfinite(card).all())}; {rate:,.1f} steps/s "
        f"on the card")
    require(bool(torch.isfinite(card).all()), "FNO rollout not finite")
    require(err[:FNO_EXACT_STEPS].max().item() <= TOL_FNO
            and err.max().item() <= TOL_FNO_ROLL,
            f"FNO rollout: card against CPU {err.max().item():.2e}")
    return rate


def time_fno(ds) -> None:
    """Phase 18e: a teacher-forced train step's wall time, samples/s,
    device time and busy share (``torch.profiler``), at B = 128."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import fno
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    batch = to_device(ds.get_batch(np.arange(FNO_BATCH)), "cuda")
    for impl in ("auto", "fft"):
        cfg = fno_cfg(spectral_impl=impl)
        tx, _ = make_optimizer(lr=1e-3)
        params = fno.fno_init(cfg, seed=0, device="cuda")
        state = TrainState(params, tx.init(params), 0, 0)
        step = fno.make_fno_window_train_step(cfg, tx)
        wall = wall_ms(step, state, batch)
        busy = profile_step(step, state, batch, wall,
                            f"FNO train step ({impl})")
        log(f"FNO train step ({impl}), B={FNO_BATCH}: {wall:.2f} ms wall = "
            f"{FNO_BATCH / wall * 1e3:,.0f} samples/s; device busy "
            f"{busy:.2f} ms ({busy / wall:.2f})")


def fno_phase(traj) -> dict:
    """Phase 18; no kernel lies on its path."""
    import tempfile

    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    reset_all_launches()
    ds = WindowDataset(traj, window_size=10, graph_mode="none")
    us = check_spectral(dev)
    check_fno_step(ds)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fno_") as tmp:
        state = fno_cli_phase(traj, Path(tmp))
    rate = check_fno_rollout(traj, state.params)
    time_fno(ds)
    counts = all_launches()
    require(not any(counts.values()),
            f"a kernel launched on the FNO path: {counts}")
    log(f"FNO path: spectral conv fft {us['fft']:.1f} us, dft "
        f"{us['dft']:.1f} us; rollout {rate:,.1f} steps/s; launches none "
        f"{counts}; the phase took {time.perf_counter() - t0:.1f} s")
    return {}


# ---- phase 19: serving bundles, preprocessing, the host pipeline --------

EXPORT_STEPS = 128
EXPORT_STREAMS = 8
EXPORT_CHUNK = 4
# the APBS deck's fine grid (templates/electrostatics.in.tmpl): fglen and
# dime, the defaults of cli/preprocess.py --mode dh
DECK_LENGTHS = (52.958, 44.009, 38.33)
DECK_DIME = (97, 65, 65)
DH_FRAMES = 64
DH_LARGE_FRAMES = 2
DH_SAMPLE = 256
# H100 SXM special-function units: 16 results a clock on each of 132 SMs
# at 1.98 GHz; a grid point's pair term takes about 3 of them (sqrt, exp,
# the reciprocal)
SFU_PER_S = 16 * 132 * 1.98e9
DH_SFU_PER_PAIR = 3
# The potential at a grid point is an f32 sum of up to 10,000 terms
# exp(-kappa d)/d, taken in another order on the card, on the CPU and in
# the float64 oracle: a few f32 units of the largest term each, about
# 1e-6 of the grid's max |phi| at 10,000 atoms; held to 1e-4 of it. A
# wrong kappa, clamp or charge moves phi by its own size.
TOL_DH = 1e-4
# Trilinear samples: f32 weights of f32 grid values, against a float64
# interpolation of the same grid; ulps of the grid's max |phi|.
TOL_TRILINEAR = 1e-5


def timed_call(fn):
    """(result, seconds) of one ``fn()`` with the card synchronised on
    both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def held_bundle(bundle, inputs, want, tag: str, launches=None,
                **kw) -> None:
    """The bundle's call (CUDA graphs of its step) against the in-process
    result and against ``bundle.eager`` (its step loop issued from
    Python), bit for bit; the second graphed call under
    ``set_sync_debug_mode("error")``. With ``launches`` each of the three
    calls launches exactly that (``counted``). ``kw`` goes to every
    call."""
    from molecular_dynamics_neural_operator_tpu_torch.cli.export import (
        same_outputs,
    )

    got, n_got = counted(lambda: bundle(*inputs, **kw))
    with sync_errors():
        again = bundle(*inputs, **kw)
    eager, n_eager = counted(lambda: bundle.eager(*inputs, **kw))
    require(launches is None or n_got == n_eager == launches,
            f"{tag}: launches {n_got} graphed and {n_eager} eager, "
            f"expected {launches}")
    require(same_outputs(got, want) and same_outputs(again, want),
            f"{tag}: the bundle differs from the in-process rollout")
    require(same_outputs(eager, got), f"{tag}: the bundle's graphs differ "
            "from its eager step loop")
    coords = got[0][0] if isinstance(got[0], tuple) else got[0]
    overflow = got[2]["edge_overflow"] if len(got) > 2 else None
    log(f"{tag}: graphed bit-equal to the in-process rollout and to the "
        f"bundle's eager loop (outputs {tuple(coords.shape)}, finite "
        f"{bool(torch.isfinite(coords).all())}"
        + ("" if overflow is None else
           f", edge overflow {overflow.any().item()}") + ")")


def bundle_rates(tag: str, runs: dict, steps: int) -> None:
    """Steps/s of each ``runs`` entry (name -> a call of ``steps`` steps
    a stream), two timed calls each, in turns, after a warm call of each
    graphed entry (which captures its graphs)."""
    for name, run in runs.items():
        if "graphed" in name:
            run()
    seconds = {name: [] for name in runs}
    for _ in range(2):
        for name, run in runs.items():
            seconds[name].append(timed_call(run)[1])
    log(f"{tag}: " + ", ".join(
        f"{name} " + " and ".join(f"{steps / t:,.1f}" for t in ts)
        for name, ts in seconds.items()) + " steps/s")


def export_bundles(traj, root: Path) -> None:
    """Phase 19a: serving bundles of the flagship and of the FNO on the
    card, each held bit for bit against the in-process rollout."""
    from molecular_dynamics_neural_operator_tpu_torch.cli.export import (
        same_outputs,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import (
        fno,
        gkn_init,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.export import (
        bundle_bytes,
        load_bundle,
        save_bundle,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    dev = torch.device("cuda")
    cfg = bench_cfg("bfloat16")
    require(cfg.conv_impl == "xla", f"bench config conv_impl {cfg.conv_impl}")
    params = load_params_npz(CKPT, device=dev)
    aa = torch.as_tensor(traj.aminoacids, device=dev)
    t_len = cfg.window_size
    window0 = torch.as_tensor(traj.positions[:t_len], device=dev)
    windows = torch.as_tensor(np.stack(
        [traj.positions[i * 500:i * 500 + t_len]
         for i in range(EXPORT_STREAMS)]), device=dev)
    kw = dict(threshold=THRESHOLD, collect="both", clip=CLIP)

    def in_process(batched=False, chunk=None):
        return make_rollout_fn(cfg, EXPORT_STEPS, THRESHOLD, collect="both",
                               batched=batched, clip=CLIP,
                               stream_chunk=chunk, device=dev)

    path, export_s = timed_call(lambda: save_bundle(
        root / "one", params, cfg, EXPORT_STEPS, **kw))
    bundle, load_s = timed_call(lambda: load_bundle(path, device=dev))
    # the bf16 step makes its kernel tensor through the hand-written edge
    # MLP, in process and in the bundle alike
    one = scan_launches(EXPORT_STEPS, cfg)
    require(one.get("edge_mlp") == 3 * EXPORT_STEPS, "the bench "
            "configuration's step does not take the hand-written edge MLP")
    with torch.no_grad():
        want, n_want = counted(lambda: in_process()(params, aa, window0))
        eager = in_process().eager(params, aa, window0)
    require(n_want == one and same_outputs(eager, want),
            f"in-process graphed rollout: launches {n_want}, expected {one}; "
            f"bit-equal to its eager loop {same_outputs(eager, want)}")
    held_bundle(bundle, (aa, window0), want,
                f"bundle, one stream, {EXPORT_STEPS} steps, collect=both",
                launches=one)
    sizes = bundle_bytes(path)
    log(f"bundle export (trace + save) {export_s:.2f} s, load {load_s:.2f} "
        f"s; bytes {sizes}")
    plain = in_process()
    with torch.no_grad():
        bundle_rates(
            f"one stream, {EXPORT_STEPS} steps, one call each", {
                "bundle graphed": lambda: bundle(aa, window0),
                "bundle eager": lambda: bundle.eager(aa, window0),
                "in-process plain path graphed": lambda: plain(
                    params, aa, window0),
                "eager": lambda: plain.eager(params, aa, window0)},
            EXPORT_STEPS)

    # hot swap: seeded weights whose conv layers are alive
    live = gkn_init(live_cfg("bfloat16"), seed=1, device=dev)
    with torch.no_grad():
        want = in_process()(live, aa, window0)
    held_bundle(bundle, (aa, window0), want, "bundle with hot-swapped live "
                "weights", launches=one, params=live)
    require(not torch.equal(want[0][0], bundle(aa, window0)[0][0]),
            "hot-swapped weights gave the bundled weights' rollout")
    held_bundle(bundle, (aa, window0), in_process()(params, aa, window0),
                "the same bundle with its own weights again")

    spath, s_export = timed_call(lambda: save_bundle(
        root / "streams", params, cfg, EXPORT_STEPS, streams=EXPORT_STREAMS,
        stream_chunk=EXPORT_CHUNK, **kw))
    sbundle = load_bundle(spath, device=dev)
    with torch.no_grad():
        want = in_process(True, EXPORT_CHUNK)(params, aa, windows)
    held_bundle(sbundle, (aa, windows), want,
                f"bundle, S = {EXPORT_STREAMS} with stream_chunk "
                f"{EXPORT_CHUNK}", launches=scan_launches(
                    EXPORT_STEPS * EXPORT_STREAMS // EXPORT_CHUNK, cfg))
    log(f"S = {EXPORT_STREAMS}: export {s_export:.2f} s")
    splain = in_process(True, EXPORT_CHUNK)
    with torch.no_grad():
        bundle_rates(
            f"S = {EXPORT_STREAMS} with stream_chunk {EXPORT_CHUNK}, "
            f"{EXPORT_STEPS} steps a stream, one call each, served", {
                "bundle graphed": lambda: sbundle(aa, windows),
                "bundle eager": lambda: sbundle.eager(aa, windows),
                "in-process plain path graphed": lambda: splain(
                    params, aa, windows),
                "eager": lambda: splain.eager(params, aa, windows)},
            EXPORT_STREAMS * EXPORT_STEPS)

    # traced on the CPU, moved to the card by load_bundle
    cpath, c_export = timed_call(lambda: save_bundle(
        root / "cpu", load_params_npz(CKPT, device="cpu"), cfg,
        EXPORT_STEPS, platforms=["cpu", "cuda"], **kw))
    cbundle = load_bundle(cpath, device=dev)
    with torch.no_grad():
        want = in_process()(params, aa, window0)
    got = cbundle(aa, window0)
    require(same_outputs(cbundle.eager(aa, window0), got),
            "CPU-traced bundle on the card: its graphs differ from its "
            "eager step loop")
    exact = same_outputs(got, want)
    err = (got[0][0] - want[0][0]).abs().max().item()
    log(f"bundle traced on the CPU ({c_export:.2f} s) and moved to the "
        f"card: graphed bit-equal to its eager loop; against the in-process "
        f"rollout bit-equal {exact}, coordinates within {err:.3e} A (limit "
        f"TOL_ROLL {TOL_ROLL}), contact maps equal "
        f"{torch.equal(got[0][1], want[0][1])}")
    # the trace records the same aten ops on either device; if the card
    # ever took another kernel for one of them, f32 sums in another order
    # are what TOL_ROLL allows for
    require(exact or (err <= TOL_ROLL and torch.equal(got[0][1], want[0][1])
                      and torch.equal(got[2]["edge_overflow"],
                                      want[2]["edge_overflow"])),
            f"CPU-traced bundle on the card: {err:.3e} A")

    fcfg = fno_cfg()
    fparams = fno.fno_init(fcfg, seed=0, device=dev)
    ch0 = fno.distance_matrix_channels(
        torch.as_tensor(traj.positions[:10], device=dev))
    fpath, f_export = timed_call(lambda: save_bundle(
        root / "fno", fparams, fcfg, EXPORT_STEPS))
    fbundle = load_bundle(fpath, device=dev)
    with torch.no_grad():
        want = fno.fno_rollout_scan(fparams, fcfg, ch0, EXPORT_STEPS)
    held_bundle(fbundle, (ch0,), want,
                f"FNO bundle at the CLI defaults, {EXPORT_STEPS} steps "
                f"(export {f_export:.2f} s)", launches={})
    fother = fno.fno_init(fcfg, seed=1, device=dev)
    with torch.no_grad():
        want = fno.fno_rollout_scan(fother, fcfg, ch0, EXPORT_STEPS)
    held_bundle(fbundle, (ch0,), want, "FNO bundle with hot-swapped "
                "weights", params=fother)
    with torch.no_grad():
        bundle_rates(f"FNO bundle, {EXPORT_STEPS} steps, one call each", {
            "graphed": lambda: fbundle(ch0),
            "eager": lambda: fbundle.eager(ch0)}, EXPORT_STEPS)

    out = root / "cli"
    cmd = [sys.executable, "-m", f"{PKG}.cli.export", "--checkpoint",
           str(CKPT), "--max_edges", "224", "--predict_delta", "--clip",
           str(CLIP), "--num_steps", str(EXPORT_STEPS), "--out", str(out)]
    proc, cli_s = timed_call(lambda: subprocess.run(
        cmd, cwd=ROOT, capture_output=True, text=True, timeout=600))
    text = proc.stdout + proc.stderr
    require(proc.returncode == 0 and "selftest ok" in proc.stdout,
            f"cli.export exited {proc.returncode}:\n{text[-3000:]}")
    log(f"python -m {PKG}.cli.export ... --num_steps {EXPORT_STEPS}: "
        f"{cli_s:.1f} s in all; "
        + "; ".join(line for line in proc.stdout.splitlines()
                    if line.startswith(("bundle written", "selftest"))))
    got = dict(tree_items(load_bundle(out, device=dev).params))
    want = dict(tree_items(params))
    require(got.keys() == want.keys()
            and all(torch.equal(got[k], want[k]) for k in want),
            "the CLI bundle's weights differ from the checkpoint's")


def oracle_phi(points: np.ndarray, pos: np.ndarray, q: np.ndarray):
    """float64 potential at points from the screened charges."""
    from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
        bjerrum_length,
        debye_kappa,
    )

    p, x = points.astype(np.float64), pos.astype(np.float64)
    d2 = sum((p[:, None, k] - x[None, :, k]) ** 2 for k in range(3))
    d = np.sqrt(np.maximum(d2, 1.0))
    return bjerrum_length() * (np.exp(-debye_kappa() * d) / d) @ q.astype(
        np.float64)


def oracle_trilinear(grid: np.ndarray, origin, spacing, pos: np.ndarray):
    """float64 trilinear interpolation, positions clamped to the box."""
    g = grid.astype(np.float64)
    shape = np.asarray(grid.shape, np.float64)
    f = np.clip((pos.astype(np.float64) - origin) / spacing, 0.0,
                shape - 1.0)
    f0 = np.floor(np.minimum(f, shape - 2.0))
    t, i0 = f - f0, f0.astype(np.int64)
    out = np.zeros(len(pos))
    for c in np.ndindex(2, 2, 2):
        idx = i0 + np.asarray(c)
        w = np.prod(np.where(np.asarray(c) == 1, t, 1.0 - t), axis=-1)
        out += w * g[idx[:, 0], idx[:, 1], idx[:, 2]]
    return out


def dh_grids(tag: str, pos: np.ndarray, q: np.ndarray, dev) -> None:
    """Phase 19b for one system: ``batched_debye_huckel_grids`` of every
    frame of pos (T, N, 3) on the deck's grid, held against a float64
    oracle and the port on the CPU at a seeded sample of grid points, and
    ``sample_grid_trilinear`` at the atoms the same way."""
    from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (
        batched_debye_huckel_grids,
        debye_huckel_grid,
        make_grid,
        sample_grid_trilinear,
    )

    frames, n = pos.shape[:2]
    center = pos.mean(axis=(0, 1))
    grid = make_grid(center, DECK_LENGTHS, DECK_DIME, device=dev)
    g = grid.shape[0]
    pos_t = torch.as_tensor(pos, device=dev)
    q_t = torch.as_tensor(q, device=dev)
    batched_debye_huckel_grids(pos_t[:1], q_t, grid)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    phis, secs = timed_call(lambda: batched_debye_huckel_grids(pos_t, q_t,
                                                               grid))
    peak = torch.cuda.max_memory_allocated() - base
    ms = 1e3 * secs / frames
    bound = 1e3 * g * n * DH_SFU_PER_PAIR / SFU_PER_S
    require(phis.shape == (frames, g) and bool(torch.isfinite(phis).all()),
            f"{tag}: grids {tuple(phis.shape)} not finite")
    rng = np.random.default_rng(19)
    sample = np.sort(rng.choice(g, DH_SAMPLE, replace=False))
    grid_np = grid.cpu().numpy()
    worst = {"oracle": 0.0, "cpu": 0.0}
    for f in sorted({0, frames // 2, frames - 1}):
        scale = phis[f].abs().max().item()
        card = phis[f, torch.as_tensor(sample, device=dev)].cpu().numpy()
        oracle = oracle_phi(grid_np[sample], pos[f], q)
        cpu = debye_huckel_grid(torch.as_tensor(pos[f]), torch.as_tensor(q),
                                torch.as_tensor(grid_np[sample])).numpy()
        worst["oracle"] = max(worst["oracle"],
                              np.abs(card - oracle).max() / scale)
        worst["cpu"] = max(worst["cpu"], np.abs(card - cpu).max() / scale)
    phi3 = phis[0].reshape(DECK_DIME)
    origin = grid_np[0]
    spacing = np.asarray(DECK_LENGTHS, np.float32) / (
        np.asarray(DECK_DIME, np.float32) - 1.0)
    at_atoms = sample_grid_trilinear(phi3, origin, spacing, pos_t[0])
    cpu_atoms = sample_grid_trilinear(phi3.cpu(), origin, spacing,
                                      torch.as_tensor(pos[0]))
    oracle_atoms = oracle_trilinear(phi3.cpu().numpy(), origin, spacing,
                                    pos[0])
    scale = phi3.abs().max().item()
    tri = {"oracle": np.abs(at_atoms.cpu().numpy() - oracle_atoms).max()
           / scale,
           "cpu": (at_atoms.cpu() - cpu_atoms).abs().max().item() / scale}
    log(f"dh grids, {tag}: {frames} frames x {g:,} points x {n:,} atoms; "
        f"{ms:.3f} ms a frame (bound {bound:.3f} ms, {DH_SFU_PER_PAIR} "
        f"special-function results a pair at {SFU_PER_S:.3g}/s), peak "
        f"{peak / 1e9:.3f} GB beyond the inputs; against float64 "
        f"{worst['oracle']:.2e}, against the CPU {worst['cpu']:.2e} of max "
        f"|phi| (limit {TOL_DH}); trilinear at the {n:,} atoms "
        f"{tri['oracle']:.2e} and {tri['cpu']:.2e} (limit {TOL_TRILINEAR})")
    require(max(worst.values()) <= TOL_DH, f"{tag}: dh grid off by {worst}")
    require(max(tri.values()) <= TOL_TRILINEAR,
            f"{tag}: trilinear samples off by {tri}")


def apbs_stub_run(root: Path) -> None:
    """Phase 19b: ``cli.preprocess --mode apbs`` with stub programs in
    place of pdb2pqr30 and apbs, in a subprocess."""
    import stat

    bin_dir = root / "bin"
    bin_dir.mkdir()
    pdb2pqr, apbs = bin_dir / "stub_pdb2pqr", bin_dir / "stub_apbs"
    pdb2pqr.write_text("#!/bin/bash\ncp \"$1\" \"$2\"\n")
    apbs.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "deck = open(sys.argv[1]).read()\n"
        "stem = [l.split()[-1] for l in deck.splitlines()"
        " if l.strip().startswith('write pot dx')][0]\n"
        "lines = ['object 1 class gridpositions counts 2 2 2',\n"
        "         'object 3 class array type double rank 0 items 8 data "
        "follows', '1 2 3', '4 5 6', '7 8']\n"
        "open(stem + '.dx', 'w').write('\\n'.join(lines) + '\\n')\n")
    for f in (pdb2pqr, apbs):
        f.chmod(f.stat().st_mode | stat.S_IEXEC)
    pdb = root / "traj.pdb"
    pdb.write_text("\n".join(
        f"MODEL     {m + 1}\nATOM      1  CA  ALA A   1      {m:8.3f}   "
        "0.000   0.000  1.00  0.00\nENDMDL" for m in range(3)) + "\nEND\n")
    cmd = [sys.executable, "-m", f"{PKG}.cli.preprocess", "--mode", "apbs",
           "--pdb_files", str(pdb), "--traj_files", str(pdb),
           "--scratch_dir", str(root / "scratch"), "--results_dir",
           str(root / "results"), "--num_workers", "1", "--pdb2pqr_exe",
           str(pdb2pqr), "--apbs_exe", str(apbs)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    require(proc.returncode == 0, f"cli.preprocess --mode apbs exited "
            f"{proc.returncode}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    chunks = [np.load(p) for p in sorted((root / "results").glob("*.npy"))]
    want = np.arange(1, 9, dtype=np.float64).reshape(2, 2, 2)
    require(sum(c.shape[0] for c in chunks) == 3
            and all(np.array_equal(g, want) for c in chunks for g in c)
            and not list((root / "scratch").glob("*")),
            f"apbs stub run: chunks {[c.shape for c in chunks]}")
    log(f"cli.preprocess --mode apbs with stub programs: "
        f"{proc.stdout.strip()}; {len(chunks)} chunks, 3 frames, scratch "
        "left empty")


@contextlib.contextmanager
def plain_pipeline():
    """The input pipeline without the producer thread and the packer (the
    port's before both): numpy batches through the plain generator."""
    import functools

    from molecular_dynamics_neural_operator_tpu_torch.data import (
        packing,
        prefetch,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        loop,
        recipe,
    )

    saved = (prefetch.prefetch_to_device, loop.prefetch_to_device,
             recipe.prefetch_to_device, packing.available)
    plain = functools.partial(saved[0], producer_thread=False)
    prefetch.prefetch_to_device = loop.prefetch_to_device = plain
    recipe.prefetch_to_device = plain
    packing.available = lambda: False
    try:
        yield
    finally:
        (prefetch.prefetch_to_device, loop.prefetch_to_device,
         recipe.prefetch_to_device, packing.available) = saved


def host_pipeline(traj, root: Path) -> None:
    """Phase 19c: the native packer's batches against the numpy path's,
    and a CLI epoch with the producer thread and the packer against the
    same epoch without them."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        packing,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )

    require(packing.available(), "the native packer did not build: "
            f"{packing.load_error()}")
    rng = np.random.default_rng(19)
    for mode in ("sparse", "dense"):
        kw = dict(window_size=10, graph_mode=mode, max_edges=256)
        native = WindowDataset(traj, **kw)
        plain = WindowDataset(traj, use_native=False, **kw)
        require(native.use_native, f"{mode}: the dataset took the numpy path")
        batches = [rng.permutation(len(native))[:TRAIN_BATCH]
                   for _ in range(4)]
        for idx in batches:
            a, b = native.get_batch(idx), plain.get_batch(idx)
            require(a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in a), f"{mode}: native batch differs from numpy")
        ms = {}
        for name, ds in (("native", native), ("numpy", plain)):
            t0 = time.perf_counter()
            for idx in batches:
                ds.get_batch(idx)
            ms[name] = 1e3 * (time.perf_counter() - t0) / len(batches)
        log(f"{mode} batches of {TRAIN_BATCH}: the native packer equals the "
            f"numpy path bit for bit; host ms a batch: native "
            f"{ms['native']:.3f}, numpy {ms['numpy']:.3f}")

    tr_idx, _ = train_valid_split(len(traj.positions) - 10)
    steps = len(tr_idx) // TRAIN_BATCH
    extra = ["--train_conv_impl", "xla"]

    def beyond(row) -> float:
        return row["seconds"] - steps / row["steps_per_sec"]

    cli_train_run(traj, root / "warm", extra)
    with plain_pipeline():
        _, _, prow, _ = cli_train_run(traj, root / "plain", extra)
    _, _, trow, _ = cli_train_run(traj, root / "thread", extra)
    rel = abs(trow["avg_train_loss"] - prow["avg_train_loss"]) / abs(
        prow["avg_train_loss"])
    log(f"cli.train epoch (per-layer path, B = {TRAIN_BATCH}, {steps} "
        f"steps): with the producer thread and the packer "
        f"{trow['seconds']:.3f} s, {beyond(trow):.3f} s beyond the steps, "
        f"{trow['steps_per_sec']:.2f} steps/s; without them "
        f"{prow['seconds']:.3f} s, {beyond(prow):.3f} s beyond, "
        f"{prow['steps_per_sec']:.2f} steps/s (before the thread and the "
        f"packer: 0.5 to 0.9 s beyond the steps); mean rel_l2 {trow['avg_train_loss']:.6g} and "
        f"{prow['avg_train_loss']:.6g}, {rel:.2e} relative (limit "
        f"{TOL_TRAIN_LOSS})")
    require(rel <= TOL_TRAIN_LOSS, f"the epoch through the producer thread "
            f"differs from the plain pipeline's by {rel:.2e}")


def export_phase(traj) -> dict:
    """Phase 19; of the kernels only the hand-written edge MLP lies on its
    path, three launches a bf16 step of a flagship bundle."""
    import tempfile

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    reset_all_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        root = Path(tmp)
        export_bundles(traj, root / "bundles")
        from molecular_dynamics_neural_operator_tpu_torch.preprocess.grid import (  # noqa: E501
            AMINO_ACID_CHARGES,
        )

        dh_grids("BBA (synthetic)", traj.positions[:DH_FRAMES],
                 AMINO_ACID_CHARGES[traj.aminoacids % 20], dev)
        large = breathing_trajectory(serpentine_grid(LARGE_N, 4.0),
                                     DH_LARGE_FRAMES)
        dh_grids("config 5 (10,000 atoms)", large,
                 AMINO_ACID_CHARGES[np.arange(LARGE_N) % 20], dev)
        (root / "apbs").mkdir()
        apbs_stub_run(root / "apbs")
        host_pipeline(traj, root / "runs")
    counts = all_launches()
    require_hand_mlp_only(counts, "the export path")
    log(f"export, preprocessing and host-pipeline path launches: {counts}, "
        f"every edge_mlp launch a bf16 step's kernel tensor; the phase "
        f"took {time.perf_counter() - t0:.1f} s")
    return {}


# ---- phase 20: the parallel modules ---------------------------------------

# By default two ranks share the one card through gloo (NCCL refuses two
# ranks on one GPU), so every collective goes through the host; one more
# rank runs alone on NCCL. ``--ranks N`` on a machine with N cards gives
# every rank its own card, on NCCL. Each spawn is joined with its own
# deadline.
PAR_WORLD = 2
PAR_STREAMS = 8
PAR_TIMEOUT = 900  # seconds for the two-rank spawn, then every rank ends
PAR_NCCL_TIMEOUT = 300
PAR_HORIZONS = (7, 64, 100, 300)
PAR_NOISE = 0.01  # the graphed data-parallel teacher step's input noise


class _Recorder:
    """An optimizer whose update is zero and whose state becomes the
    gradients it was given: after one step ``state.opt_state`` holds the
    step's reduced gradients."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
            tree_map,
        )

        return tree_map(torch.zeros_like, params), grads


class _CommClock:
    """Within the block, the host seconds spent in the parallel modules'
    collectives (``parallel/comm.py``), each timed from a synchronized
    device to a synchronized device."""

    def __enter__(self):
        from molecular_dynamics_neural_operator_tpu_torch.parallel import comm

        self.module, self.seconds, self.calls = comm, 0.0, 0
        self.saved = {n: getattr(comm, n)
                      for n in ("all_reduce", "all_gather", "broadcast")}

        def timed(fn):
            def run(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls += 1
                return out
            return run

        for n, fn in self.saved.items():
            setattr(comm, n, timed(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)


def _par_state(cfg, tcfg, params, record: bool):
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    state, adam, _ = create_train_state(tcfg.seed, cfg, tcfg, params=params,
                                        device="cuda")
    if not record:
        return state, adam
    tx = _Recorder()
    return TrainState(state.params, tx.init(state.params), 0,
                      state.rng), tx


def _par_step_pair(tag, cfg, tcfg, params, host, mesh, make_sharded,
                   make_single, want_launches) -> dict:
    """Phase 20a/b: the sharded step on this rank's rows of ``host``
    against the single-process step on all of it, from the same
    parameters: the loss, every gradient leaf and each leaf's Adam
    movement within the TOL_TRAIN_* tolerances, the ranks' parameters bit
    equal, exact launch counts of the sharded step; then wall and device
    ms of both steps issued op by op. The sharded step runs eagerly on a
    gloo group and replays graphs on NCCL (``step_stays_eager``); the
    gradients are read through its body (``step.eager``), whose recorder
    state is no optimizer state a graph holds."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        train_conv as tc,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        replicas_equal,
    )
    import torch.distributed as dist

    group = mesh.get_group("data")
    backend = dist.get_backend(group)
    full = to_device(host, "cuda")
    res = {}
    runs = {}
    for kind in ("grads", "adam"):
        for sharded in (True, False):
            state, tx = _par_state(cfg, tcfg, params, kind == "grads")
            step, put = make_sharded(tx) if sharded else (make_single(tx),
                                                          None)
            if sharded:
                res["graphed"] = step.graphed is not None
                require(res["graphed"] == (backend == "nccl"),
                        f"{tag}: on {backend} the step "
                        + ("replays graphs" if res["graphed"]
                           else "runs eagerly"))
                if kind == "grads":
                    step = step.eager
            batch = put(host) if sharded else full
            tc.reset_launch_counts()
            new, m = step(state, batch)
            torch.cuda.synchronize()
            counts = tc.launch_counts()
            if sharded:
                require(replicas_equal(new.params, group)
                        and (kind == "adam"
                             or replicas_equal(new.opt_state, group)),
                        f"{tag}: the ranks' {kind} differ after the step")
                if kind == "adam":
                    res["launches"] = counts
                    require(counts == want_launches,
                            f"{tag}: launches {counts}, expected "
                            f"{want_launches} on each rank")
            runs[kind, sharded] = (state, new, {k: float(v)
                                                for k, v in m.items()})
    (_, g_sh, m_sh), (_, g_1, m_1) = runs["grads", True], runs["grads", False]
    worst_g = 0.0
    for (name, a), (_, b) in zip(tree_items(g_sh.opt_state),
                                 tree_items(g_1.opt_state)):
        require(bool(torch.isfinite(a).all()), f"{tag}: grad {name} not "
                "finite")
        rel = (a - b).norm().item() / max(b.norm().item(), 1e-30)
        worst_g = max(worst_g, rel)
        require(rel <= TOL_TRAIN_MOVE, f"{tag}: gradient {name} differs by "
                f"{rel:.3e} of its norm from the single-process step's")
    state0, new_sh, ms = runs["adam", True]
    _, new_1, m1 = runs["adam", False]
    worst, worst_name, moved, max_abs = compare_training_runs(
        state0, (new_sh, ms), (new_1, m1), tag)
    res.update(loss=ms["rel_l2"], loss_single=m1["rel_l2"],
               grad_gap=worst_g, move_gap=worst, move_leaf=worst_name)

    # timing: the sharded step on every rank at once, the single-process
    # step on rank 0 alone
    state, tx = _par_state(cfg, tcfg, params, False)
    step, put = make_sharded(tx)
    step = step.eager  # the collectives timed one by one
    batch = put(host)
    with _CommClock() as clock:
        res["wall_ms"] = wall_ms(step, state, batch)
    res["comm_ms"] = clock.seconds / 7 * 1e3  # wall_ms runs 1 + 6 steps
    if dist.get_rank() == 0:
        res["device_ms"] = profile_step(step, state, batch, res["wall_ms"],
                                        f"{tag} (sharded, rank 0)")
    else:
        for _ in range(4):  # profile_step's steps, for the collectives
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    dist.barrier()
    if dist.get_rank() == 0:
        state, tx = _par_state(cfg, tcfg, params, False)
        single = make_single(tx)
        res["single_wall_ms"] = wall_ms(single, state, full)
        res["single_device_ms"] = profile_step(
            single, state, full, res["single_wall_ms"],
            f"{tag} (single process, rank 0 alone)")
    dist.barrier()
    return res


def _par_training(mesh, traj) -> dict:
    """Phase 20a and b at the flagship's training shapes (bf16, the
    training kernels, B = 128 split over the ranks)."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_sharded_curriculum_train_step,
        make_sharded_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        make_train_step,
        train_valid_split,
    )

    cfg, tcfg = training_cfgs()
    ds = WindowDataset(traj, window_size=cfg.window_size,
                       graph_mode="sparse", max_edges=cfg.max_edges)
    idx = train_valid_split(len(ds))[0][:TRAIN_BATCH]
    params = gkn_init(cfg, seed=0, device="cuda")
    out = {"teacher": _par_step_pair(
        "data-parallel teacher step", cfg, tcfg, params, ds.get_batch(idx),
        mesh, lambda tx: make_sharded_train_step(cfg, tx, mesh),
        lambda tx: make_train_step(cfg, tx).eager,
        {"train_conv_fwd": 1, "train_conv_bwd": 1})}
    kw = dict(rollout_steps=CURRICULUM_K, coord_clip=CURRICULUM_CLIP,
              loss_space="delta")
    out["curriculum"] = _par_step_pair(
        f"data-parallel K={CURRICULUM_K} delta curriculum step", cfg, tcfg,
        params, ds.get_batch(idx, rollout_horizon=CURRICULUM_K), mesh,
        lambda tx: make_sharded_curriculum_train_step(cfg, tx, mesh, **kw),
        lambda tx: curriculum_step(cfg, tx, None).eager,
        {"train_conv_fwd": CURRICULUM_K, "train_conv_bwd": CURRICULUM_K})
    return out


def _par_busy_ms(call, calls: int = 3):
    """Rank 0's device busy ms a ``call()`` (``torch.profiler`` over
    ``calls`` calls after one more), while every other rank makes the
    same calls, so that their collectives meet; None on the other
    ranks. An NCCL kernel's time includes its wait for the other ranks."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    if dist.get_rank() != 0:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / calls


def _par_graph_times(step, state, batch) -> dict:
    """Wall ms of a multi-rank step graphed and issued op by op
    (``step.eager``), on every rank at once, two runs of 10 steps each in
    turns; rank 0's device busy ms a step issued op by op (the kernels a
    replay launches) and over graph replays (None where the profiler
    records none)."""
    walls = {}
    for form in ("graphed", "eager", "graphed ", "eager "):
        run = step if form.strip() == "graphed" else step.eager
        walls[form] = wall_ms(run, state, batch, n=10)

    def stepping(run):
        box = [state]

        def call():
            box[0], _ = run(box[0], batch)
        return call

    return {"graphed_ms": [walls["graphed"], walls["graphed "]],
            "eager_ms": [walls["eager"], walls["eager "]],
            "busy_ms": _par_busy_ms(stepping(step.eager)),
            "replay_busy_ms": _par_busy_ms(stepping(step)) or None}


def _par_graphed(traj) -> dict:
    """Phase 20g, on ranks with a card each (NCCL): at the flagship's
    width (bf16, B = 128 over the ranks) the data-parallel teacher step
    (input noise PAR_NOISE), the K = 4 delta curriculum step and the FNO
    step over the "data" axis, and the edge-sharded step over a ("data",
    "model") mesh, each graphed (its collectives inside the graph)
    against its body issued op by op over TRAIN_STEPS batches from one
    state, a NaN in rank 0's rows of one (``hold_graphed_steps``): the
    data-parallel steps equal to the bit; the edge-sharded step, whose
    segment sums add by atomics (``scatter_add``) and so differ between
    two eager runs as well, within the training limits, with bitwise
    equality and the two eager runs' reported; the NaN batch leaving
    every rank's state as it was; the ranks' states bit-equal after; then
    ``_par_graph_times``. Returns each step's record with the graphed
    steps' launches."""
    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        MeshConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.geometry.contact import (
        edge_features_from_edges,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import fno
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_data_parallel_step,
        make_edge_sharded_train_step,
        make_mesh,
        make_sharded_curriculum_train_step,
        make_sharded_train_step,
        replicas_equal,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    world = dist.get_world_size()
    cfg, tcfg = training_cfgs()
    tcfg = dataclasses.replace(tcfg, skip_nonfinite_updates=True)
    ds = WindowDataset(traj, window_size=cfg.window_size,
                       graph_mode="sparse", max_edges=cfg.max_edges)
    idx = train_valid_split(len(ds))[0]
    nan_at = TRAIN_STEPS // 2

    def hosts(k=0):
        out = [ds.get_batch(idx[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                            rollout_horizon=k) for i in range(TRAIN_STEPS)]
        window = out[nan_at]["window"].copy()
        window[3, 2, 5, 1] = np.nan  # a row of rank 0's
        out[nan_at]["window"] = window
        return out

    out = {}

    def hold(name, step, state0, batches, expect, bitwise=True):
        tag = f"{name} over {world} NCCL ranks"
        require(step.graphed is not None, f"{tag}: the step stays eager")
        held = hold_graphed_steps(tag, step, state0, batches, nan_at, expect)
        require(held["bitwise"] or not bitwise,
                f"{tag}: graphed and eager steps differ")
        final = held["state"]
        require(all(replicas_equal(t, dist.group.WORLD) for t in (
            final.params, final.opt_state.mu, final.opt_state.nu)),
                f"{tag}: the ranks' parameters or moments differ")
        require(len(step.graphed.graphs) == 1,
                f"{tag}: {len(step.graphed.graphs)} graphs captured")
        rec = {"launches": held["launches"], "bitwise": held["bitwise"],
               "loss_gap": held["loss"], "move_gap": held["move"]}
        if not bitwise:
            (a, _), (b, _) = (step.eager(state0, batches[0]) for _ in "ab")
            rec["eager_repeats"] = train_states_equal(a, b)
        rec.update(_par_graph_times(step, state0, batches[0]))
        out[name] = rec

    data = make_mesh(MeshConfig())
    state0, tx, _ = create_train_state(0, cfg, tcfg)
    step, put = make_sharded_train_step(cfg, tx, data, noise_std=PAR_NOISE)
    hold("data-parallel teacher step", step, state0,
         [put(h) for h in hosts()],
         {"train_conv_fwd": 1, "train_conv_bwd": 1})

    state0, tx, _ = create_train_state(0, cfg, tcfg)
    step, put = make_sharded_curriculum_train_step(
        cfg, tx, data, rollout_steps=CURRICULUM_K,
        coord_clip=CURRICULUM_CLIP, loss_space="delta")
    hold(f"data-parallel K={CURRICULUM_K} curriculum step", step, state0,
         [put(h) for h in hosts(CURRICULUM_K)],
         {"train_conv_fwd": CURRICULUM_K, "train_conv_bwd": CURRICULUM_K})

    fcfg = fno_cfg()
    ftx, _ = make_optimizer(lr=1e-3, skip_nonfinite_updates=True)
    params = fno.fno_init(fcfg, seed=0, device="cuda")
    step, put = make_data_parallel_step(fno.fno_window_loss(fcfg), ftx,
                                        data, name="FNO step")
    hold("data-parallel FNO step", step,
         TrainState(params, ftx.init(params), 0, 0),
         [put(h) for h in hosts()], {})

    model = 2 if world % 2 == 0 else 1
    mesh = make_mesh(MeshConfig(data=world // model, model=model))
    state0, tx, _ = create_train_state(0, cfg, tcfg)
    edge_step = make_edge_sharded_train_step(cfg, tx, mesh)

    def arrays(host):
        t = to_device(host, "cuda")  # the global arrays, on every rank
        return (t["aa"], t["window"], t["edges"], t["mask"],
                edge_features_from_edges(t["window"][:, 0], t["edges"]),
                t["y"])

    def step(state, batch):
        return edge_step(state, *batch)

    step.eager = lambda state, batch: edge_step.eager(state, *batch)
    step.graphed = edge_step.graphed
    hold(f"edge-sharded step ({world // model} x {model})", step, state0,
         [arrays(h) for h in hosts()], {}, bitwise=False)
    return out


def _par_windows(traj, cd):
    t = bench_cfg(cd).window_size
    return torch.as_tensor(np.stack([traj.positions[i * 400:i * 400 + t]
                                     for i in range(PAR_STREAMS)]),
                           device="cuda")


def _par_rollout(mesh, traj) -> dict:
    """Phase 20d: S = 8 streams over the ranks with the bench
    checkpoint and the fused kernel, 128 steps, against the unsharded
    rollout of all eight: f32 within TOL_ROLL with the same edge lists at
    every step of every stream, bf16 within the tolerance of phase 9c
    (another stream count may round a plain product otherwise: TOL_HEAD_BF16
    of a step's largest movement, per step); bit-equality reported."""
    import dataclasses as dc

    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        gather_streams,
        make_sharded_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    params = load_params_npz(CKPT, "cuda")
    aa = torch.as_tensor(traj.aminoacids, device="cuda")
    out = {}
    for cd in ("float32", "bfloat16"):
        cfg = dc.replace(bench_cfg(cd), conv_impl="pallas")
        w0 = _par_windows(traj, cd)
        roll = make_sharded_rollout_fn(cfg, mesh, STEPS, THRESHOLD, clip=CLIP)
        with torch.no_grad():
            start = fused_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            local, _, diags = roll(params, aa, w0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_launches() - start
            coords = gather_streams(mesh, local)
        require(launches > 0, f"sharded rollout {cd}: the fused kernel "
                "never launched")
        require(bool(torch.isfinite(coords).all())
                and not bool(diags["edge_overflow"]),
                f"sharded rollout {cd}: not finite or overflowed")
        rec = dict(launches=launches, steps_per_s=STEPS * PAR_STREAMS / wall,
                   local_streams=int(local.shape[0]))
        if dist.get_rank() == 0:  # the others wait: the reference runs alone
            with torch.no_grad():
                t0 = time.perf_counter()
                ref, _, ref_diags = make_rollout_fn(
                    cfg, STEPS, THRESHOLD, batched=True, clip=CLIP,
                    device="cuda")(params, aa, w0)
                torch.cuda.synchronize()
                wall_1 = time.perf_counter() - t0
            require(not bool(ref_diags["edge_overflow"].any()),
                    f"unsharded rollout {cd} overflowed")
            err = (coords - ref).abs().max().item()
            differing = sum(same_edge_lists(w0[i], coords[i], ref[i])
                            for i in range(PAR_STREAMS))
            if cd == "float32":
                require(differing == 0 and err <= TOL_ROLL,
                        f"sharded rollout f32: {differing} steps with other "
                        f"edge lists, error {err} A > {TOL_ROLL}")
            else:
                move = torch.cat([w0[:, -1:], ref], dim=1).diff(
                    dim=1).abs().max().item()
                tol = TOL_HEAD_BF16 * STEPS * move
                require(err <= tol, f"sharded rollout bf16: error {err} A "
                        f"> {tol}")
            rec.update(err=err, bit_equal=bool(torch.equal(coords, ref)),
                       differing_steps=differing,
                       single_steps_per_s=STEPS * PAR_STREAMS / wall_1)
        dist.barrier()
        out[cd] = rec
    return out


def _par_server(mesh, traj) -> dict:
    """Phase 20e: eight requests of mixed horizons, one sequence each,
    through a ``RolloutServer`` whose streams spread over the ranks (f32,
    the bench checkpoint, the fused kernel), each held against a
    dedicated single-stream rollout: within TOL_ROLL with the same edge
    lists (``hold_result``)."""
    import dataclasses as dc

    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving.server import (
        serve_follower,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    cfg = dc.replace(bench_cfg("float32"), conv_impl="pallas")
    params = load_params_npz(CKPT, "cuda")
    opts = dict(segment_steps=SEGMENT, threshold=THRESHOLD, clip=CLIP)
    start = fused_launches()
    if dist.get_rank() > 0:
        serve_follower(params, cfg, mesh, device="cuda", **opts)
        return {"launches": fused_launches() - start}
    t_len, aa_np = cfg.window_size, np.asarray(traj.aminoacids)
    requests = [((aa_np + 3 * i) % 20, traj.positions[j:j + t_len], n)
                for i, (j, n) in enumerate(
                    (300 * k, PAR_HORIZONS[k % 4]) for k in range(8))]
    with RolloutServer(params, cfg, max_streams=PAR_STREAMS, impl="scan",
                       mesh=mesh, device="cuda", **opts) as srv:
        t0 = time.perf_counter()
        results = [f.result(timeout=600) for f in srv.submit_many(requests)]
        wall = time.perf_counter() - t0
        stats = srv.stats
    launches = fused_launches() - start
    worst = 0.0
    with torch.no_grad():
        for i, ((a, w0, n), res) in enumerate(zip(requests, results)):
            w0 = torch.as_tensor(w0, device="cuda")
            ref, _, _ = make_rollout_fn(cfg, n, THRESHOLD, clip=CLIP,
                                        device="cuda")(
                params, torch.as_tensor(a, device="cuda"), w0)
            worst = max(worst, hold_result(res, w0, ref, TOL_ROLL,
                                           f"mesh server request {i}"))
    served = sum(n for _, _, n in requests)
    require(stats["requests_completed"] == 8
            and stats["steps_served"] == served
            and stats["steps_computed"] % dist.get_world_size() == 0,
            f"mesh server stats {stats}")
    return {"launches": launches, "err": worst, "stats": stats,
            "served_steps_per_s": served / wall}


def _par_edge(traj) -> dict:
    """Phase 20f: SOLVATED_10K with phase 17's settings, its edges over
    the ranks (the "model" axis) and the cell list rebuilt by atom
    slice, against phase 17's single-process rollout of the same weights
    and grid: 16 bf16 steps within phase 9c's per-step tolerance (the
    shards' products round over other row counts) and 4 f32 steps within
    TOL_F32 of the coordinates' scale; then a step's wall ms and the part
    spent in the collectives, beside the single-process step."""
    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        MeshConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        make_edge_sharded_rollout_fn,
        make_mesh,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    mesh = make_mesh(MeshConfig(data=1, model=dist.get_world_size()))
    aa = torch.as_tensor(np.random.default_rng(1).integers(0, 20, LARGE_N),
                         device="cuda")
    out = {}
    for cd, steps in (("bfloat16", LARGE_STEPS), ("float32",
                                                   LARGE_F32_STEPS)):
        cfg = solvated_cfg(cd)
        params = gkn.gkn_init(cfg, seed=0, device="cuda")
        grid = torch.as_tensor(breathing_trajectory(
            serpentine_grid(LARGE_N, 4.0), cfg.window_size), device="cuda")
        ref = None
        if dist.get_rank() == 0:  # the others wait: it runs alone
            with torch.no_grad():
                ref, _, _ = make_rollout_fn(cfg, steps, THRESHOLD,
                                            clip=CURRICULUM_CLIP,
                                            device="cuda")(params, aa, grid)
            torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        roll = make_edge_sharded_rollout_fn(cfg, mesh, steps, THRESHOLD,
                                            clip=CURRICULUM_CLIP)
        coords, _, diags = roll(params, aa, grid)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(bool(torch.isfinite(coords).all()),
                f"edge-sharded 10k rollout {cd}: not finite")
        rec = {"peak_gb": peak, "overflow": bool(diags["edge_overflow"])}
        if ref is not None:
            err = (coords - ref).abs().max().item()
            if cd == "float32":
                tol = TOL_F32 * ref.abs().max().item()
            else:
                move = torch.cat([grid[-1:], ref]).diff(
                    dim=0).abs().max().item()
                tol = TOL_HEAD_BF16 * steps * move
            require(err <= tol, f"edge-sharded 10k rollout {cd}: error "
                    f"{err} A > {tol} against the single-process rollout")
            rec.update(err=err, tol=tol,
                       bit_equal=bool(torch.equal(coords, ref)))
            del ref
        if cd == "bfloat16":
            one = make_edge_sharded_rollout_fn(cfg, mesh, 1, THRESHOLD,
                                               clip=CURRICULUM_CLIP)
            one(params, aa, grid)
            torch.cuda.synchronize()
            with _CommClock() as clock:
                t0 = time.perf_counter()
                for _ in range(3):
                    one(params, aa, grid)
                torch.cuda.synchronize()
                rec["step_ms"] = (time.perf_counter() - t0) / 3 * 1e3
            rec["comm_ms"] = clock.seconds / 3 * 1e3
            rec["collectives"] = clock.calls // 3
            # the cell list stays eager (step_stays_eager): how busy it
            # keeps rank 0's card, against a step's wall time unclocked
            t0 = time.perf_counter()
            for _ in range(3):
                one(params, aa, grid)
            torch.cuda.synchronize()
            rec["wall_ms"] = (time.perf_counter() - t0) / 3 * 1e3
            rec["busy_ms"] = _par_busy_ms(lambda: one(params, aa, grid))
            dist.barrier()
            if dist.get_rank() == 0:
                single = make_rollout_fn(cfg, 1, THRESHOLD,
                                         clip=CURRICULUM_CLIP, device="cuda")
                with torch.no_grad():
                    rec["single_step_ms"] = event_ms(
                        lambda: single(params, aa, grid))
            dist.barrier()
        del params, grid, coords
        torch.cuda.empty_cache()
        out[cd] = rec
    return out


def _par_rank(rank, world, rdzv, out_dir) -> dict:
    """One of the ranks of phases 20a, b, d, e and f: gloo where ranks
    outnumber the cards (the default: two on one), else NCCL, which also
    runs phase 20g."""
    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        MeshConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        synthetic_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
    )

    dev = init_distributed("cuda", init_method=f"file://{rdzv}", rank=rank,
                           world_size=world)
    cards = torch.cuda.device_count()
    want = "gloo" if world > cards else "nccl"
    require(dist.get_backend() == want
            and dev == torch.device("cuda", rank % cards),
            f"{world} ranks on {cards} cards: rank {rank} took "
            f"{dist.get_backend()} on {dev}")
    mesh = make_mesh(MeshConfig())
    traj = synthetic_trajectory(num_frames=4000, num_residues=28, seed=13)
    res = {"backend": dist.get_backend(), "device": str(dev)}
    res.update(_par_training(mesh, traj))
    if res["backend"] == "nccl":
        res["graphed"] = _par_graphed(traj)
    res["rollout"] = _par_rollout(mesh, traj)
    res["server"] = _par_server(mesh, traj)
    res["edge"] = _par_edge(traj)
    return res


def _par_nccl_rank(rank, world, rdzv, out_dir) -> dict:
    """Phase 20c: one rank alone on NCCL: an all-reduce on the card; a
    CUDA graph holding one raw ``dist.all_reduce`` (``parallel/comm.py``
    sends nothing on a group of one, so this is the check that the card's
    torch captures NCCL) replayed on new inputs against the same ops
    issued eagerly; the data-parallel teacher step at B = 128 against the
    plain step, bit for bit; then the graphed data-parallel teacher
    (input noise PAR_NOISE) and K = 4 steps against their bodies issued
    op by op, over TRAIN_STEPS batches with a NaN in one
    (``hold_graphed_steps``), equal to the bit. Returns the training
    kernels' launches of the graphed steps' replays."""
    import torch.distributed as dist

    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
        capture,
    )

    from molecular_dynamics_neural_operator_tpu_torch.configs import (
        MeshConfig,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        synthetic_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_sharded_curriculum_train_step,
        make_sharded_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
        train_valid_split,
    )

    dev = init_distributed("cuda", init_method=f"file://{rdzv}", rank=rank,
                           world_size=world)
    require(dist.get_backend() == "nccl", f"one rank on its own card took "
            f"{dist.get_backend()}")
    t = torch.arange(4.0, device=dev)
    dist.all_reduce(t)
    require(torch.equal(t, torch.arange(4.0, device=dev)),
            "NCCL all-reduce of one rank changed its tensor")
    x = torch.arange(8.0, device=dev)

    def reduced():
        y = x * 2.0
        dist.all_reduce(y)
        return y + 1.0

    captured, out = capture(reduced, "one NCCL all-reduce", warmup=reduced)
    x.copy_(torch.linspace(-3.0, 5.0, 8, device=dev))
    captured.replay()
    require(torch.equal(out, reduced()) and not torch.equal(
        out, torch.arange(8.0, device=dev) * 2.0 + 1.0),
            "a captured NCCL all-reduce replayed on new inputs differs from "
            "the same ops issued eagerly")
    mesh = make_mesh(MeshConfig())
    traj = synthetic_trajectory(num_frames=4000, num_residues=28, seed=13)
    cfg, tcfg = training_cfgs()
    ds = WindowDataset(traj, window_size=cfg.window_size,
                       graph_mode="sparse", max_edges=cfg.max_edges)
    host = ds.get_batch(train_valid_split(len(ds))[0][:TRAIN_BATCH])
    params = gkn_init(cfg, seed=0, device=dev)
    runs = []
    for sharded in (True, False):
        state, tx = _par_state(cfg, tcfg, params, False)
        if sharded:
            step, put = make_sharded_train_step(cfg, tx, mesh)
            batch = put(host)
        else:
            step, batch = make_train_step(cfg, tx).eager, to_device(host, dev)
        runs.append(step(state, batch))
    (new_sh, m_sh), (new_1, m_1) = runs
    for (name, a), (_, b) in zip(tree_items(new_sh.params),
                                 tree_items(new_1.params)):
        require(torch.equal(a, b), f"NCCL world-1 step: {name} differs "
                "from the plain step's")
    require(all(torch.equal(m_sh[k], m_1[k]) for k in ("rel_l2", "mse")),
            "NCCL world-1 step: metrics differ from the plain step's")

    tcfg = dataclasses.replace(tcfg, skip_nonfinite_updates=True)
    nan_at = TRAIN_STEPS // 2
    idx = train_valid_split(len(ds))[0]
    launches = {}
    for name, k, noise in (("teacher", 0, PAR_NOISE),
                           (f"K={CURRICULUM_K}", CURRICULUM_K, 0.0)):
        state0, tx, _ = create_train_state(0, cfg, tcfg)
        if k:
            step, put = make_sharded_curriculum_train_step(
                cfg, tx, mesh, rollout_steps=k, coord_clip=CURRICULUM_CLIP,
                loss_space="delta")
        else:
            step, put = make_sharded_train_step(cfg, tx, mesh,
                                                noise_std=noise)
        require(step.graphed is not None, f"NCCL world-1 {name} step runs "
                "eagerly")
        batches = [put(ds.get_batch(idx[i * TRAIN_BATCH:
                                        (i + 1) * TRAIN_BATCH],
                                    rollout_horizon=k))
                   for i in range(TRAIN_STEPS)]
        batches[nan_at]["window"][3, 2, 5, 1] = float("nan")
        per = max(k, 1)
        held = hold_graphed_steps(
            f"NCCL world-1 data-parallel {name} step, B={TRAIN_BATCH} bf16"
            + (f", noise {noise}" if noise else ""), step, state0, batches,
            nan_at, {"train_conv_fwd": per, "train_conv_bwd": per})
        require(held["bitwise"], f"NCCL world-1 {name} step: graphed and "
                "eager steps differ")
        for kname, n in held["launches"].items():
            launches[kname] = launches.get(kname, 0) + n
    return {"backend": dist.get_backend(), "bit_equal": True,
            "captured_all_reduce": True, "graphed_launches": launches}


def _par_worker(rank, world, rdzv, out_dir, which):
    """A spawned rank: runs its part, writes ``rank<r>.json`` (or
    ``rank<r>.err`` with the traceback) and leaves the process group."""
    import os
    import traceback

    import torch.distributed as dist

    out_dir = Path(out_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    QUIET["on"] = rank > 0
    try:
        fn = _par_rank if which == "ranks" else _par_nccl_rank
        res = fn(rank, world, rdzv, out_dir)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:  # noqa: BLE001: the parent reports it
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)  # the other rank may wait on this one
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _par_spawn(which: str, world: int, timeout: float) -> list:
    """Spawn ``world`` ranks of ``which`` and join them by a deadline;
    returns each rank's results or raises with a failing rank's
    traceback."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        out = Path(tmp)
        ctx = mp.start_processes(_par_worker,
                                 args=(world, str(out / "rdzv"), str(out),
                                       which),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while True:
                if time.monotonic() > deadline:
                    alive = [r for r, p in enumerate(ctx.processes)
                             if p.is_alive()]
                    failed = (f"ranks {alive} still running after "
                              f"{timeout} s")
                    break
                try:
                    if ctx.join(timeout=1.0):
                        break
                except (mp.ProcessExitedException,
                        mp.ProcessRaisedException) as e:
                    failed = str(e)
                    break
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
        errs = [f"{p.stem.replace('rank', 'rank ')} failed:\n"
                + p.read_text() for p in sorted(out.glob("rank*.err"))]
        require(not errs and failed is None,
                f"phase 20's {which} failed: {failed}\n" + "\n".join(errs))
        return [json.loads((out / f"rank{r}.json").read_text())
                for r in range(world)]


def parallel_phase(traj, world: int = PAR_WORLD) -> dict:
    """Phase 20: the parallel modules on ``world`` ranks (two gloo ranks
    sharing the card by default) and one NCCL rank alone. Returns the
    launches of the ranks' main paths, summed."""
    import gc

    t0 = time.perf_counter()
    # the earlier phases' cached blocks stay reserved by this process
    # unless released: the ranks share this card's memory with it
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 1e9
    log(f"parallel: this process keeps {held:.2f} GB reserved while its "
        f"ranks run")
    ranks = _par_spawn("ranks", world, PAR_TIMEOUT)
    how = f"{world} {ranks[0]['backend']} ranks on " + (
        "one card" if world > torch.cuda.device_count() else "their own cards")
    nccl = _par_spawn("nccl", 1, PAR_NCCL_TIMEOUT)[0]
    counts = {"train_conv_fwd": 0, "train_conv_bwd": 0,
              "fused_edge_conv_stack": 0}
    for name, n in nccl["graphed_launches"].items():
        counts[name] += n
    for r, res in enumerate(ranks):
        for path in ("teacher", "curriculum"):
            for name, n in res[path]["launches"].items():
                counts[name] += n
        for rec in res.get("graphed", {}).values():
            for name, n in rec["launches"].items():
                counts[name] += n
        n_fused = (res["rollout"]["bfloat16"]["launches"]
                   + res["server"]["launches"])
        require(n_fused > 0, f"rank {r}: the fused kernel never launched")
        counts["fused_edge_conv_stack"] += n_fused
        log(f"parallel rank {r} ({res['backend']} on {res['device']}): "
            f"launches teacher {res['teacher']['launches']}, curriculum "
            f"{res['curriculum']['launches']}, fused kernel (rollout "
            f"{res['rollout']['bfloat16']['launches']}, server "
            f"{res['server']['launches']})")
    r0 = ranks[0]
    for path in ("teacher", "curriculum"):
        p = r0[path]
        log(f"data-parallel {path} step, B={TRAIN_BATCH} as {world} x "
            f"{TRAIN_BATCH // world} bf16 on the training kernels, {how}: "
            + ("replays CUDA graphs (NCCL)" if p["graphed"] else
               "runs op by op by ops/cuda/graphs.py::step_stays_eager (a "
               "gloo group)")
            + f"; loss {p['loss']:.6g} (single process "
            f"{p['loss_single']:.6g}); gradient leaves within "
            f"{p['grad_gap']:.3e} of their norms, Adam movement within "
            f"{p['move_gap']:.3e} (at {p['move_leaf']}; tolerance "
            f"{TOL_TRAIN_MOVE}); ranks bit-equal; issued op by op a step "
            f"{p['wall_ms']:.2f} ms wall ({p['comm_ms']:.2f} ms of it in the "
            f"reduction), {p['device_ms']:.2f} ms device on rank 0; single "
            f"process {p['single_wall_ms']:.2f} ms wall, "
            f"{p['single_device_ms']:.2f} ms device")
    log(f"NCCL world-1 teacher step: backend {nccl['backend']}, bit-equal "
        f"to the plain step: {nccl['bit_equal']}; a captured raw NCCL "
        f"all-reduce replayed equal to its eager ops: "
        f"{nccl['captured_all_reduce']}; the graphed teacher and "
        f"K={CURRICULUM_K} steps' replays launched "
        f"{nccl['graphed_launches']}")
    for name, g in r0.get("graphed", {}).items():
        best, eager = min(g["graphed_ms"]), min(g["eager_ms"])
        busy = g["busy_ms"]
        replay = ("none recorded" if g["replay_busy_ms"] is None
                  else f"{g['replay_busy_ms']:.2f} ms")
        held = ("equal to the bit to its eager body" if g["bitwise"] else
                f"losses within {g['loss_gap']:.2e} and movements within "
                f"{g['move_gap']:.2e} of their norms of its eager body "
                f"(two eager runs equal to the bit: "
                f"{g.get('eager_repeats')})")
        log(f"{name} over {how}, graphed: {held}, NaN batch included, ranks "
            f"bit-equal; launches "
            f"{g['launches']}; wall graphed {g['graphed_ms'][0]:.2f} and "
            f"{g['graphed_ms'][1]:.2f} ms, eager {g['eager_ms'][0]:.2f} and "
            f"{g['eager_ms'][1]:.2f} ms ({eager / best:.2f}x); rank 0's "
            f"device busy {busy:.2f} ms a step issued op by op, busy share "
            f"graphed {busy / best:.2f}, eager {busy / eager:.2f}; the "
            f"profiler over replays: {replay}")
    for cd, p in r0["rollout"].items():
        log(f"stream-sharded rollout {cd}, {PAR_STREAMS} streams as {world} x "
            f"{p['local_streams']}, {STEPS} steps, fused kernel: max error "
            f"{p['err']:.3e} A against the unsharded rollout, bit-equal "
            f"{p['bit_equal']}, steps with other edge lists "
            f"{p['differing_steps']}; {p['steps_per_s']:,.0f} stream-steps/s "
            f"(unsharded, rank 0 alone: {p['single_steps_per_s']:,.0f})")
    s = r0["server"]
    log(f"mesh server, 8 mixed requests over {how} (f32, fused kernel): "
        f"max error {s['err']:.3e} A against dedicated rollouts, "
        f"{s['served_steps_per_s']:,.0f} served steps/s, stats {s['stats']}")
    for cd, p in r0["edge"].items():
        extra = (f"; a step {p['step_ms']:.2f} ms wall, {p['comm_ms']:.2f} ms "
                 f"of it in {p['collectives']} collectives "
                 f"({p['comm_ms'] / p['step_ms']:.2f}); unclocked "
                 f"{p['wall_ms']:.2f} ms wall, rank 0's device busy "
                 f"{p['busy_ms']:.2f} ms of it (busy share "
                 f"{p['busy_ms'] / p['wall_ms']:.3f}; the cell list stays "
                 f"eager); single process "
                 f"{p['single_step_ms']:.2f} ms" if "step_ms" in p else "")
        log(f"edge-sharded SOLVATED_10K {cd} over {how}: max error "
            f"{p['err']:.3e} A (tolerance {p['tol']:.3e}), bit-equal "
            f"{p['bit_equal']}, overflow {p['overflow']}, peak "
            f"{p['peak_gb']:.2f} GB on rank 0{extra}")
    log(f"parallel path launches (every rank's main path): {counts}; the "
        f"phase took {time.perf_counter() - t0:.1f} s")
    return counts


# ---- phase 21: the step loops as CUDA graphs ------------------------------

GRAPH_STREAMS = (1, 4, 8)
# a length that is not a multiple of the 64-step block: one block, a tail
GRAPH_ODD_STEPS = 100
FNO_SPREAD_STEPS = 40


@contextlib.contextmanager
def sync_errors():
    """Within the block any call that waits for the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


@contextlib.contextmanager
def eager_segments():
    """Within the block ``PreparedRollout`` issues its step loop from
    Python: the yardstick of the graphed server."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    graphed = pr.PreparedRollout.__call__
    pr.PreparedRollout.__call__ = pr.PreparedRollout.eager
    try:
        yield
    finally:
        pr.PreparedRollout.__call__ = graphed


def same_result(a, b) -> bool:
    """Coordinates, final window and overflow of two rollouts are equal to
    the bit."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2]["edge_overflow"], b[2]["edge_overflow"]))


def graph_rollouts(params, aa_np, traj) -> dict:
    """Phase 21a: the graphed ``PreparedRollout`` against its eager step
    loop, bit for bit, f32 and bf16 at 1, 4 and 8 streams, 128 steps (two
    blocks) and 100 (a block and a tail), the second call of each under
    ``set_sync_debug_mode("error")``; returns the launch counts of the
    bf16 single-stream 128-step replays."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )

    dev = torch.device("cuda")
    t_len = bench_cfg("bfloat16").window_size
    main = {}
    for cd in ("float32", "bfloat16"):
        cfg = bench_cfg(cd)
        prepared = pr.PreparedRollout(params, cfg, aa_np, THRESHOLD, CLIP,
                                      dev)
        for s in GRAPH_STREAMS:
            w0 = torch.as_tensor(np.stack(
                [traj.positions[i * (4000 // s):i * (4000 // s) + t_len]
                 for i in range(s)]), device=dev)
            for n in (STEPS, GRAPH_ODD_STEPS):
                pr.reset_launch_counts()
                want = prepared.eager(w0, n)
                eager_counts = pr.launch_counts()
                first = prepared(w0, n)  # captures the graphs it replays
                pr.reset_launch_counts()
                with sync_errors():
                    again = prepared(w0, n)
                counts = pr.launch_counts()
                tag = f"graphed rollout, {cd}, S={s}, {n} steps"
                require(same_result(first, want) and same_result(again, want),
                        f"{tag}: not bit-equal to the eager step loop")
                require(counts == eager_counts == rollout_launches(n, cfg, s),
                        f"{tag}: launches {counts}, eager {eager_counts}")
                require(not bool(want[2]["edge_overflow"]),
                        f"{tag}: edge overflow")
                if cd == "bfloat16" and s == 1 and n == STEPS:
                    main = counts
        log(f"graphed rollout {cd}: S = {GRAPH_STREAMS}, {STEPS} and "
            f"{GRAPH_ODD_STEPS} steps, equal to the bit to the eager step "
            f"loop (coordinates, final window, overflow), the same "
            f"launches; no replay loop waited for the card")
    return main


def graph_rates(params, aa_np, traj) -> None:
    """Phase 21b: single-stream bf16 steps/s by the bench slope (64 and
    576 steps), graphed and eager, beside the device-time ceiling and the
    busy share; 4 streams too; the plain (scan) rollout's rate graphed and
    eager."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    dev = torch.device("cuda")
    cfg = bench_cfg("bfloat16")
    t_len = cfg.window_size
    prepared = pr.PreparedRollout(params, cfg, aa_np, THRESHOLD, CLIP, dev)
    for s in (1, 4):
        w0 = torch.as_tensor(np.stack(
            [traj.positions[1000 * i:1000 * i + t_len] for i in range(s)]),
            device=dev)
        w0 = w0 if s > 1 else w0[0]
        rates = {}
        for form in ("graphed", "eager", "graphed ", "eager "):
            run = prepared if form.strip() == "graphed" else prepared.eager
            rates[form] = steps_per_s(
                lambda n, run=run: (lambda p, a, w: run(w, n)),
                params, aa_np, w0, 64, 576)
        win = (w0 if s > 1 else w0[None]).clone().contiguous()
        bufs = prepared.buffers(s, win.shape[-2])
        coords = torch.empty(s, win.shape[-2], 3, device=dev)
        step_ms = device_ms(lambda: pr.step(bufs, prepared.weights, cfg,
                                            THRESHOLD, CLIP, win, coords))
        ceiling = 1e3 / step_ms
        g = max(rates["graphed"], rates["graphed "])
        e = max(rates["eager"], rates["eager "])
        if s == 1:
            plain = {}
            for form in ("graphed", "eager", "graphed ", "eager "):
                fns = {n: make_rollout_fn(cfg, n, THRESHOLD, clip=CLIP,
                                          device=dev) for n in (16, 80)}
                if form.strip() == "eager":
                    fns = {n: fn.eager for n, fn in fns.items()}
                plain[form] = steps_per_s(lambda n, fns=fns: fns[n],
                                          params, aa_np, w0, 16, 80)
            log(f"plain (scan) rollout rate, bf16, one stream, slope of 16 "
                f"and 80 steps: graphed {plain['graphed']:,.0f} and "
                f"{plain['graphed ']:,.0f} steps/s, eager "
                f"{plain['eager']:,.0f} and {plain['eager ']:,.0f}")
        log(f"bench rollout rate, bf16, {s} stream(s), slope of 64 and 576 "
            f"steps, two runs each: graphed {rates['graphed']:,.0f} and "
            f"{rates['graphed ']:,.0f} steps/s, eager {rates['eager']:,.0f} "
            f"and {rates['eager ']:,.0f}; a step is {step_ms * 1e3:.2f} us "
            f"of device time, a ceiling of {ceiling:,.0f} steps/s; busy "
            f"share graphed {g / ceiling:.3f}, eager {e / ceiling:.3f}; "
            f"graphed / eager {g / e:.2f}")


def graph_serving(params, aa_np, traj) -> None:
    """Phase 21c: the served results on graphed segments against dedicated
    rollouts issued op by op, bit for bit: the checkpoint on
    ``impl="persistent"`` (eight 256-step requests and a mixed trace),
    dh on seeded live weights, and ``impl="scan"`` with the fused kernel
    (four 64-step requests of four sequences against the eager scan of
    the same four streams); 8-stream served steps/s graphed and with the
    segment loop issued op by op."""
    from molecular_dynamics_neural_operator_tpu_torch.models import gkn_init
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )

    dev = torch.device("cuda")
    t_len = bench_cfg("bfloat16").window_size

    def serve(cfg, p, requests, impl, max_streams=8):
        opts = dict(aa=aa_np) if impl == "persistent" else {}
        with RolloutServer(p, cfg, segment_steps=SEGMENT,
                           max_streams=max_streams, threshold=THRESHOLD,
                           clip=CLIP, impl=impl, **opts) as srv:
            srv.warmup()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = [f.result(timeout=600)
                       for f in srv.submit_many(requests)]
            wall = time.perf_counter() - t0
            return results, srv.stats["steps_served"] / wall

    def hold_bits(results, requests, dedicated, tag):
        for i, ((_, w0, n), res) in enumerate(zip(requests, results)):
            coords, final, diags = dedicated(
                torch.as_tensor(w0, device=dev), n)
            require(np.array_equal(res.coords, coords.cpu().numpy())
                    and np.array_equal(res.final_window,
                                       final.cpu().numpy())
                    and res.edge_overflow == bool(diags["edge_overflow"]),
                    f"{tag} request {i} ({n} steps): not bit-equal to its "
                    f"dedicated rollout")

    cfg = bench_cfg("bfloat16")
    prepared = pr.PreparedRollout(params, cfg, aa_np, THRESHOLD, CLIP, dev)
    saturated = [(aa_np, traj.positions[500 * i:500 * i + t_len],
                  SATURATED_STEPS) for i in range(8)]
    mixed = [(aa_np, traj.positions[300 * i:300 * i + t_len],
              MIXED_HORIZONS[i % 4]) for i in range(12)]
    # the process's first server of this phase pays for its streams' and
    # pinned buffers' first use: not timed; then in turns
    rates = {}
    for form in ("cold", "graphed", "eager", "eager ", "graphed "):
        ctx = eager_segments() if form.strip() == "eager" \
            else contextlib.nullcontext()
        with ctx:
            results, rates[form] = serve(cfg, params, saturated,
                                         "persistent")
        hold_bits(results, saturated, prepared.eager,
                  f"saturated ({form.strip()} segments)")
    results, _ = serve(cfg, params, mixed, "persistent")
    hold_bits(results, mixed, prepared.eager, "mixed trace")
    log(f"serve persistent, 8 x {SATURATED_STEPS} steps, bf16: graphed "
        f"segments {rates['graphed']:,.0f} and {rates['graphed ']:,.0f} "
        f"served steps/s, eager segments {rates['eager']:,.0f} and "
        f"{rates['eager ']:,.0f}; every result of both and of a mixed trace "
        f"of 12 requests equal to the bit to a dedicated eager rollout")

    for cd in ("float32", "bfloat16"):
        dh_cfg = live_cfg(cd, electrostatics="dh")
        dh_params = gkn_init(dh_cfg, seed=0, device=dev)
        requests = [(aa_np, traj.positions[i:i + t_len], DH_STEPS)
                    for i in (0, 1000, 2000, 3000)]
        results, rate = serve(dh_cfg, dh_params, requests, "persistent", 4)
        hold_bits(results, requests, pr.PreparedRollout(
            dh_params, dh_cfg, aa_np, THRESHOLD, CLIP, dev).eager,
            f"dh {cd}")
        log(f"serve persistent dh, {cd}, 4 x {DH_STEPS} steps: every "
            f"result equal to the bit to a dedicated eager rollout; "
            f"{rate:,.0f} served steps/s")

    scan_cfg = live_cfg("bfloat16", conv_impl="pallas")
    scan_params = gkn_init(scan_cfg, seed=0, device=dev)
    requests = [((aa_np + 3 * i) % 20, traj.positions[j:j + t_len], SEGMENT)
                for i, j in enumerate((0, 1000, 2000, 3000))]
    results, rate = serve(scan_cfg, scan_params, requests, "scan", 4)
    eager = make_rollout_fn(scan_cfg, SEGMENT, THRESHOLD, clip=CLIP,
                            batched=True, device=dev).eager
    aa_b = torch.as_tensor(np.stack([r[0] for r in requests]), device=dev)
    w_b = torch.as_tensor(np.stack([r[1] for r in requests]), device=dev)
    coords, final, diags = eager(scan_params, aa_b, w_b)
    for i, res in enumerate(results):
        require(np.array_equal(res.coords, coords[i].cpu().numpy())
                and np.array_equal(res.final_window, final[i].cpu().numpy())
                and res.edge_overflow == bool(diags["edge_overflow"][i]),
                f"scan request {i}: not bit-equal to the eager scan of the "
                f"same four streams")
    log(f"serve scan with the fused kernel, 4 x {SEGMENT} steps, bf16: "
        f"every result equal to the bit to the eager scan of the same four "
        f"streams; {rate:,.0f} served steps/s")


def train_states_equal(a, b) -> bool:
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        opt_state_leaves,
        tree_leaves,
    )

    return all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a.params) + opt_state_leaves(a.opt_state),
        tree_leaves(b.params) + opt_state_leaves(b.opt_state)))


def hold_graphed_steps(tag, step, state0, batches, nan_at: int,
                       expect: dict) -> dict:
    """``step`` (graphed) against ``step.eager`` over ``batches`` from
    ``state0``; batch ``nan_at`` carries a NaN. Each finite step's loss
    within TOL_TRAIN_LOSS, every leaf's movement within TOL_TRAIN_MOVE of
    its norm; over the NaN batch both states' parameters, moments and
    apply count bit-unchanged and the skip counted. The graphed steps
    after the first run under ``set_sync_debug_mode("error")``. Each
    graphed step alone launches ``expect`` (kernel -> launches), counted
    from 0 just before it, as each eager step does. Returns {"bitwise":
    bool, "loss": worst relative loss gap, "move": worst movement gap,
    "launches": the graphed steps' launches summed, "state": the graphed
    steps' last state}."""
    from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
        copy_state,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        tree_leaves,
    )

    def launched(run, *args):
        start = all_launches()
        out = run(*args)
        return out, {k: n - start[k] for k, n in all_launches().items()
                     if n != start[k]}

    eager, graphed = state0, state0
    bitwise, worst_loss = True, 0.0
    total = {}
    for i, batch in enumerate(batches):
        before = {"eager": copy_state(eager), "graphed": copy_state(graphed)}
        (eager, m_e), n_e = launched(step.eager, eager, batch)
        if i == 0:
            (graphed, m_g), n_g = launched(step, graphed, batch)
        else:
            with sync_errors():
                (graphed, m_g), n_g = launched(step, graphed, batch)
        require(n_g == expect and n_e == expect, f"{tag}: step {i} launched "
                f"{n_g} graphed and {n_e} eager, not {expect} each")
        for k, n in n_g.items():
            total[k] = total.get(k, 0) + n
        for form, new in (("eager", eager), ("graphed", graphed)):
            old = before[form]
            opt, was = new.opt_state, old.opt_state
            if i == nan_at:
                require(not bool(torch.isfinite(m_g["rel_l2"]))
                        and not bool(torch.isfinite(m_e["rel_l2"]))
                        and all(torch.equal(a, b) for a, b in zip(
                            tree_leaves(new.params) + tree_leaves(opt.mu)
                            + tree_leaves(opt.nu),
                            tree_leaves(old.params) + tree_leaves(was.mu)
                            + tree_leaves(was.nu)))
                        and torch.equal(opt.count, was.count)
                        and not bool(opt.last_finite)
                        and int(opt.total_notfinite)
                        == int(was.total_notfinite) + 1,
                        f"{tag}: the {form} step over the NaN batch changed "
                        f"its state or did not count the skip")
        bitwise = bitwise and train_states_equal(eager, graphed) and (
            i == nan_at or all(torch.equal(m_e[k], m_g[k]) for k in m_e))
        if i != nan_at:
            gap = abs(float(m_g["rel_l2"]) - float(m_e["rel_l2"])) / abs(
                float(m_e["rel_l2"]))
            worst_loss = max(worst_loss, gap)
            require(gap <= TOL_TRAIN_LOSS, f"{tag}: step {i} loss differs "
                    f"by {gap:.2e} between the graphed and the eager step")
    worst_move = 0.0
    for (name, a), (_, b), (_, c) in zip(tree_items(graphed.params),
                                         tree_items(eager.params),
                                         tree_items(state0.params)):
        move = (b - c).norm().item()
        require(move > 0, f"{tag}: {name} did not move")
        worst_move = max(worst_move, (a - b).norm().item() / move)
    require(worst_move <= TOL_TRAIN_MOVE, f"{tag}: a leaf's movement "
            f"differs by {worst_move:.2e} of its norm")
    require(graphed.step == eager.step == len(batches)
            and int(graphed.opt_state.count) == len(batches) - 1,
            f"{tag}: step {graphed.step}, count {graphed.opt_state.count}")
    log(f"{tag}: {len(batches)} steps from one state, batch {nan_at} with a "
        f"NaN, each graphed and each eager step launching {expect}: graphed "
        f"against eager "
        + ("equal to the bit (parameters, moments, counters, metrics)"
           if bitwise else f"losses within {worst_loss:.2e}, movements "
           f"within {worst_move:.2e} of their norms (not bitwise)")
        + "; over the NaN batch both left parameters, moments and the "
        "apply count as they were and counted the skip; no graphed step "
        "after the first waited for the card")
    return {"bitwise": bitwise, "loss": worst_loss, "move": worst_move,
            "launches": total, "state": graphed}


def state_copy_ms(tag, state) -> None:
    """Device ms of the work a graphed step adds to the eager step's: the
    copy of the new parameters, moments and counters into the graph's
    static state (``train/graphed.py``), beside the copy of the optimizer
    state that every step's ``apply_update`` makes."""
    from molecular_dynamics_neural_operator_tpu_torch.train.graphed import (
        _state_leaves,
        copy_state,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        clone_opt_state,
    )

    dst, src = copy_state(state), copy_state(state)
    leaves = _state_leaves(src)
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    to_static = device_ms(lambda: torch._foreach_copy_(_state_leaves(dst),
                                                      leaves), reps=5)
    opt_copy = device_ms(lambda: clone_opt_state(src.opt_state), reps=5)
    log(f"{tag}: the graphed step's copy into its static state, "
        f"{nbytes / 1e6:.2f} MB of parameters, moments and counters: "
        f"{to_static * 1e3:.2f} us device; the optimizer state's copy in "
        f"apply_update: {opt_copy * 1e3:.2f} us device")


def graph_step_times(tag, step, state, batch, samples: int,
                     n: int = 10) -> None:
    """Wall ms of the graphed and the eager step (two runs of ``n`` steps
    each, in turns), beside the device busy ms of the step issued op by
    op (``torch.profiler``)."""
    walls = {}
    for form in ("graphed", "eager", "graphed ", "eager "):
        run = step if form.strip() == "graphed" else step.eager
        walls[form] = wall_ms(run, state, batch, n=n)
    busy = profile_step(step.eager, state, batch, walls["eager"],
                        f"{tag} (eager, for its device time)")
    graphed_busy = profiled_busy(step, state, batch)
    g = min(walls["graphed"], walls["graphed "])
    e = min(walls["eager"], walls["eager "])
    log(f"{tag}: wall graphed {walls['graphed']:.2f} and "
        f"{walls['graphed ']:.2f} ms, eager {walls['eager']:.2f} and "
        f"{walls['eager ']:.2f} ms; device busy {busy:.2f} ms a step; busy "
        f"share graphed {busy / g:.2f}, eager {busy / e:.2f}; "
        f"{samples / g * 1e3:,.0f} samples/s graphed; the profiler over "
        f"graph replays: "
        + ("no device time recorded" if graphed_busy is None
           else f"{graphed_busy:.2f} ms device busy a step"))


def profiled_busy(step, state, batch, steps: int = 3):
    """Device busy ms a step that ``torch.profiler`` records over
    ``steps`` steps after a warm-up, or None if it records none."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / steps
    return busy or None


HOST_OPS = 2000
HOST_AT_START: dict = {}


def host_op_us() -> float:
    """The host's cost of one small eager PyTorch call on the card, in
    µs: the best of five runs of ``HOST_OPS`` one-element adds, each
    enqueued without waiting, divided by the count."""
    x = torch.zeros(1, device="cuda")
    best = float("inf")
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_OPS):
            x.add_(1.0)
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / HOST_OPS * 1e6


def fno_spread(ds) -> None:
    """Phase 21e: where the FNO step's wall time goes astray. Each of
    ``FNO_SPREAD_STEPS`` eager steps is timed alone (the card idle before
    and after), with the caching allocator's device allocations and the
    garbage collector's runs during it; then the graphed step the same
    way."""
    import gc

    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import fno
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    batch = to_device(ds.get_batch(np.arange(FNO_BATCH)), "cuda")
    log(f"host cost of one small eager call on the card: {host_op_us():.2f} "
        f"us now, {HOST_AT_START.get('us', float('nan')):.2f} us when this "
        f"process began its phases; load average "
        f"{os.getloadavg()[0]:.2f} over the last minute")
    runs = {"gc": 0}
    gc.callbacks.append(lambda phase, info: runs.__setitem__(
        "gc", runs["gc"] + (phase == "start")))
    try:
        for impl in ("auto", "fft"):
            cfg = fno_cfg(spectral_impl=impl)
            tx, _ = make_optimizer(lr=1e-3)
            params = fno.fno_init(cfg, seed=0, device="cuda")
            step = fno.make_fno_window_train_step(cfg, tx)
            for form in ("eager", "graphed"):
                run = step if form == "graphed" else step.eager
                state = TrainState(params, tx.init(params), 0, 0)
                rows = []
                for i in range(FNO_SPREAD_STEPS + 1):
                    torch.cuda.synchronize()
                    before = torch.cuda.memory_stats()
                    gcs = runs["gc"]
                    t0, c0 = time.perf_counter(), time.process_time()
                    state, _ = run(state, batch)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    after = torch.cuda.memory_stats()
                    rows.append((ms, after.get("num_device_alloc", 0)
                                 - before.get("num_device_alloc", 0),
                                 runs["gc"] - gcs,
                                 (time.process_time() - c0) * 1e3,
                                 (t1 - t0) * 1e3,
                                 after.get("num_alloc_retries", 0)
                                 - before.get("num_alloc_retries", 0)))
                first, rest = rows[0], rows[1:]
                ms = sorted(r[0] for r in rest)
                slow = max(rest)
                log(f"FNO step ({impl}, {form}) alone, {FNO_SPREAD_STEPS} "
                    f"steps after the first ({first[0]:.2f} ms, "
                    f"{first[1]} device allocations): min {ms[0]:.2f}, "
                    f"median {ms[len(ms) // 2]:.2f}, max {ms[-1]:.2f} ms; "
                    f"the slowest: {slow[4]:.2f} ms to enqueue, "
                    f"{slow[3]:.2f} ms of the process's CPU time, "
                    f"{slow[1]} device allocations, {slow[5]} allocator "
                    f"retries, {slow[2]} garbage collections; steps with a "
                    f"device allocation {sum(r[1] > 0 for r in rest)}, "
                    f"with a collection {sum(r[2] > 0 for r in rest)}; "
                    f"median enqueue {sorted(r[4] for r in rest)[len(rest) // 2]:.2f} ms")
                if form == "eager":
                    walls = [wall_ms(run, TrainState(params, tx.init(params),
                                                     0, 0), batch)
                             for _ in range(5)]
                    log(f"FNO step ({impl}, eager) by wall_ms (one step's "
                        f"warm-up, then 6 timed), five times: "
                        + ", ".join(f"{w:.2f}" for w in walls) + " ms")
    finally:
        gc.callbacks.pop()


def graph_training(ds, train_idx) -> dict:
    """Phase 21d: the graphed teacher-forced, K = 4 curriculum and FNO
    train steps against their eager steps over ``TRAIN_STEPS`` batches
    with a NaN in one (``skip_nonfinite_updates``), their wall and device
    ms; then phase 21e. Returns the training kernels' launches of the
    graphed teacher and K = 4 steps alone, not of their eager oracles."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.models import fno
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        make_optimizer,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.state import (
        TrainState,
    )

    cfg, tcfg = training_cfgs()
    tcfg = dataclasses.replace(tcfg, skip_nonfinite_updates=True)
    nan_at = TRAIN_STEPS // 2

    def batches(k=0):
        out = [to_device(ds.get_batch(
            train_idx[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
            rollout_horizon=k), "cuda") for i in range(TRAIN_STEPS)]
        out[nan_at]["window"][3, 2, 5, 1] = float("nan")
        return out

    state0, tx, _ = create_train_state(0, cfg, tcfg)
    step = make_train_step(cfg, tx, noise_std=0.01)
    teacher = batches()
    held = hold_graphed_steps(
        f"teacher-forced step, B={TRAIN_BATCH} bf16, noise 0.01", step,
        state0, teacher, nan_at, {"train_conv_fwd": 1, "train_conv_bwd": 1})
    counts = held["launches"]
    graph_step_times(f"teacher-forced step, B={TRAIN_BATCH} bf16", step,
                     state0, teacher[0], TRAIN_BATCH)
    state_copy_ms(f"teacher-forced step, B={TRAIN_BATCH} bf16", state0)

    state0, tx, _ = create_train_state(0, cfg, tcfg)
    step = curriculum_step(cfg, tx, None)
    k4 = batches(CURRICULUM_K)
    held = hold_graphed_steps(
        f"K={CURRICULUM_K} curriculum step, delta loss, B={TRAIN_BATCH} "
        f"bf16", step, state0, k4, nan_at,
        {"train_conv_fwd": CURRICULUM_K, "train_conv_bwd": CURRICULUM_K})
    counts = {k: counts.get(k, 0) + held["launches"].get(k, 0)
              for k in set(counts) | set(held["launches"])}
    graph_step_times(f"K={CURRICULUM_K} curriculum step, B={TRAIN_BATCH} "
                     f"bf16", step, state0, k4[0], TRAIN_BATCH)

    fcfg = fno_cfg()
    ftx, _ = make_optimizer(lr=1e-3, skip_nonfinite_updates=True)
    params = fno.fno_init(fcfg, seed=0, device="cuda")
    fstate = TrainState(params, ftx.init(params), 0, 0)
    fstep = fno.make_fno_window_train_step(fcfg, ftx)
    fb = batches()
    hold_graphed_steps(f"FNO train step, B={TRAIN_BATCH} f32", fstep,
                       fstate, fb, nan_at, {})
    graph_step_times(f"FNO train step (auto), B={TRAIN_BATCH} f32", fstep,
                     fstate, fb[0], TRAIN_BATCH)
    fno_spread(ds)
    return counts


def graph_kept_rollouts(ds, train_idx) -> None:
    """Phase 21f: rollouts kept across graphed train steps. Two rounds of
    two graphed teacher steps; after each, the kept kernel rollout
    (``make_persistent_rollout_fn``) and the kept fused scan rollout
    (``make_rollout_fn``, ``conv_impl="pallas"``) of the trained state's
    parameters, 70 steps of 2 streams, each bit-equal to the eager
    rollout of a fresh copy of those parameters."""
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train.optim import (
        tree_leaves,
        tree_map,
    )

    cfg, tcfg = training_cfgs()
    state, tx, _ = create_train_state(0, cfg, tcfg)
    step = make_train_step(cfg, tx)
    n = 70
    kernel_fn = pr.make_persistent_rollout_fn(cfg, n, clip=100.0)
    fused = dataclasses.replace(cfg, conv_impl="pallas")
    scan_fn = make_rollout_fn(fused, n, batched=True, clip=100.0)
    first = to_device(ds.get_batch(train_idx[:TRAIN_BATCH]), "cuda")
    aa, w0 = torch.as_tensor(first["aa"], device="cuda"), first["window"][:2]
    previous = None
    for r in range(2):
        for i in range(2):
            b = train_idx[(2 * r + i) * TRAIN_BATCH:
                          (2 * r + i + 1) * TRAIN_BATCH]
            state, _ = step(state, to_device(ds.get_batch(b), "cuda"))
        fresh = tree_map(torch.clone, state.params)
        require(previous is None or not all(
            torch.equal(a, b) for a, b in zip(tree_leaves(fresh),
                                              tree_leaves(previous))),
            "the graphed steps did not move the parameters")
        previous = fresh
        want = pr.PreparedRollout(fresh, cfg, aa, clip=100.0).eager(w0, n)
        require(torch.equal(kernel_fn(state.params, aa, w0)[0], want[0]),
                f"round {r}: the kept kernel rollout differs from the eager "
                f"rollout of the trained parameters")
        require(torch.equal(scan_fn(state.params, aa, w0)[0],
                            scan_fn.eager(fresh, aa, w0)[0]),
                f"round {r}: the kept fused scan rollout differs from the "
                f"eager scan of the trained parameters")
    log("rollouts kept across graphed train steps: after each of two "
        "rounds of two graphed teacher steps, the kept kernel rollout and "
        "the kept fused scan rollout (70 steps, 2 streams) equal to the bit "
        "the eager rollouts of a fresh copy of the trained parameters")


# ---- phase 22: the dense graph's loops as CUDA graphs ---------------------

DENSE_GRAPH_STREAMS = (1, 8)
DENSE_GRAPH_CHUNK = 4
DENSE_SERVED_STEPS = 2 * SEGMENT  # a request spans two segments
LARGE_BUSY_STEPS = 4


@contextlib.contextmanager
def eager_scan_segments():
    """Within the block a new ``RolloutServer(impl="scan")`` issues its
    segment loop from Python: the yardstick of the graphed server."""
    from molecular_dynamics_neural_operator_tpu_torch.serving import server

    graphed = server.stays_eager
    server.stays_eager = lambda cfg: True
    try:
        yield
    finally:
        server.stays_eager = graphed


def dense_windows(traj, streams: int, dev):
    t_len = dense_cfg("bfloat16").window_size
    return torch.as_tensor(np.stack(
        [traj.positions[i * (4000 // streams):i * (4000 // streams) + t_len]
         for i in range(streams)]), device=dev)


def dense_graph_rollouts(params, aa, traj) -> None:
    """Phase 22a: the dense scan rollout (the BBA preset, the bench
    checkpoint) replayed as CUDA graphs against its loop issued op by op,
    bit for bit: f32 and bf16, one stream and eight in chunks of four,
    GRAPH_ODD_STEPS steps (a block and a tail) collecting coordinates and
    contact maps, the second graphed call under the sync check."""
    from molecular_dynamics_neural_operator_tpu_torch.cli.export import (
        same_outputs,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    dev = torch.device("cuda")
    for cd in ("float32", "bfloat16"):
        cfg = dense_cfg(cd)
        for s in DENSE_GRAPH_STREAMS:
            batched = s > 1
            fn = make_rollout_fn(
                cfg, GRAPH_ODD_STEPS, THRESHOLD, collect="both",
                batched=batched, clip=CLIP,
                stream_chunk=DENSE_GRAPH_CHUNK if batched else None)
            w0 = dense_windows(traj, s, dev)
            w0 = w0 if batched else w0[0]
            # a step of each chunk of streams: one kernel tensor, in bf16
            # through the hand-written edge MLP
            expect = scan_launches(
                GRAPH_ODD_STEPS * (s // DENSE_GRAPH_CHUNK if batched else 1),
                cfg)
            with torch.no_grad():
                want, n_eager = counted(lambda: fn.eager(params, aa, w0))
                first, n_first = counted(lambda: fn(params, aa, w0))
                with sync_errors():
                    again, n_again = counted(lambda: fn(params, aa, w0))
            require(same_outputs(first, want) and same_outputs(again, want),
                    f"graphed dense rollout, {cd}, S={s}: not bit-equal to "
                    f"the loop issued op by op")
            require(n_eager == n_first == n_again == expect,
                    f"dense rollout, {cd}, S={s}: launches {n_eager} eager, "
                    f"{n_first} and {n_again} graphed, expected {expect}")
            require(bool(torch.isfinite(want[0][0]).all()),
                    f"dense rollout, {cd}, S={s}: not finite")
    log(f"graphed dense rollout (BBA preset, the bench checkpoint), f32 and "
        f"bf16, S = {DENSE_GRAPH_STREAMS} (8 in chunks of "
        f"{DENSE_GRAPH_CHUNK}), {GRAPH_ODD_STEPS} steps collecting both: "
        f"coordinates, contact maps, final window and overflow equal to the "
        f"bit to the loop issued op by op; no second call waited for the "
        f"card; graphed and eager alike, bf16 launched the hand-written "
        f"edge MLP's three kernels a step and a chunk, f32 nothing")


def dense_graph_rates(params, aa, traj) -> None:
    """Phase 22b: the dense scan rollout's steps/s by the slope of 16 and
    80 steps, graphed and eager in turns (two runs each at bf16 and one
    stream, one run each elsewhere), bf16 and f32 at 1 and 4 streams,
    beside a step's device time (``device_ms``: a captured step, no host
    in it) and the busy share it implies."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
        scan,
    )

    dev = torch.device("cuda")
    for cd in ("bfloat16", "float32"):
        cfg = dense_cfg(cd)
        for s in (1, 4):
            w0 = dense_windows(traj, s, dev)
            w0 = w0 if s > 1 else w0[0]
            rates = {}
            forms = ("graphed", "eager", "graphed ", "eager ") \
                if (cd, s) == ("bfloat16", 1) else ("graphed", "eager")
            with torch.no_grad():
                for form in forms:
                    fns = {n: make_rollout_fn(cfg, n, THRESHOLD, clip=CLIP,
                                              batched=s > 1, device=dev)
                           for n in (16, 80)}
                    if form.strip() == "eager":
                        fns = {n: fn.eager for n, fn in fns.items()}
                    rates[form] = steps_per_s(lambda n, fns=fns: fns[n],
                                              params, aa, w0, 16, 80)
                step_ms = device_ms(lambda: scan._step(
                    params, cfg, aa, w0, THRESHOLD, "last", CLIP), reps=5)
            g = max(v for k, v in rates.items() if "graphed" in k)
            e = max(v for k, v in rates.items() if "eager" in k)
            runs = {form: " and ".join(f"{v:,.1f}" for k, v in rates.items()
                                       if k.strip() == form)
                    for form in ("graphed", "eager")}
            log(f"dense scan rollout rate, {cd}, {s} stream(s), slope of 16 "
                f"and 80 steps: graphed {runs['graphed']} steps/s, eager "
                f"{runs['eager']}; a step "
                f"is {step_ms * 1e3:.1f} us of device time, a ceiling of "
                f"{1e3 / step_ms:,.0f} steps/s; busy share graphed "
                f"{g * step_ms / 1e3:.3f}, eager {e * step_ms / 1e3:.3f}; "
                f"graphed / eager {g / e:.2f}")


def dense_graph_serving(params, aa_np, traj) -> None:
    """Phase 22c: eight requests of DENSE_SERVED_STEPS steps (two
    segments) through a dense bf16 ``RolloutServer(impl="scan")``, its
    segments graphed and, in turns, issued op by op; every result equal
    to the bit to the eager scan of the same eight streams; served
    steps/s of both."""
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.serving import (
        RolloutServer,
    )

    dev = torch.device("cuda")
    cfg = dense_cfg("bfloat16")
    w8 = dense_windows(traj, 8, dev)
    requests = [(aa_np, w8[i].cpu().numpy(), DENSE_SERVED_STEPS)
                for i in range(8)]
    aa_b = torch.as_tensor(np.stack([aa_np] * 8), device=dev)
    with torch.no_grad():
        coords, final, diags = make_rollout_fn(
            cfg, DENSE_SERVED_STEPS, THRESHOLD, clip=CLIP, batched=True,
            device=dev).eager(params, aa_b, w8)
    rates = {}
    for form in ("graphed", "eager", "graphed ", "eager "):
        ctx = eager_scan_segments() if form.strip() == "eager" \
            else contextlib.nullcontext()
        with ctx, RolloutServer(params, cfg, segment_steps=SEGMENT,
                                max_streams=8, threshold=THRESHOLD,
                                clip=CLIP, impl="scan") as srv:
            srv.warmup([8])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = [f.result(timeout=600)
                       for f in srv.submit_many(requests)]
            rates[form] = srv.stats["steps_served"] / (
                time.perf_counter() - t0)
        for i, res in enumerate(results):
            require(np.array_equal(res.coords, coords[i].cpu().numpy())
                    and np.array_equal(res.final_window,
                                       final[i].cpu().numpy())
                    and res.edge_overflow == bool(diags["edge_overflow"][i]),
                    f"dense served request {i} ({form.strip()} segments): "
                    f"not bit-equal to the eager scan of the same streams")
    log(f"dense RolloutServer(impl='scan'), bf16, 8 x {DENSE_SERVED_STEPS} "
        f"steps (two segments): graphed segments {rates['graphed']:,.0f} "
        f"and {rates['graphed ']:,.0f} served steps/s, eager segments "
        f"{rates['eager']:,.0f} and {rates['eager ']:,.0f}; every result of "
        f"both equal to the bit to the eager scan of the same eight streams")


def dense_graph_training(traj) -> None:
    """Phase 22d: the dense graph's graphed teacher-forced step (with
    input noise) and K = 4 curriculum step (delta loss, full BPTT) at
    B = 128 bf16 against their eager steps over ``TRAIN_STEPS`` batches
    with a NaN in one: equal to the bit, the NaN batch leaving the state
    as it was; wall ms graphed and eager beside the device busy ms."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (
        to_device,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        create_train_state,
        make_train_step,
        train_valid_split,
    )

    cfg = dense_cfg("bfloat16", kernel_init_scale=0.1)
    _, tcfg = training_cfgs()
    tcfg = dataclasses.replace(tcfg, skip_nonfinite_updates=True)
    ds = WindowDataset(traj, window_size=cfg.window_size, graph_mode="dense")
    train_idx, _ = train_valid_split(len(ds))
    nan_at = TRAIN_STEPS // 2

    def batches(k=0):
        out = [to_device(ds.get_batch(
            train_idx[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
            rollout_horizon=k), "cuda") for i in range(TRAIN_STEPS)]
        out[nan_at]["window"][3, 2, 5, 1] = float("nan")
        return out

    for tag, make, k in (
            (f"dense teacher-forced step, B={TRAIN_BATCH} bf16, noise 0.01",
             lambda tx: make_train_step(cfg, tx, noise_std=0.01), 0),
            (f"dense K={CURRICULUM_K} curriculum step, delta loss, "
             f"B={TRAIN_BATCH} bf16", lambda tx: curriculum_step(
                 cfg, tx, None), CURRICULUM_K)):
        state0, tx, _ = create_train_state(0, cfg, tcfg)
        step = make(tx)
        data = batches(k)
        held = hold_graphed_steps(tag, step, state0, data, nan_at, {})
        require(held["bitwise"], f"{tag}: the graphed steps are not equal "
                "to the bit to the eager steps")
        graph_step_times(tag, step, state0, data[0], TRAIN_BATCH,
                         n=4 if k else 10)


def large_busy_share(dev) -> None:
    """Phase 22e: the ``SOLVATED_10K`` rollout step issued op by op (the
    configuration ``stays_eager`` keeps eager): its device busy ms a step
    (``torch.profiler`` over one ``LARGE_BUSY_STEPS``-step call) over its
    wall ms a step (a timed call after a warm one)."""
    from torch.profiler import ProfilerActivity, profile

    from molecular_dynamics_neural_operator_tpu_torch.models import gkn
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda.graphs import (
        stays_eager,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )

    cfg = solvated_cfg("bfloat16")
    require(stays_eager(cfg), "the 10k configuration does not stay eager")
    params = gkn.gkn_init(cfg, seed=0, device=dev)
    aa = torch.as_tensor(np.random.default_rng(1).integers(0, 20, LARGE_N),
                         device=dev)
    grid = torch.as_tensor(breathing_trajectory(
        serpentine_grid(LARGE_N, 4.0), cfg.window_size), device=dev)
    roll = make_rollout_fn(cfg, LARGE_BUSY_STEPS, THRESHOLD,
                           clip=CURRICULUM_CLIP)
    with torch.no_grad():
        roll(params, aa, grid)
        (coords, _, _), seconds = timed_call(lambda: roll(params, aa, grid))
        require(bool(torch.isfinite(coords).all()),
                "10k rollout: not finite")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            roll(params, aa, grid)
            torch.cuda.synchronize()
    busy = sum(e.device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / LARGE_BUSY_STEPS
    require(busy > 0, "torch.profiler recorded no device time")
    wall = seconds * 1e3 / LARGE_BUSY_STEPS
    log(f"SOLVATED_10K bf16 rollout step issued op by op (stays eager): "
        f"{busy:.2f} ms of device time (torch.profiler) in {wall:.2f} ms of "
        f"wall time a step ({LARGE_BUSY_STEPS}-step call after a warm one): "
        f"busy share {busy / wall:.3f}")


def dense_graph_phases(traj) -> None:
    """Phase 22: the dense graph's loops replayed as graphs against their
    loops issued op by op (a to d), and the 10k step's busy share (e). Of
    the kernels only the hand-written edge MLP lies on these paths, three
    launches a bf16 kernel tensor."""
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    reset_all_launches()
    ckpt = load_params_npz(CKPT, device=dev)
    aa_np = np.asarray(traj.aminoacids)
    aa = torch.as_tensor(aa_np, device=dev)
    dense_graph_rollouts(ckpt, aa, traj)
    dense_graph_rates(ckpt, aa, traj)
    dense_graph_serving(ckpt, aa_np, traj)
    dense_graph_training(traj)
    large_busy_share(dev)
    counts = all_launches()
    require_hand_mlp_only(counts, "the dense path")
    log(f"phase 22 (the dense graph's loops as graphs) took "
        f"{time.perf_counter() - t0:.1f} s")


def graph_phases(traj, bundles: bool = False) -> dict:
    """Phases 21 and 22, and with ``bundles`` phase 19a (the serving
    bundles, graphed against eager); returns the launch counts of phase
    21's graphed main-path runs (the bf16 single-stream rollout, the
    teacher and K = 4 steps)."""
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    dev = torch.device("cuda")
    ckpt = load_params_npz(CKPT, device=dev)
    aa_np = np.asarray(traj.aminoacids)
    counts = graph_rollouts(ckpt, aa_np, traj)
    graph_rates(ckpt, aa_np, traj)
    graph_serving(ckpt, aa_np, traj)
    cfg, _ = training_cfgs()
    ds = WindowDataset(traj, window_size=cfg.window_size,
                       graph_mode="sparse", max_edges=cfg.max_edges)
    train_idx, _ = train_valid_split(len(ds))
    counts.update(graph_training(ds, train_idx))
    graph_kept_rollouts(ds, train_idx)
    dense_graph_phases(traj)
    if bundles:
        import tempfile

        with tempfile.TemporaryDirectory(prefix="chip_smoke_graphs_") as tmp:
            export_bundles(traj, Path(tmp))
    return counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rollout_phases(traj) -> list:
    """Phases 2-4, the serving path; returns its ``kernels`` records."""
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda import (
        persistent_rollout as pr,
    )
    from molecular_dynamics_neural_operator_tpu_torch.rollout import (
        make_rollout_fn,
    )
    from molecular_dynamics_neural_operator_tpu_torch.utils.checkpoint import (
        load_params_npz,
    )

    dev = torch.device("cuda")
    params = load_params_npz(CKPT, device=dev)
    aa = torch.as_tensor(traj.aminoacids, device=dev)
    t_len = bench_cfg("bfloat16").window_size
    window0 = torch.as_tensor(traj.positions[:t_len], device=dev)
    windows4 = torch.as_tensor(np.stack(
        [traj.positions[i:i + t_len] for i in (0, 1000, 2000, 3000)]),
        device=dev)

    errs = {}
    def spread(n):
        return torch.as_tensor(np.stack(
            [traj.positions[i * (4000 // n):i * (4000 // n) + t_len]
             for i in range(n)]), device=dev)

    for cd, sets in (("float32", (window0[None].contiguous(), windows4)),
                     ("bfloat16", (window0[None].contiguous(), spread(3),
                                   windows4, spread(8)))):
        for windows in sets:
            e = check_kernels(params, aa, windows, cd)
            if cd == "bfloat16" and windows.shape[0] == 1:
                errs = e

    check_rollout(params, aa, window0, "float32", main_path=False)
    check_rollout(params, aa, windows4, "bfloat16", main_path=False)
    counts = check_rollout(params, aa, window0, "bfloat16", main_path=True)
    log(f"main path launches: {counts}")
    for name, n in counts.items():
        require(n > 0, f"kernel {name} was not launched on the main path")

    cfg = bench_cfg("bfloat16")
    k_rate = steps_per_s(
        lambda n: pr.make_persistent_rollout_fn(cfg, n, THRESHOLD, CLIP),
        params, aa, window0, 64, 576)
    p_rate = steps_per_s(
        lambda n: make_rollout_fn(cfg, n, THRESHOLD, clip=CLIP),
        params, aa, window0, 16, 80)
    k4_rate = steps_per_s(
        lambda n: pr.make_persistent_rollout_fn(cfg, n, THRESHOLD, CLIP),
        params, aa, windows4, 64, 320)
    log(f"bench rollout (bf16, single stream): kernel path {k_rate:,.0f} "
        f"steps/s, plain path {p_rate:,.0f} steps/s; 4 streams on the "
        f"kernel path: {k4_rate:,.0f} steps/s each, "
        f"{4 * k4_rate:,.0f} in all")

    step_ms, kernels = time_kernels(params, aa, window0, counts, errs)
    log(f"device busy share of the single-stream rollout: "
        f"{step_ms * k_rate / 1e3:.3f} (device time of a step x steps/s)")
    check_large_encoders(dev)
    check_large_rollouts(params, dev)
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=PAR_WORLD,
                        help="phase 20's ranks (default 2, sharing one "
                             "card through gloo; with a card each, NCCL)")
    parser.add_argument("--only", choices=("rollout", "train", "serve",
                                           "cli", "dense", "options",
                                           "large", "fno", "export",
                                           "parallel", "graphs"),
                        help="run one path's phases (development)")
    args = parser.parse_args()
    only = args.only
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke run needs "
            "a CUDA card")
        return 1
    from molecular_dynamics_neural_operator_tpu_torch.data import (
        WindowDataset,
        synthetic_trajectory,
    )
    from molecular_dynamics_neural_operator_tpu_torch.ops.cuda._build import (
        build_logs,
        load_kernels,
    )
    from molecular_dynamics_neural_operator_tpu_torch.train import (
        train_valid_split,
    )

    # the plain versions are the oracle: full-f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    load_kernels()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    HOST_AT_START["us"] = host_op_us()
    for name, text in build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"nvcc {name}: {line.strip()}")

    traj = synthetic_trajectory(num_frames=4000, num_residues=28, seed=13)
    kernels = []
    if only in (None, "rollout"):
        kernels += rollout_phases(traj)
    serve_kernels = serve_phases(traj) if only in (None, "serve") else []
    if only in (None, "train"):
        from molecular_dynamics_neural_operator_tpu_torch.data.prefetch import (  # noqa: E501
            to_device,
        )
        from molecular_dynamics_neural_operator_tpu_torch.models import (
            gkn_init,
        )

        cfg = train_cfg("bfloat16")
        ds = WindowDataset(traj, window_size=cfg.window_size,
                           graph_mode="sparse", max_edges=cfg.max_edges)
        train_idx, valid_idx = train_valid_split(len(ds))
        params = gkn_init(cfg, seed=0, device="cuda")
        batch = to_device(ds.get_batch(train_idx[:TRAIN_BATCH]), "cuda")
        check_train_conv(params, batch, "float32")
        errs = check_train_conv(params, batch, "bfloat16")
        check_train_conv_widths(batch)
        probe_default_recipe(batch)
        counts = check_training(ds, train_idx, valid_idx)
        for name, n in counts.items():
            require(n > 0, f"kernel {name} was not launched on the "
                    "training path")
        check_curriculum_grads(ds, train_idx)
        for path in (check_curriculum(ds, train_idx),
                     check_curriculum_recipe()):
            for name, n in path.items():
                require(n > 0, f"kernel {name} was not launched on the "
                        "curriculum path")
                counts[name] += n
        train_kernels, step_ms = time_training(params, ds, train_idx, counts,
                                               errs)
        kernels += train_kernels
        busy = profile_train_step(batch, step_ms)
        time_curriculum(ds, train_idx, step_ms, busy)
    kernels += serve_kernels
    for path, phase in (("cli", cli_phases), ("dense", dense_phase),
                        ("options", options_phase), ("large", large_phase),
                        ("fno", fno_phase), ("export", export_phase),
                        ("parallel", lambda t: parallel_phase(t,
                                                              args.ranks)),
                        ("graphs", lambda t: graph_phases(
                            t, bundles=only == "graphs"))):
        if only in (None, path):
            counts = phase(traj)
            records = counts.pop("kernels", [])
            for rec in kernels:
                rec["launches"] += counts.get(rec["name"], 0)
            kernels += records
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        log(f"FAIL: {exc}")
        sys.exit(1)
