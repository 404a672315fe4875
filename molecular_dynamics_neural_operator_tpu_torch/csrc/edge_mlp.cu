// edge_mlp: the edge-kernel MLP of a rollout step,
//   K = (relu(relu(ef @ w1 + b1) @ w2 + b2) @ w3 + b3) * mask,
// and one layer of it, C = act(A @ B + bias) * mask.
//
// Replaces, from the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py
// (persistent_rollout, body _kernel), the edge-kernel MLP 6 -> ker_width ->
// ker_width -> width^2 (:264-280) that the TPU runs on its matrix unit with
// the weights resident in VMEM. It runs over the S*E edge rows of a step;
// the last layer writes the per-edge kernel matrices K with padded edge rows
// zeroed by the mask (as the TPU kernel does, :280).
//
// The same three launches make the kernel tensor of the plain rollout step
// wherever nothing will differentiate it (ops/edge_conv.py::hand_mlp, as
// the operator mdno::edge_mlp_stack, with no row mask: its consumers mask
// their own rows): the large-system step's 480,000 cell-list slots, the
// dense and sparse scan rollouts and exported bundles in bf16.
//
// Bound: at one stream (M = 224 rows) the three layers do 2.35 GFLOP and
// must read 10.5 MB of bf16 weights: 2.4 us at the 989 TFLOP/s bf16 tensor
// peak against 3.1 us at 3.35 TB/s, so the weights' bytes bound it (they
// stay in the 50 MB L2 from step to step); at eight streams (1,792 rows,
// 18.8 GFLOP) the operations do, 19 us. What an H100 makes scarce here is
// not either of these but (a) the tensor cores' full rate, which only
// wgmma reaches, (b) the path from L2 into the SMs: every row tile pulls
// its share of the weights again and every column tile its rows, 16 MB for
// the second layer and 45 MB for the third at one stream against 10.5 MB
// of weights, so tiles are chosen to keep BM + BN small while the grid
// still covers the card, and (c) the fixed cost of three dependent
// launches, about 2.7 us each even for the 6-wide layer.
//
// Design (kernels and details in edge_mlp.cuh, which fused_gkn.cu includes
// too): one warp-specialised kernel per wide layer. A producer warp feeds a
// 4-stage ring of 128-byte-swizzled tiles by TMA (descriptors made on the
// host once per buffer and passed as __grid_constant__), one or two consumer
// warpgroups multiply them with wgmma m64n64k16 straight from shared memory
// and finish bias, ReLU, row mask and the bf16 rounding on the accumulator
// registers. Tiles: 64 x 64 for the second layer at one stream (64 blocks),
// 128 x 64 for the third (128 blocks, one wave, half the A traffic), 128 x
// 128 where that still gives a block an SM (eight streams). Every output
// sums its K products in k order with the same wgmma shape whatever the
// tile or the row count, so a stream's K does not depend on how many
// streams share the launch. The 6-wide first layer has a small kernel of
// its own (a thread forms eight outputs of a row by FMAs). The f32 path (the
// parity configuration) and bf16 layers with K % 64 != 0 run a
// shared-memory-tiled FMA kernel, since a full-f32 product has no tensor
// core form.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): the three
// layers take 17.2 us at one stream and 58.3 us at eight (322 TFLOP/s),
// where the wmma kernel they replace took 47.5 and 168.4.
//
// The large-system step (M = 480,000 rows, 6 -> 1024 -> 1024 -> 4096):
// 5.04 TFLOP, 5.10 ms at the bf16 peak, against 7.9 GB of h1, h2 and K
// written and read, 2.4 ms at 3.35 TB/s: the operations bound it. What
// holds it back is the path from L2: a 128 x 128 tile takes 64 operations
// a byte it pulls from L2 and a 128 x 256 tile 85, and both plans below run
// at about 6.5 to 7 TB/s from L2. Measured on one H100 (the hand form of
// tools/port_blocked_step_profile.py's parts): the small-M plans (128 x 128
// tiles, a block a tile, timed before the persistent plan existed)
// 12.1 to 12.3 ms (411 to 415 TFLOP/s, 42 % of the bound); the persistent
// plan 9.89 to 9.95 ms (506 to 509 TFLOP/s, 51 %): the narrow layer 0.78
// ms, the second 1.74 ms (578 TFLOP/s), the third 7.24 to 7.44 ms (541 to
// 556 TFLOP/s). cuBLAS through ops/mlp.py with its f32 bias adds, ReLUs
// and casts took 26.0 ms and a 17.7 GB peak where the kernels take 5.9 GB;
// both give the same bits on the step's first graph.
//
// The persistent plan (from 16,384 rows on; the rollout and serving launches
// stay at 1,792 or fewer and keep the plans above): one block an SM walks
// the 128 x 256 output tiles row band by row band, the producer running on
// into the next tile's k-tiles while the consumers finish a tile's
// epilogue; a k16 step is one m64n256k16 wgmma a warpgroup, summed in k
// order, and its rows equal the small plans' to the bit. End to end the
// solvated10k.rollout cell runs 26.10 steps/s with it against 24.61 with
// the small plans at every M (medians of six runs each, in turns on one
// H100 at 700 W: +6.0 %). Tried on the same
// card and left out: the same plan with four m64n64k16 products a k16 step
// (9.90 to 10.01 ms: the product shape is not what limits it); clusters of
// two blocks on neighbouring row bands that split each B tile between them
// by TMA multicast and free a stage only when both blocks' consumers have,
// 66 clusters for the 132 SMs or as many as the card holds at once (15.1
// and 15.4 to 15.6 ms, slower).
//
// Tried on the same card and left out. The variants' code is gone. Of the
// first three only the verdict below was kept: no time of the folded layer
// or of multicast was written down, so none is given.
// - the first layer folded into the second's launch, each consumer thread
//   forming its own wgmma A fragment of h1 in registers: every one of the 16
//   blocks that share 64 rows forms the same h1 again, some 5,000
//   operations a thread on one warp a scheduler, and layers 1 + 2 came
//   out slower than as two launches at one stream and at eight;
// - programmatic dependent launch between the layers (weights prefetched
//   before griddepcontrol.wait): the three launches took 21.7 and 25.7 us at
//   one stream in two runs against 17.9 and 17.5 without it (the early
//   blocks of the next layer take L2 bandwidth and scheduler slots from the
//   64 blocks still running), and 57.9 and 65.8 us against 61.1 and 61.6 at
//   eight streams, inside the run-to-run spread;
// - TMA multicast of the A and B tiles across clusters of 2 x 2 and 4 x 2
//   blocks (a tile crossing from L2 once a cluster): right, and slower at
//   one stream and at eight; the blocks of a cluster then free a stage only
//   when the slowest of them has, and the traffic from L2 was not the limit;
// - setmaxnreg (the accumulators take 64 registers a thread at most,
//   nothing to rebalance); stmatrix + TMA store for the output (the lane
//   swap already gives 8-byte stores from registers, and a staging tile
//   would cost the shared memory the ring uses);
// - K summed as two fixed halves, one block running both into two sets of
//   accumulators or, where the grid is small, the two blocks of a cluster
//   one half each with the second's accumulators handed over through
//   distributed shared memory (every served result stayed equal to the bit):
//   1024 -> 1024 at 224 rows 6.35 us against 6.62, 1024 -> 4096 as 128 x 128
//   split tiles 11.13 against 7.94; twice the blocks with half the bytes
//   each bought almost nothing, so what a block waits for at one stream is
//   not its own bytes from L2;
// - a ring of 2 or 6 stages instead of 4 (kStages): 2 was about a half
//   slower at one stream, 6 a few per cent slower at both.

#include "edge_mlp.cuh"

extern "C" int mdno_edge_mlp(const void* A, const void* B, const float* bias,
                             const float* row_mask, void* C, int M, int N,
                             int K, int relu, int cd_bf16, void* stream) {
  const int rc = edge_mlp::launch(A, B, bias, row_mask, C, M, N, K, relu,
                                  cd_bf16, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : (int)cudaGetLastError();
}

// The whole MLP, three launches:
// ef (M, F), w1 (F, KW), w2 (KW, KW), w3 (KW, N3) and the scratch h1, h2
// (M, KW), kmat (M, N3) in the compute dtype; biases and row_mask f32.
extern "C" int mdno_edge_mlp_stack(const void* ef, const void* w1,
                                   const float* b1, const void* w2,
                                   const float* b2, const void* w3,
                                   const float* b3, const float* row_mask,
                                   void* h1, void* h2, void* kmat, int M,
                                   int KW, int N3, int F, int cd_bf16,
                                   void* stream) {
  const int rc = edge_mlp::launch_stack(
      ef, w1, b1, w2, b2, w3, b3, row_mask, h1, h2, kmat, M, KW, N3, F,
      cd_bf16, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : (int)cudaGetLastError();
}
