// edge_mlp: one layer of the edge-kernel MLP, C = act(A @ B + bias) * mask.
//
// Replaces, from the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py
// (persistent_rollout, body _kernel), the edge-kernel MLP 6 -> ker_width ->
// ker_width -> width^2 (:264-280) that the TPU runs on its matrix unit with
// the weights resident in VMEM. Launched three times per rollout step over
// the S*E edge rows; the last launch writes the per-edge kernel matrices K
// with padded edge rows zeroed by the mask (as the TPU kernel does, :280).
//
// Bound: at the bench shapes (M = S*E = 224 rows) the three layers do
// 2.35 GFLOP and must read ~10.5 MB of bf16 weights, about 2.4 us at the
// 989 TFLOP/s bf16 tensor peak and 3.1 us at 3.35 TB/s: the weights' bytes
// bound it, and they stay in the 50 MB L2 from step to step. The bf16 path
// uses tensor cores (WMMA 16x16x16, f32 accumulation) on 64x64 tiles fed
// by a 3-stage cp.async ring; the f32 path (the parity configuration) is a
// shared-memory-tiled FMA kernel, since a full-f32 product has no tensor
// core form. TMA, wgmma and warp specialisation are later work. The
// kernels live in edge_mlp.cuh, which fused_gkn.cu includes too.

#include "edge_mlp.cuh"

extern "C" int mdno_edge_mlp(const void* A, const void* B, const float* bias,
                             const float* row_mask, void* C, int M, int N,
                             int K, int relu, int cd_bf16, void* stream) {
  const int rc = edge_mlp::launch(A, B, bias, row_mask, C, M, N, K, relu,
                                  cd_bf16, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : (int)cudaGetLastError();
}
