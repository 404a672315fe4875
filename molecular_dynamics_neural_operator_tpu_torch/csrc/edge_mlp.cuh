// The edge-kernel MLP layer shared by edge_mlp.cu (the rollout step's three
// launches) and fused_gkn.cu (the fused MLP + conv stack): the bf16 tensor
// core kernel, the f32 FMA kernel and the host function that picks one and
// enqueues it. See edge_mlp.cu for the design and its bound.
#pragma once

#include <cstdint>
#include <mma.h>

#include "common.cuh"

namespace edge_mlp {

using namespace nvcuda;

// ---- bf16: tensor cores ----------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 32, kWmmaThreads = 128, kStages = 3;
constexpr int kFragM = BM / 32;  // 16-row fragments per warp (2 x 2 warps)
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// kVec: K % BK == 0 and 16-byte aligned rows, so tiles arrive by 16-byte
// cp.async copies through a kStages ring that overlaps the next tiles'
// loads with this tile's products; otherwise (the 6-wide first layer)
// element loads with zero fill.
template <bool kVec>
__global__ void __launch_bounds__(kWmmaThreads) edge_mlp_bf16_kernel(
    const __nv_bfloat16* __restrict__ A,   // (M, K)
    const __nv_bfloat16* __restrict__ B,   // (K, N)
    const float* __restrict__ bias,        // (N)
    const float* __restrict__ row_mask,    // (M) or null
    __nv_bfloat16* __restrict__ C,         // (M, N)
    int M, int N, int K, int relu) {
  __shared__ __align__(128) __nv_bfloat16 As[kStages][BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[kStages][BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;  // 2 x 2 warps of BM/2 x 32
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  auto load_async = [&](int stage, int k0) {
    for (int c = tid; c < BM * BK / 8; c += kWmmaThreads) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      const int gm = m0 + r;
      cp_async16(&As[stage][r * LDA + cc],
                 A + (size_t)min(gm, M - 1) * K + k0 + cc, gm < M ? 16 : 0);
    }
    for (int c = tid; c < BK * BN / 8; c += kWmmaThreads) {
      const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      cp_async16(&Bs[stage][r * LDB + cc], B + (size_t)(k0 + r) * N + n0 + cc, 16);
    }
  };
  auto load_sync = [&](int stage, int k0) {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int c = tid; c < BM * BK; c += kWmmaThreads) {
      const int r = c / BK, cc = c % BK;
      const int gm = m0 + r, gk = k0 + cc;
      As[stage][r * LDA + cc] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : zero;
    }
    for (int c = tid; c < BK * BN; c += kWmmaThreads) {
      const int r = c / BN, cc = c % BN;
      const int gk = k0 + r;
      Bs[stage][r * LDB + cc] = gk < K ? B[(size_t)gk * N + n0 + cc] : zero;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][2];
  for (int i = 0; i < kFragM; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if constexpr (kVec) {
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) load_async(st, st * BK);
      cp_async_commit();
    }
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt % kStages;
    if constexpr (kVec) {
      cp_async_wait<kStages - 2>();  // tile kt has landed
      __syncthreads();               // ... for every thread; stage kt-1 is free
      const int pf = kt + kStages - 1;
      if (pf < nk) load_async(pf % kStages, pf * BK);
      cp_async_commit();
    } else {
      load_sync(stage, kt * BK);
      __syncthreads();
    }
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(a[i], &As[stage][(wm * 16 * kFragM + i * 16) * LDA + kk], LDA);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[stage][kk * LDB + wn * 32 + j * 16], LDB);
      for (int i = 0; i < kFragM; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if constexpr (!kVec) __syncthreads();
  }

  for (int i = 0; i < kFragM; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 16 * kFragM + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += kWmmaThreads) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r;
    if (gm >= M) continue;
    float v = Cs[r * LDC + c] + bias[n0 + c];
    if (relu) v = relu_nan(v);
    if (row_mask) v = v * row_mask[gm];
    C[(size_t)gm * N + n0 + c] = __float2bfloat16_rn(v);
  }
}

// ---- f32: shared-memory tiled FMA -----------------------------------------
constexpr int FBM = 64, FBN = 64, FBK = 16, kFmaThreads = 256;

__global__ void __launch_bounds__(kFmaThreads) edge_mlp_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ row_mask,
    float* __restrict__ C, int M, int N, int K, int relu) {
  __shared__ float As[FBK][FBM + 4];  // transposed tile: As[k][m]
  __shared__ float Bs[FBK][FBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4 x 4 outputs each, stride 16
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int idx = tid; idx < FBM * FBK; idx += kFmaThreads) {
      const int r = idx / FBK, c = idx % FBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int idx = tid; idx < FBK * FBN; idx += kFmaThreads) {
      const int r = idx / FBN, c = idx % FBN;
      const int gk = k0 + r;
      Bs[r][c] = gk < K ? B[(size_t)gk * N + n0 + c] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      float v = acc[i][j] + bias[gn];
      if (relu) v = relu_nan(v);
      if (row_mask) v = v * row_mask[gm];
      C[(size_t)gm * N + gn] = v;
    }
  }
}


// Enqueues one layer C = act(A @ B + bias) * row_mask on ``st``; A (M, K),
// B (K, N), C (M, N) in the compute dtype, N a multiple of 64. Returns a
// CUDA error code.
inline int launch(const void* A, const void* B, const float* bias,
                  const float* row_mask, void* C, int M, int N, int K,
                  int relu, int cd_bf16, cudaStream_t st) {
  if (M < 1 || K < 1 || N % BN != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  const dim3 fgrid(N / FBN, (M + FBM - 1) / FBM);
  if (cd_bf16) {
    const auto* a = static_cast<const __nv_bfloat16*>(A);
    const auto* b = static_cast<const __nv_bfloat16*>(B);
    auto* c = static_cast<__nv_bfloat16*>(C);
    const bool vec = K % BK == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(B) % 16 == 0;
    if (vec)
      edge_mlp_bf16_kernel<true><<<grid, kWmmaThreads, 0, st>>>(a, b, bias, row_mask, c, M, N, K, relu);
    else
      edge_mlp_bf16_kernel<false><<<grid, kWmmaThreads, 0, st>>>(a, b, bias, row_mask, c, M, N, K, relu);
  } else {
    edge_mlp_f32_kernel<<<fgrid, kFmaThreads, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), bias,
        row_mask, static_cast<float*>(C), M, N, K, relu);
  }
  return (int)cudaGetLastError();
}

}  // namespace edge_mlp
