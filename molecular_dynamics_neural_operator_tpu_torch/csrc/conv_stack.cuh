// The 2*depth weight-tied edge convs of one stream on one thread-block
// cluster, shared by conv_head.cu (the rollout step: stack, head, slide) and
// fused_gkn.cu (the fused MLP + conv stack, no head). See conv_head.cu for
// the design and its bound.
//
// One stream is one cluster of NCL blocks, each owning E/NCL edges: a block
// copies its slice of K into shared memory once, when it fits (bf16 at the
// bench shapes; an f32 K of 224 edges does not, and is read from L2), and
// all 2*depth layers then read it there. A layer: each block forms the
// messages of its edges and sums them per target node in edge order; the
// cluster syncs; each block then owns 1/NCL of the next node features: it
// adds the cluster's partial sums for them through distributed shared
// memory in rank order (deterministic, no atomics), applies root, bias and
// ReLU, and writes them into every block's shared memory; the cluster syncs
// again. The math follows the XLA path (models/gkn.py::gkn_apply_single):
// gathered rows, messages and the root product's operands are rounded to
// CD, every sum is f32.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace conv_stack {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int NCL = 16;  // blocks per stream (one cluster)

// Four consecutive CD values as floats (16 bytes of f32, 8 of bf16).
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

// Runs the 2*depth layers of stream blockIdx.x / NCL. Every thread of every
// block of the cluster calls it. Returns the final node features (R, W) f32
// in this block's shared memory, complete in every block of the cluster
// (the last cluster sync has passed).
template <typename CD>
__device__ float* run(
    unsigned char* smem_raw,
    const float* __restrict__ x0,       // (S, R, W)
    const CD* __restrict__ K,           // (S, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (S, 2, E)
    const float* __restrict__ mask,     // (S, E)
    const float* __restrict__ inv_deg,  // (S, R)
    const CD* __restrict__ root1, const float* __restrict__ bias1,
    const CD* __restrict__ root2, const float* __restrict__ bias2,
    int R, int W, int E, int depth, int eb, int stage_k) {
  constexpr int V = 4;     // outputs per message item
  constexpr int V16 = 16 / sizeof(CD);  // CD values per 16-byte copy
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int s = blockIdx.x / NCL;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int RW = R * W, G = W / V;

  // shared layout: [K slice (if staged)] [root] xa xb ra rb part msl msk
  // src dst; x* hold node features, r* the same rounded to CD
  CD* ks_smem = reinterpret_cast<CD*>(smem_raw);
  CD* root_s = ks_smem + (stage_k ? (size_t)eb * W * W : 0);
  float* xa = reinterpret_cast<float*>(root_s + W * W);
  float* xb = xa + RW;
  float* ra = xb + RW;
  float* rb = ra + RW;
  float* part = rb + RW;
  float* msl = part + RW;
  float* msk = msl + eb * W;
  int* src = reinterpret_cast<int*>(msk + eb);
  int* dst = src + eb;

  const int e0 = rank * eb;
  const int ne = max(0, min(eb, E - e0));
  for (int i = tid; i < ne; i += nt) {
    src[i] = edges[(size_t)s * 2 * E + e0 + i];
    dst[i] = edges[(size_t)s * 2 * E + E + e0 + i];
    msk[i] = mask[(size_t)s * E + e0 + i];
  }
  for (int i = tid; i < RW; i += nt) {
    xa[i] = x0[(size_t)s * RW + i];
    ra[i] = round_cd<CD>(xa[i]);
  }

  const CD* kg = K + ((size_t)s * E + e0) * W * W;
  const CD* kb = kg;
  if (stage_k) {
    const uint4* from = reinterpret_cast<const uint4*>(kg);
    uint4* to = reinterpret_cast<uint4*>(ks_smem);
    const int n16 = ne * W * W / V16;
#pragma unroll 4
    for (int i = tid; i < n16; i += nt) to[i] = from[i];
    kb = ks_smem;
  }
  const int nb_out = (RW + NCL - 1) / NCL;  // outputs each block reduces

  const float* invd = inv_deg + (size_t)s * R;
  float* xc = xa;
  float* xn = xb;
  float* xr = ra;
  float* xrn = rb;

  // with no layer to run, the barrier that orders the loads above
  if (depth <= 0) __syncthreads();
  for (int layer = 0; layer < 2 * depth; ++layer) {
    const float* bias = layer < depth ? bias1 : bias2;
    if (layer == 0 || layer == depth) {
      const uint4* from = reinterpret_cast<const uint4*>(layer < depth ? root1 : root2);
      uint4* to = reinterpret_cast<uint4*>(root_s);
      for (int i = tid; i < W * W / V16; i += nt) to[i] = from[i];
    }
    __syncthreads();

    // messages m[e] = cd(x[src[e]]) @ K[e], f32 sums, masked, rounded to CD
    for (int item = tid; item < ne * G; item += nt) {
      const int e = item / G, v0 = (item % G) * V;
      const float* xs = xr + src[e] * W;
      const CD* kp = kb + (size_t)e * W * W + v0;
      float acc[V];
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 8
      for (int wi = 0; wi < W; ++wi) {
        float kv[V];
        load4(kp + wi * W, kv);
        const float xv = xs[wi];
        for (int j = 0; j < V; ++j) acc[j] = fmaf(xv, kv[j], acc[j]);
      }
      for (int j = 0; j < V; ++j) msl[e * W + v0 + j] = round_cd<CD>(acc[j] * msk[e]);
    }
    __syncthreads();

    // per-target sums over this block's edges: one thread per column
    // walks the edges in order
    for (int i = tid; i < RW; i += nt) part[i] = 0.f;
    __syncthreads();
    for (int v = tid; v < W; v += nt)
      for (int e = 0; e < ne; ++e) part[dst[e] * W + v] += msl[e * W + v];
    cluster.sync();

    // this block's share of the outputs: add the cluster's partial sums in
    // rank order, x' = relu(agg * inv_deg + cd(x) @ cd(root) + bias), and
    // write x' into every block of the cluster
    for (int idx = rank * nb_out + tid; idx < min(RW, (rank + 1) * nb_out);
         idx += nt) {
      const int j = idx / W, v = idx % W;
      float agg = 0.f;
#pragma unroll
      for (int r = 0; r < NCL; ++r) agg += cluster.map_shared_rank(part, r)[idx];
      float rx = 0.f;
      const float* xj = xr + j * W;
#pragma unroll 8
      for (int wi = 0; wi < W; ++wi) rx = fmaf(xj[wi], to_f32<CD>(root_s[wi * W + v]), rx);
      const float z = __fadd_rn(__fadd_rn(__fmul_rn(agg, invd[j]), rx), bias[v]);
      const float out = relu_nan(z);
      const float out_r = round_cd<CD>(out);
#pragma unroll
      for (int r = 0; r < NCL; ++r) {
        cluster.map_shared_rank(xn, r)[idx] = out;
        cluster.map_shared_rank(xrn, r)[idx] = out_r;
      }
    }
    cluster.sync();  // x' complete everywhere; partial sums free again
    float* t = xc;
    xc = xn;
    xn = t;
    t = xr;
    xr = xrn;
    xrn = t;
  }
  return xc;
}

inline size_t smem_bytes(int R, int W, int eb, int cd_size, bool stage_k) {
  return (stage_k ? (size_t)eb * W * W * cd_size : 0) + (size_t)W * W * cd_size +
         (size_t)5 * R * W * 4 + (size_t)eb * W * 4 + (size_t)eb * 3 * 4;
}

// The launch shape of a kernel that calls run(): edges per block, whether
// the K slice is staged, and the dynamic shared memory.
struct Plan {
  int eb;
  int stage_k;
  size_t smem;
};

// cudaErrorInvalidConfiguration when the slice does not fit shared memory.
inline int plan(int R, int W, int E, int cd_size, Plan* out) {
  out->eb = (E + NCL - 1) / NCL;
  // stage each block's K slice in shared memory when it fits
  out->stage_k = smem_bytes(R, W, out->eb, cd_size, true) <= (size_t)kMaxSmem;
  out->smem = smem_bytes(R, W, out->eb, cd_size, out->stage_k != 0);
  return out->smem > (size_t)kMaxSmem ? (int)cudaErrorInvalidConfiguration : 0;
}

// Launches ``kernel`` as S clusters of NCL blocks with ``smem`` bytes of
// dynamic shared memory on ``st``. Returns a CUDA error code;
// cudaErrorInvalidConfiguration when the card cannot co-schedule the cluster.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int S, size_t smem,
                    cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(S * NCL);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace conv_stack
