// train_conv_fwd: forward of the training conv stack. Per example, the
// 2*depth weight-tied edge convs x <- relu(mean_j(x_j K_e) + x root + bias)
// against one kernel tensor K, saving every layer's activations for the
// backward kernel (train_conv_bwd.cu).
//
// Replaces the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/train_conv.py
// (pallas_tied_conv_stack, forward body _fwd_kernel, call :249). The TPU
// body's one-hot incidence operands, tile layout and 0/1 expansion matmuls
// are how a TPU does a per-edge matvec and a scatter; here the kernel takes
// the int32 edge list and gathers and scatters by index. The cast points
// are those of ops/conv_stack.py: x and the messages are rounded to the
// compute type CD, every sum is f32. K arrives pre-masked (padded rows are
// zero), so no mask is read: a padded slot (src = dst = 0) adds zero.
//
// Bound: bytes. At B=128, E=256, w=64, bf16 the kernel must read K once
// (268 MB) and write the activation stack (12 MB): ~84 us at 3.35 TB/s,
// against 3.2 GFLOP (48 us on the f32 pipes). K of one example is 2 MB in
// bf16 and one SM's shared memory holds 227 KB, so each example is one
// thread-block cluster of 16 blocks (a non-portable size, which Hopper
// allows), each owning E/16 edges: a block copies its slice of K into
// shared memory once, when it fits (bf16 at these shapes; f32 reads K from
// device memory every layer), and all 2*depth layers read it there. A
// layer: each block forms the messages of its edges and sums them per
// target node in edge order; the cluster syncs; each block then owns 1/16
// of the next activations: it adds the cluster's partial sums through
// distributed shared memory in rank order (no atomics, so the result is the
// same in every run), applies root, bias and ReLU, writes them to the stack
// in device memory and into every block's shared memory; the cluster syncs
// again. 128 examples are 128 clusters, more than the card co-schedules, so
// they run in waves.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 227 * 1024;
constexpr int NCL = 16;  // blocks per example (one cluster)

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

template <typename CD>
__global__ void __launch_bounds__(kThreads) train_conv_fwd_kernel(
    const float* __restrict__ x0,       // (B, R, W)
    const CD* __restrict__ K,           // (B, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (B, 2, E)
    const float* __restrict__ inv_deg,  // (B, R)
    const CD* __restrict__ root1, const float* __restrict__ bias1,
    const CD* __restrict__ root2, const float* __restrict__ bias2,
    float* __restrict__ out,            // (B, R, W)
    float* __restrict__ stack,          // (B, 2*depth+1, R, W)
    int R, int W, int E, int depth, int eb, int stage_k) {
  constexpr int V = 4;                  // outputs per message item
  constexpr int V16 = 16 / sizeof(CD);  // CD values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / NCL;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int RW = R * W, G = W / V, L = 2 * depth;

  // shared layout: [K slice (if staged)] [root] xa xb ra rb part msl src dst
  // x* hold the activations, r* the same rounded to CD
  CD* ks_smem = reinterpret_cast<CD*>(smem_raw);
  CD* root_s = ks_smem + (stage_k ? (size_t)eb * W * W : 0);
  float* xa = reinterpret_cast<float*>(root_s + W * W);
  float* xb = xa + RW;
  float* ra = xb + RW;
  float* rb = ra + RW;
  float* part = rb + RW;
  float* msl = part + RW;
  int* src = reinterpret_cast<int*>(msl + eb * W);
  int* dst = src + eb;

  const int e0 = rank * eb;
  const int ne = max(0, min(eb, E - e0));
  for (int i = tid; i < ne; i += nt) {
    src[i] = edges[(size_t)b * 2 * E + e0 + i];
    dst[i] = edges[(size_t)b * 2 * E + E + e0 + i];
  }
  float* stack_b = stack + (size_t)b * (L + 1) * RW;
  for (int i = tid; i < RW; i += nt) {
    const float v = x0[(size_t)b * RW + i];
    xa[i] = v;
    ra[i] = round_cd<CD>(v);
    if (rank == 0) stack_b[i] = v;
  }

  const CD* kg = K + ((size_t)b * E + e0) * W * W;
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

  const float* invd = inv_deg + (size_t)b * R;
  float* xc = xa;
  float* xn = xb;
  float* xr = ra;
  float* xrn = rb;

  for (int layer = 0; layer < L; ++layer) {
    const float* bias = layer < depth ? bias1 : bias2;
    if (layer == 0 || layer == depth) {
      const uint4* from = reinterpret_cast<const uint4*>(layer < depth ? root1 : root2);
      uint4* to = reinterpret_cast<uint4*>(root_s);
      for (int i = tid; i < W * W / V16; i += nt) to[i] = from[i];
    }
    __syncthreads();

    // messages m[e] = cd(x[src[e]]) @ K[e], f32 sums, rounded to CD
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
      for (int j = 0; j < V; ++j) msl[e * W + v0 + j] = round_cd<CD>(acc[j]);
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
    // write x' to the stack and into every block of the cluster
    float* stack_l = stack_b + (size_t)(layer + 1) * RW;
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
      const float o = relu_nan(z);
      const float o_r = round_cd<CD>(o);
      stack_l[idx] = o;
      if (layer == L - 1) out[(size_t)b * RW + idx] = o;
#pragma unroll
      for (int r = 0; r < NCL; ++r) {
        cluster.map_shared_rank(xn, r)[idx] = o;
        cluster.map_shared_rank(xrn, r)[idx] = o_r;
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
}

size_t smem_bytes(int R, int W, int eb, int cd_size, bool stage_k) {
  return (stage_k ? (size_t)eb * W * W * cd_size : 0) + (size_t)W * W * cd_size +
         (size_t)5 * R * W * 4 + (size_t)eb * W * 4 + (size_t)eb * 2 * 4;
}

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the slice
// does not fit shared memory or the card cannot co-schedule the cluster.
template <typename CD>
int launch(const float* x0, const void* K, const int* edges,
           const float* inv_deg, const void* root1, const float* bias1,
           const void* root2, const float* bias2, float* out, float* stack,
           int B, int R, int W, int E, int depth, cudaStream_t st) {
  auto kernel = train_conv_fwd_kernel<CD>;
  const int eb = (E + NCL - 1) / NCL;
  // stage each block's K slice in shared memory when it fits
  const bool stage = smem_bytes(R, W, eb, sizeof(CD), true) <= (size_t)kMaxSmem;
  const size_t smem = smem_bytes(R, W, eb, sizeof(CD), stage);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
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
  config.gridDim = dim3(B * NCL);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&config, kernel, x0, static_cast<const CD*>(K), edges,
                           inv_deg, static_cast<const CD*>(root1), bias1,
                           static_cast<const CD*>(root2), bias2, out, stack, R,
                           W, E, depth, eb, (int)stage);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdno_train_conv_fwd(
    const float* x0, const void* K, const int* edges, const float* inv_deg,
    const void* root1, const float* bias1, const void* root2,
    const float* bias2, float* out, float* stack, int B, int R, int W, int E,
    int depth, int cd_bf16, void* stream) {
  if (B < 1 || R < 1 || E < 1 || depth < 1 || W % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cd_bf16)
    return launch<__nv_bfloat16>(x0, K, edges, inv_deg, root1, bias1, root2,
                                 bias2, out, stack, B, R, W, E, depth, st);
  return launch<float>(x0, K, edges, inv_deg, root1, bias1, root2, bias2, out,
                       stack, B, R, W, E, depth, st);
}
