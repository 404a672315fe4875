// train_conv_bwd: backward of the training conv stack. Per example, the
// reverse sweep over the 2*depth weight-tied edge convs from the saved
// activation stack: the relu mask, droot and dbias, the message gradient
// dm, dx through K and root, and the kernel-tensor gradient
// dK = sum_l xs_l (x) dm_l.
//
// Replaces the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/train_conv.py
// (pallas_tied_conv_stack, backward body _bwd_kernel, call :287). The cast
// points are those of ops/conv_stack.py: x_in, dz, dagg = dz * inv_deg
// (hence dm) and dxs are rounded to the compute type CD where they enter a
// product, every sum is f32, the relu mask is taken from the saved f32
// activations (x_out > 0), and dK is summed in f32 over the layers, in
// layer order, and rounded once to K's type. K arrives pre-masked and no
// mask is read: dK of a padded slot (src = dst = 0) is xs (x) dm of node 0,
// as in the TPU kernel; the caller's mask zeroes it one step later.
// droot and dbias come out per example and are summed over the batch
// outside, as the TPU wrapper does. No atomics anywhere.
//
// Bound: bytes. At B=128, E=256, w=64, bf16 the kernel must read K (268 MB)
// and the stack (12 MB) and write dK (268 MB): ~164 us at 3.35 TB/s,
// against ~6.4 GFLOP (~100 us on the f32 pipes). As in the forward kernel
// each example is one cluster of 16 blocks, each owning E/16 edges with its
// slice of K staged once in shared memory (bf16; f32 reads K from device
// memory every layer). An f32 dK accumulator for the slice (256 KB) does
// not fit beside K, so none is kept: a block stores dm_l of its edges for
// all layers (CD, 24 KB) and, after the sweep, re-gathers xs_l from the
// stack into the space K held and forms each edge's dK as one
// (w x L) (L x w) product in 4 x 4 register tiles, written once. The work
// per layer is small and one block fills an SM's shared memory, so what
// bounds the kernel in practice is latency, not bytes: blocks have 512
// threads to hide more of it. A layer: every block recomputes
// dz for all nodes (tiny); forms dxs of its edges (each thread walks one
// row of K, starting at the word of its row index and wrapping around, so
// that a warp's reads fall in distinct shared-memory banks) and sums them per source node in edge
// order; the cluster syncs; each block then owns 1/16 of the next dx: it
// adds the cluster's partial sums through distributed shared memory in
// rank order, adds dz @ root^T, and writes the result into every block;
// the cluster syncs again. droot is split over the cluster's threads, one
// element each, accumulated in a register over the layers.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
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

// Four floats rounded to CD and stored at p (16-byte aligned for f32,
// 8-byte for bf16).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&lo);
  raw.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The CD values of one 4-byte word as floats: one f32 or two bf16.
__device__ __forceinline__ void load_word(const float* p, float* out) { out[0] = *p; }

__device__ __forceinline__ void load_word(const __nv_bfloat16* p, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = a.x;
  out[1] = a.y;
}

template <typename CD>
__global__ void __launch_bounds__(kThreads) train_conv_bwd_kernel(
    const float* __restrict__ g_out,    // (B, R, W)
    const float* __restrict__ stack,    // (B, 2*depth+1, R, W)
    const CD* __restrict__ K,           // (B, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (B, 2, E)
    const float* __restrict__ inv_deg,  // (B, R)
    const CD* __restrict__ root1, const CD* __restrict__ root2,
    float* __restrict__ dx0,            // (B, R, W)
    CD* __restrict__ dK,                // (B, E, W*W)
    float* __restrict__ droot1,         // (B, W, W)
    float* __restrict__ dbias1,         // (B, W)
    float* __restrict__ droot2, float* __restrict__ dbias2,
    int R, int W, int E, int depth, int eb, int stage_k, int region0) {
  constexpr int V = 4;                  // a dK item is a V x V tile
  constexpr int P = 4 / sizeof(CD);     // CD values per 4-byte word
  constexpr int V16 = 16 / sizeof(CD);  // CD values per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / NCL;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int RW = R * W, G = W / V, L = 2 * depth;

  // shared layout: [region0: K slice in the sweep, xs_l after it] [root^T]
  // [dm_l] dxa dxb dzf dzr daggr xinr part msl src dst
  CD* ks_smem = reinterpret_cast<CD*>(smem_raw);
  CD* rootT_s = reinterpret_cast<CD*>(smem_raw + region0);
  CD* dm_s = rootT_s + W * W;
  float* dxa = reinterpret_cast<float*>(dm_s + (size_t)L * eb * W);
  float* dxb = dxa + RW;
  float* dzf = dxb + RW;
  float* dzr = dzf + RW;
  float* daggr = dzr + RW;
  float* xinr = daggr + RW;
  float* part = xinr + RW;
  float* msl = part + RW;
  int* src = reinterpret_cast<int*>(msl + eb * W);
  int* dst = src + eb;

  const int e0 = rank * eb;
  const int ne = max(0, min(eb, E - e0));
  for (int i = tid; i < ne; i += nt) {
    src[i] = edges[(size_t)b * 2 * E + e0 + i];
    dst[i] = edges[(size_t)b * 2 * E + E + e0 + i];
  }
  for (int i = tid; i < RW; i += nt) dxa[i] = g_out[(size_t)b * RW + i];

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
  const int nb_out = (RW + NCL - 1) / NCL;  // dx elements each block reduces
  const int n_root = W * W / NCL;           // droot elements each block owns
  const int ro = rank * n_root + tid;       // this thread's droot element
  const int ro_wi = ro / W, ro_v = ro % W;
  const bool owns_root = tid < n_root;
  const bool owns_bias = rank == 0 && tid < W;
  float dr_acc = 0.f, db_acc = 0.f;

  const float* invd = inv_deg + (size_t)b * R;
  const float* stack_b = stack + (size_t)b * (L + 1) * RW;
  float* dxc = dxa;
  float* dxn = dxb;

  for (int layer = L - 1; layer >= 0; --layer) {
    if (layer == L - 1 || layer == depth - 1) {
      if (layer == depth - 1) {  // conv2's layers are done
        if (owns_root) droot2[(size_t)b * W * W + ro] = dr_acc;
        if (owns_bias) dbias2[(size_t)b * W + tid] = db_acc;
        dr_acc = 0.f;
        db_acc = 0.f;
      }
      const CD* root = layer < depth ? root1 : root2;
      for (int i = tid; i < W * W; i += nt) rootT_s[(i % W) * W + i / W] = root[i];
    }
    // dz = dx * (x_out > 0), and what enters the products, rounded to CD
    const float* x_in = stack_b + (size_t)layer * RW;
    const float* x_out = x_in + RW;
    for (int i = tid; i < RW; i += nt) {
      const float dz = __fmul_rn(dxc[i], x_out[i] > 0.f ? 1.f : 0.f);
      dzf[i] = dz;
      dzr[i] = round_cd<CD>(dz);
      daggr[i] = round_cd<CD>(__fmul_rn(dz, invd[i / W]));
      xinr[i] = round_cd<CD>(x_in[i]);
    }
    __syncthreads();

    // droot[wi, v] += sum_i cd(x_in[i, wi]) cd(dz[i, v]); dbias[v] += sum_i dz
    if (owns_root)
      for (int i = 0; i < R; ++i)
        dr_acc = fmaf(xinr[i * W + ro_wi], dzr[i * W + ro_v], dr_acc);
    if (owns_bias)
      for (int i = 0; i < R; ++i) db_acc += dzf[i * W + tid];

    // dm[e] = cd(dagg[dst[e]]), kept for dK; dxs[e, wi] = sum_v dm[e, v]
    // K[e, wi, v], rounded to CD
    CD* dm_l = dm_s + (size_t)layer * eb * W;
    for (int item = tid; item < ne * W; item += nt) {
      const int e = item / W, v = item % W;
      dm_l[item] = from_f32<CD>(daggr[dst[e] * W + v]);
    }
    const int nw = W / P;  // 4-byte words in a row of K
    for (int item = tid; item < ne * W; item += nt) {
      const int e = item / W, wi = item - e * W;
      const float* dm = daggr + dst[e] * W;
      const CD* kp = kb + (size_t)e * W * W + (size_t)wi * W;
      float acc = 0.f;
      int cw = wi % nw;  // start at word wi of the row, wrap around
#pragma unroll 8
      for (int jj = 0; jj < nw; ++jj) {
        float kv[P];
        load_word(kp + cw * P, kv);
        for (int p = 0; p < P; ++p) acc = fmaf(dm[cw * P + p], kv[p], acc);
        cw = cw + 1 == nw ? 0 : cw + 1;
      }
      msl[item] = round_cd<CD>(acc);
    }
    __syncthreads();

    // per-source sums over this block's edges: one thread per column
    // walks the edges in order
    for (int i = tid; i < RW; i += nt) part[i] = 0.f;
    __syncthreads();
    for (int wi = tid; wi < W; wi += nt)
      for (int e = 0; e < ne; ++e) part[src[e] * W + wi] += msl[e * W + wi];
    cluster.sync();

    // this block's share of the next dx: dz @ root^T plus the cluster's
    // partial sums in rank order, written into every block of the cluster
    for (int idx = rank * nb_out + tid; idx < min(RW, (rank + 1) * nb_out);
         idx += nt) {
      const int i = idx / W, wi = idx % W;
      float agg = 0.f;
#pragma unroll
      for (int r = 0; r < NCL; ++r) agg += cluster.map_shared_rank(part, r)[idx];
      float rx = 0.f;
      const float* dzi = dzr + i * W;
#pragma unroll 8
      for (int v = 0; v < W; ++v) rx = fmaf(dzi[v], to_f32<CD>(rootT_s[v * W + wi]), rx);
      const float o = __fadd_rn(rx, agg);
#pragma unroll
      for (int r = 0; r < NCL; ++r) cluster.map_shared_rank(dxn, r)[idx] = o;
    }
    cluster.sync();  // dx complete everywhere; partial sums free again
    float* t = dxc;
    dxc = dxn;
    dxn = t;
  }

  if (owns_root) droot1[(size_t)b * W * W + ro] = dr_acc;
  if (owns_bias) dbias1[(size_t)b * W + tid] = db_acc;
  for (int idx = rank * nb_out + tid; idx < min(RW, (rank + 1) * nb_out); idx += nt)
    dx0[(size_t)b * RW + idx] = dxc[idx];

  // dK[e] = sum_l cd(x_l[src[e]]) (x) dm_l[e]: gather xs_l into the space K
  // held, then one (W x L) (L x W) product per edge, summed over the layers
  // in order and written once
  CD* xs_s = ks_smem;
  for (int l = 0; l < L; ++l)
    for (int rem = tid; rem < ne * W; rem += nt) {
      const int e = rem / W, wi = rem - e * W;
      xs_s[((size_t)l * eb + e) * W + wi] =
          from_f32<CD>(stack_b[(size_t)l * RW + src[e] * W + wi]);
    }
  __syncthreads();
  // each item is a 4 x 4 tile of one edge's dK: two 4-wide loads feed 16
  // products per layer
  CD* dkg = dK + ((size_t)b * E + e0) * W * W;
  for (int item = tid; item < ne * G * G; item += nt) {
    const int e = item / (G * G), t = item - e * G * G;
    const int wi0 = (t / G) * V, v0 = (t % G) * V;
    float acc[V][V];
    for (int a = 0; a < V; ++a)
      for (int j = 0; j < V; ++j) acc[a][j] = 0.f;
    for (int l = 0; l < L; ++l) {
      const size_t row = ((size_t)l * eb + e) * W;
      float xv[V], dv[V];
      load4(xs_s + row + wi0, xv);
      load4(dm_s + row + v0, dv);
      for (int a = 0; a < V; ++a)
        for (int j = 0; j < V; ++j) acc[a][j] = fmaf(xv[a], dv[j], acc[a][j]);
    }
    for (int a = 0; a < V; ++a)
      store4(dkg + (size_t)e * W * W + (size_t)(wi0 + a) * W + v0, acc[a]);
  }
}

size_t region0_bytes(int W, int eb, int L, int cd_size, bool stage_k) {
  const size_t k = stage_k ? (size_t)eb * W * W * cd_size : 0;
  const size_t xs = (size_t)L * eb * W * cd_size;
  return k > xs ? k : xs;
}

size_t smem_bytes(int R, int W, int eb, int L, int cd_size, bool stage_k) {
  return region0_bytes(W, eb, L, cd_size, stage_k) + (size_t)W * W * cd_size +
         (size_t)L * eb * W * cd_size + (size_t)7 * R * W * 4 +
         (size_t)eb * W * 4 + (size_t)eb * 2 * 4;
}

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the slice
// does not fit shared memory or the card cannot co-schedule the cluster.
template <typename CD>
int launch(const float* g_out, const float* stack, const void* K,
           const int* edges, const float* inv_deg, const void* root1,
           const void* root2, float* dx0, void* dK, float* droot1,
           float* dbias1, float* droot2, float* dbias2, int B, int R, int W,
           int E, int depth, cudaStream_t st) {
  auto kernel = train_conv_bwd_kernel<CD>;
  const int eb = (E + NCL - 1) / NCL;
  const int L = 2 * depth;
  // stage each block's K slice in shared memory when it fits
  const bool stage = smem_bytes(R, W, eb, L, sizeof(CD), true) <= (size_t)kMaxSmem;
  const size_t smem = smem_bytes(R, W, eb, L, sizeof(CD), stage);
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
  err = cudaLaunchKernelEx(
      &config, kernel, g_out, stack, static_cast<const CD*>(K), edges, inv_deg,
      static_cast<const CD*>(root1), static_cast<const CD*>(root2), dx0,
      static_cast<CD*>(dK), droot1, dbias1, droot2, dbias2, R, W, E, depth, eb,
      (int)stage, (int)region0_bytes(W, eb, L, sizeof(CD), stage));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mdno_train_conv_bwd(
    const float* g_out, const float* stack, const void* K, const int* edges,
    const float* inv_deg, const void* root1, const void* root2, float* dx0,
    void* dK, float* droot1, float* dbias1, float* droot2, float* dbias2,
    int B, int R, int W, int E, int depth, int cd_bf16, void* stream) {
  // each of the cluster's threads owns at most one element of droot
  if (B < 1 || R < 1 || E < 1 || depth < 1 || W % 8 != 0 ||
      W * W > NCL * kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cd_bf16)
    return launch<__nv_bfloat16>(g_out, stack, K, edges, inv_deg, root1, root2,
                                 dx0, dK, droot1, dbias1, droot2, dbias2, B, R,
                                 W, E, depth, st);
  return launch<float>(g_out, stack, K, edges, inv_deg, root1, root2, dx0, dK,
                       droot1, dbias1, droot2, dbias2, B, R, W, E, depth, st);
}
