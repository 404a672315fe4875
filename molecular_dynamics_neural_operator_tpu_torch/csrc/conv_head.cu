// conv_head: the 2*depth weight-tied edge convs, the fc2 head and the
// window slide of one rollout step.
//
// Replaces, from the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py
// (persistent_rollout, body _kernel): the 2*depth tied mean-aggregation
// conv layers (:282-321), the fc2 head with the delta / damped-extrapolate
// prior and clip, and the window slide (:323-347), per stream (:350-355).
// The math follows the XLA path (models/gkn.py::gkn_apply_single), not the
// TPU body: fc2 runs in f32 and head_scale multiplies its output.
//
// Bound: every layer contracts the stream's whole kernel tensor K (E, w, w):
// 1.84 MB in bf16 at the bench shapes, against 22 MFLOP for all 12 layers.
// Read once from device memory K takes ~0.55 us at 3.35 TB/s, so bytes
// bound it. What an H100 makes scarce is something else. Every element of K
// meets one operand a layer (a matrix-vector product, nothing to reuse), so
// a layer costs one pass over K wherever it lives, and the 12 layers are
// dependent, so each also costs an exchange of x across the stream's SMs.
// On the TPU K sat in VMEM across the layers. Here one SM's shared memory
// cannot hold it, so each stream is one thread-block cluster, of 8 blocks
// (the narrow plan) or of 16 (the wide plan). Edges are dealt to blocks by
// target node, so a block owns the whole sum of each node it owns. In bf16
// (conv_stack.cuh, run_mma) the products run on the tensor cores with K_e^T
// as the mma's A operand, a warp per (node, 32 columns); a block's ~26 K
// rows live in its registers (the first 4 edges of each node, about 14
// rows) and in shared memory (the rest, swizzled for ldmatrix), so a layer
// reads about half of the slice from shared memory, 128 bytes a clock; and
// x' crosses the cluster as counted stores against an mbarrier per x
// buffer, with no cluster barrier between the layers. Rank 0 then runs the
// head and slides the window in place.
//
// The narrow plan at one stream leaves 124 of the card's 132 SMs idle, and
// its 12 dependent layers wait on their longest item. The wide plan halves
// both the slice a block loads and the longest item: 16 blocks a stream, a
// warp per (node, 16 columns), four a node, each keeping 8 edges in
// registers (conv_stack.cuh, run_mma<kWideNCL>). Both plans deal the nodes
// by in-degree back and forth over the blocks (conv_stack.cuh, deal()). The
// wide plan's sums are the narrow plan's, term for term, in the same order:
// the bits are the same. It runs while the card holds every stream's
// 16-block cluster at once (ops/cuda/persistent_rollout.py::conv_head_plan,
// from cudaOccupancyMaxActiveClusters of the wide launch, asked once a
// shape): an H100 holds 15 clusters of 8 and 7 of 16 at the bench shapes,
// so 1, 2 and 4 streams go wide and 8 stay narrow, where 16-block clusters
// would take two waves (50.6 us against 38.2). run_fma (f32, other widths)
// has only the narrow plan.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/
// port_conv_stack_profile.py for the SM clocks): at one stream 28.2 us wide
// against 39.1 narrow (the CUDA-core body before them 60.0, the first
// port's 16-block clusters 74.6), 28.0 and 28.1 at 2 and 4 streams (narrow
// 39.0, 38.7), 38.2 narrow at 8; at 80 residues and 1,024 slots 133.8
// against 330.9 (at 8 streams the wide plan's two waves, 283.8, beat the
// narrow 378.6 there: the rule does not see that). Of a wide call's 46,500
// SM clocks (profiled; narrow in brackets, 67,200) the prologue takes
// 11,900 (13,700): degrees 2,900 (2,850), the deal 1,650 (1,600), edge
// lists 2,300 (2,050), the K rows from L2 and x0 5,100 (7,200); and a layer
// 2,830 (4,400), of which block 0's first warp waits for x' 820 (1,150);
// layer 3's longest item ends 2,610 clocks after its first warp is ready
// (4,900), the median 2,260 (3,840).
// Tried in the narrow plan and dropped, none faster on the card: the
// block's edges dealt round four warps whatever their node, with partial
// sums joined after a 128-thread barrier (balanced, and 48 us: each warp's
// messages then run one after the other); a spare pair of warps taking
// half of the largest node's edges; two staged edges in flight a warp (and
// again with the deal by in-degree: conv_stack.cuh's note above run_mma);
// 2 or 3 edges a warp in registers instead of 4 (1.7 and 0.7 us slower at
// one stream; 5 spill); 512 threads with a warp per (node, 16 columns) (46
// us); the cluster barrier between layers (52 us); and on CUDA cores (the
// body f32 still runs, 60 us): 1,024 threads, K rows in registers, the
// per-node sum by the last finisher. In the wide plan: 4 or 6 edges a warp
// in registers (0.5 to 0.7 and 0.4 to 0.6 us slower than 8), and the greedy
// deal the frame had before, even with each step's least key taken across
// lanes (2.5 us slower than the deal by in-degree; at 8 narrow streams 8.2
// us slower: conv_stack.cuh, deal()).

#include "conv_stack.cuh"

namespace {

template <typename CD, bool MMA, int NB = conv_stack::NCL>
__global__ void __launch_bounds__(
    MMA ? conv_stack::kMmaThreads : conv_stack::kThreads, 1) conv_head_kernel(
    const float* __restrict__ x0,       // (S, R, W)
    const CD* __restrict__ K,           // (S, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (S, 2, E)
    const float* __restrict__ mask,     // (S, E)
    const float* __restrict__ inv_deg,  // (S, R)
    const CD* __restrict__ root1, const float* __restrict__ bias1,
    const CD* __restrict__ root2, const float* __restrict__ bias2,
    const float* __restrict__ fc2_w,    // (W, 3)
    const float* __restrict__ fc2_b,    // (3)
    float* __restrict__ window,         // (S, T, R, 3), slid in place
    float* __restrict__ coords,         // (S, R, 3), this step's output
    int R, int W, int E, int T, int depth, int cap,
    int predict_delta, float head_scale, int extrapolate, float gamma,
    int has_clip, float clip) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const float* xc = conv_stack::run<CD, MMA, NB>(
      smem_raw, x0, K, edges, mask, inv_deg, root1, bias1, root2, bias2, R, W,
      E, depth, cap);
  const auto cluster = cooperative_groups::this_cluster();
  if (cluster.block_rank() != 0) return;
  const int s = blockIdx.x / (int)cluster.num_blocks();
  const int tid = threadIdx.x, nt = blockDim.x;
  float* win = window + (size_t)s * T * R * 3;
  const int F = R * 3;
  for (int idx = tid; idx < F; idx += nt) {
    const int r = idx / 3, c = idx % 3;
    float o = 0.f;
    for (int k = 0; k < W; ++k) o = fmaf(xc[r * W + k], fc2_w[k * 3 + c], o);
    o = __fadd_rn(o, fc2_b[c]);
    const float last = win[(size_t)(T - 1) * F + idx];
    if (predict_delta) {
      float prior = last;
      if (extrapolate) {
        const float prev = win[(size_t)(T - 2) * F + idx];
        prior = __fadd_rn(last, __fmul_rn(gamma, __fsub_rn(last, prev)));
      }
      o = __fadd_rn(__fmul_rn(head_scale, o), prior);
    }
    if (has_clip) o = o < -clip ? -clip : (o > clip ? clip : o);
    // each thread owns element idx of every frame: the slide needs no barrier
    for (int t = 0; t < T - 1; ++t) win[(size_t)t * F + idx] = win[(size_t)(t + 1) * F + idx];
    win[(size_t)(T - 1) * F + idx] = o;
    coords[(size_t)s * F + idx] = o;
  }
}

// fn(the kernel of the plan, narrow or wide), with *p that plan;
// cudaErrorInvalidValue for the wide plan of a shape that runs run_fma.
template <typename CD, typename Fn>
int with_kernel(int R, int W, int E, bool wide, conv_stack::Plan* p, Fn&& fn) {
  const int rc = conv_stack::plan(R, W, E, sizeof(CD), p);
  if (rc != 0) return rc;
  if (wide && !p->mma) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(CD) == 2) {
    if (wide) {
      p->ncl = conv_stack::kWideNCL;
      return fn(conv_head_kernel<CD, true, conv_stack::kWideNCL>);
    }
    if (p->mma) return fn(conv_head_kernel<CD, true>);
  }
  return fn(conv_head_kernel<CD, false>);
}

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the slice
// does not fit shared memory or the card cannot co-schedule the cluster.
template <typename CD>
int launch(const float* x0, const void* K, const int* edges, const float* mask,
           const float* inv_deg, const void* root1, const float* bias1,
           const void* root2, const float* bias2, const float* fc2_w,
           const float* fc2_b, float* window, float* coords, int S, int R,
           int W, int E, int T, int depth, int predict_delta, float head_scale,
           int extrapolate, float gamma, int has_clip, float clip, bool wide,
           cudaStream_t st) {
  conv_stack::Plan p;
  return with_kernel<CD>(R, W, E, wide, &p, [&](auto kernel) {
    return conv_stack::launch_clusters(
        kernel, S, p, st, x0, static_cast<const CD*>(K), edges, mask, inv_deg,
        static_cast<const CD*>(root1), bias1, static_cast<const CD*>(root2),
        bias2, fc2_w, fc2_b, window, coords, R, W, E, T, depth, p.cap,
        predict_delta, head_scale, extrapolate, gamma, has_clip, clip);
  });
}

}  // namespace

// How many of the conv stack's clusters (one a stream) the card holds at
// once, at these shapes: what cudaOccupancyMaxActiveClusters says of the
// launch mdno_conv_head makes with the same ``wide``; 0 for the wide plan
// of a shape that runs run_fma, which has none.
extern "C" int mdno_conv_head_clusters(int R, int W, int E, int cd_bf16,
                                       int wide, int* out) {
  conv_stack::Plan p;
  const int rc = conv_stack::plan(R, W, E, cd_bf16 ? 2 : 4, &p);
  if (rc != 0) return rc;
  if (wide && !p.mma) {
    *out = 0;
    return 0;
  }
  auto count = [&](auto kernel) {
    return conv_stack::max_active_clusters(kernel, p, out);
  };
  return cd_bf16 ? with_kernel<__nv_bfloat16>(R, W, E, wide, &p, count)
                 : with_kernel<float>(R, W, E, wide, &p, count);
}

#ifdef MDNO_CONV_PROFILE
// The clock marks of the last launch's block 0 (conv_stack.cuh), 64 values.
extern "C" int mdno_conv_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, conv_stack::conv_profile,
                                   sizeof(long long) * 64);
}

// Layer 3 of the last launch's stream 0 by block and warp (conv_stack.cuh),
// kWideNCL * 32 * 8 values, of which a narrow launch fills the first
// NCL * 32 * 8.
extern "C" int mdno_conv_warp_profile(long long* out) {
  return (int)cudaMemcpyFromSymbol(
      out, conv_stack::conv_warp_profile,
      sizeof(long long) * conv_stack::kWideNCL * 32 * 8);
}
#endif

extern "C" int mdno_conv_head(
    const float* x0, const void* K, const int* edges, const float* mask,
    const float* inv_deg, const void* root1, const float* bias1,
    const void* root2, const float* bias2, const float* fc2_w,
    const float* fc2_b, float* window, float* coords, int S, int R, int W,
    int E, int T, int depth, int predict_delta, float head_scale,
    int extrapolate, float gamma, int has_clip, float clip, int cd_bf16,
    int wide, void* stream) {
  if (S < 1 || R < 1 || T < 1 || W % 8 != 0 ||
      (predict_delta && extrapolate && T < 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      cd_bf16
          ? launch<__nv_bfloat16>(x0, K, edges, mask, inv_deg, root1, bias1,
                                  root2, bias2, fc2_w, fc2_b, window, coords,
                                  S, R, W, E, T, depth, predict_delta,
                                  head_scale, extrapolate, gamma, has_clip,
                                  clip, wide != 0, st)
          : launch<float>(x0, K, edges, mask, inv_deg, root1, bias1, root2,
                          bias2, fc2_w, fc2_b, window, coords, S, R, W, E, T,
                          depth, predict_delta, head_scale, extrapolate, gamma,
                          has_clip, clip, wide != 0, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
