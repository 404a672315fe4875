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
// bound it. On the TPU K sat in VMEM across the layers. Here one SM's
// shared memory cannot hold it, so each stream is one thread-block cluster
// of 16 blocks (a non-portable cluster size, which Hopper allows), each
// owning E/16 edges: a block copies its slice of K into shared memory once, when
// it fits (bf16 at the bench shapes), and all 2*depth layers then read it
// there instead of from L2. A layer: each block forms the messages of its
// edges and sums them per target node in edge order;
// the cluster syncs; each block then owns 1/16 of the next node features:
// it adds the cluster's partial sums for them through distributed shared
// memory in rank order (deterministic, no atomics), applies root, bias and
// ReLU, and writes them into every block's shared memory; the cluster
// syncs again. Rank 0 then runs the head and slides the window in place.
// The layers live in conv_stack.cuh, which fused_gkn.cu includes too.

#include "conv_stack.cuh"

namespace {

using conv_stack::kThreads;

template <typename CD>
__global__ void __launch_bounds__(kThreads) conv_head_kernel(
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
    int R, int W, int E, int T, int depth, int eb, int stage_k,
    int predict_delta, float head_scale, int extrapolate, float gamma,
    int has_clip, float clip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const float* xc = conv_stack::run<CD>(smem_raw, x0, K, edges, mask, inv_deg,
                                        root1, bias1, root2, bias2, R, W, E,
                                        depth, eb, stage_k);
  if (cooperative_groups::this_cluster().block_rank() != 0) return;
  const int s = blockIdx.x / conv_stack::NCL;
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

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the slice
// does not fit shared memory or the card cannot co-schedule the cluster.
template <typename CD>
int launch(const float* x0, const void* K, const int* edges, const float* mask,
           const float* inv_deg, const void* root1, const float* bias1,
           const void* root2, const float* bias2, const float* fc2_w,
           const float* fc2_b, float* window, float* coords, int S, int R,
           int W, int E, int T, int depth, int predict_delta, float head_scale,
           int extrapolate, float gamma, int has_clip, float clip,
           cudaStream_t st) {
  conv_stack::Plan p;
  const int rc = conv_stack::plan(R, W, E, sizeof(CD), &p);
  if (rc != 0) return rc;
  return conv_stack::launch_clusters(
      conv_head_kernel<CD>, S, p.smem, st, x0, static_cast<const CD*>(K), edges,
      mask, inv_deg, static_cast<const CD*>(root1), bias1,
      static_cast<const CD*>(root2), bias2, fc2_w, fc2_b, window, coords, R, W,
      E, T, depth, p.eb, p.stage_k, predict_delta, head_scale, extrapolate,
      gamma, has_clip, clip);
}

}  // namespace

extern "C" int mdno_conv_head(
    const float* x0, const void* K, const int* edges, const float* mask,
    const float* inv_deg, const void* root1, const float* bias1,
    const void* root2, const float* bias2, const float* fc2_w,
    const float* fc2_b, float* window, float* coords, int S, int R, int W,
    int E, int T, int depth, int predict_delta, float head_scale,
    int extrapolate, float gamma, int has_clip, float clip, int cd_bf16,
    void* stream) {
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
                                  clip, st)
          : launch<float>(x0, K, edges, mask, inv_deg, root1, bias1, root2,
                          bias2, fc2_w, fc2_b, window, coords, S, R, W, E, T,
                          depth, predict_delta, head_scale, extrapolate, gamma,
                          has_clip, clip, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
