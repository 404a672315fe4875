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
// activations (x_out > 0), and dK is summed in f32 over the layers and
// rounded once to K's type. dK of a padded slot (mask 0, src = dst = 0) is
// xs (x) dm of node 0, as in the plain version and the TPU kernel; the
// caller's mask zeroes it one step later. droot and dbias come out per
// example and are summed over the batch outside, as the TPU wrapper does.
// No atomics anywhere.
//
// Bound: bytes. At B=128, E=256 (about 202 real edges an example), w=64,
// bf16 the kernel must read the real rows of K (212 MB) and the stack
// (12 MB) and write dK (268 MB): 149 us at 3.35 TB/s, against ~6.4 GFLOP.
//
// Each example is one cluster of the rollout conv stack's frame
// (conv_stack.cuh): 8 blocks, edges dealt to blocks by SOURCE node so that
// the owner of a node holds the whole sum of its dx, K rows staged once,
// the layers swept in reverse, then droot, dbias and dK in the same launch.
// The body is chosen by dtype and width alone (Plan::mma), never on a
// failure: bf16 at width 64, the training main path, runs on the tensor
// cores with counted stores between the layers (conv_stack_bwd.cuh,
// run_mma); f32 and other widths on CUDA cores with one split cluster
// barrier a layer (run_fma), which keeps every layer's dagg and dz in a
// history in device memory (``hist``, the caller's) and so takes any width
// that is a multiple of 8 up to 128 in f32 and 256 in bf16, shared memory
// permitting. The card holds a fixed number of these
// clusters at once (mdno_train_conv_bwd_clusters), and B examples run in
// waves of that many.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, B = 128,
// bf16): 602 us, 15 clusters resident, 9 waves of about 67 us; the
// 16-block design before it took 2,682 us in the same call.

#include "conv_stack_bwd.cuh"

namespace {

template <typename CD, bool MMA>
__global__ void __launch_bounds__(
    MMA ? conv_stack::kMmaThreads : conv_stack::kThreads, 1)
    train_conv_bwd_kernel(
        const float* __restrict__ g_out,    // (B, R, W)
        const float* __restrict__ stack,    // (B, 2*depth+1, R, W)
        const CD* __restrict__ K,           // (B, E, W*W), padded rows zero
        const int* __restrict__ edges,      // (B, 2, E)
        const float* __restrict__ mask,     // (B, E)
        const float* __restrict__ inv_deg,  // (B, R)
        const CD* __restrict__ root1, const CD* __restrict__ root2,
        float* __restrict__ dx0,            // (B, R, W)
        CD* __restrict__ dK,                // (B, E, W*W)
        float* __restrict__ droot1,         // (B, W, W)
        float* __restrict__ dbias1,         // (B, W)
        float* __restrict__ droot2, float* __restrict__ dbias2,
        float* hist,                        // (B, 2, 2*depth, R, W), run_fma's
        int R, int W, int E, int depth, int cap) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if constexpr (MMA)
    conv_stack_bwd::run_mma(smem_raw, g_out, stack, K, edges, mask, inv_deg,
                            root1, root2, dx0, dK, droot1, dbias1, droot2,
                            dbias2, R, E, depth, cap);
  else
    conv_stack_bwd::run_fma<CD>(smem_raw, g_out, stack, K, edges, mask,
                                inv_deg, root1, root2, dx0, dK, droot1, dbias1,
                                droot2, dbias2, hist, R, W, E, depth, cap);
}

// fn(the kernel of the body conv_stack_bwd::plan chooses), with *p that plan
template <typename CD, typename Fn>
int with_kernel(int R, int W, int E, int depth, conv_stack::Plan* p, Fn&& fn) {
  const int rc = conv_stack_bwd::plan(R, W, E, depth, sizeof(CD), p);
  if (rc != 0) return rc;
  if constexpr (sizeof(CD) == 2) {
    if (p->mma) return fn(train_conv_bwd_kernel<CD, true>);
  }
  return fn(train_conv_bwd_kernel<CD, false>);
}

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the buffers
// do not fit shared memory or the card cannot co-schedule the cluster.
template <typename CD>
int launch(const float* g_out, const float* stack, const void* K,
           const int* edges, const float* mask, const float* inv_deg,
           const void* root1, const void* root2, float* dx0, void* dK,
           float* droot1, float* dbias1, float* droot2, float* dbias2,
           float* hist, int B, int R, int W, int E, int depth,
           cudaStream_t st) {
  conv_stack::Plan p;
  return with_kernel<CD>(R, W, E, depth, &p, [&](auto kernel) {
    if (!p.mma && hist == nullptr) return (int)cudaErrorInvalidValue;
    return conv_stack::launch_clusters(
        kernel, B, p, st, g_out, stack, static_cast<const CD*>(K), edges, mask,
        inv_deg, static_cast<const CD*>(root1), static_cast<const CD*>(root2),
        dx0, static_cast<CD*>(dK), droot1, dbias1, droot2, dbias2, hist, R, W,
        E, depth, p.cap);
  });
}

}  // namespace

// How many of this kernel's clusters (one an example) the card holds at
// once at these shapes: cudaOccupancyMaxActiveClusters of its launch; and
// the floats of device memory an example's history takes (``hist`` of
// mdno_train_conv_bwd; 0 for the tensor-core body, which keeps none).
// Returns plan()'s refusal of a shape.
extern "C" int mdno_train_conv_bwd_clusters(int R, int W, int E, int depth,
                                            int cd_bf16, int* out,
                                            long long* hist) {
  conv_stack::Plan p;
  auto count = [&](auto kernel) {
    return conv_stack::max_active_clusters(kernel, p, out);
  };
  const int rc = cd_bf16 ? with_kernel<__nv_bfloat16>(R, W, E, depth, &p, count)
                         : with_kernel<float>(R, W, E, depth, &p, count);
  *hist = rc == 0 && !p.mma
              ? (long long)conv_stack_bwd::hist_floats(R, W, depth) : 0;
  return rc;
}

extern "C" int mdno_train_conv_bwd(
    const float* g_out, const float* stack, const void* K, const int* edges,
    const float* mask, const float* inv_deg, const void* root1,
    const void* root2, float* dx0, void* dK, float* droot1, float* dbias1,
    float* droot2, float* dbias2, float* hist, int B, int R, int W, int E,
    int depth, int cd_bf16, void* stream) {
  if (B < 1 || R < 1 || E < 1 || depth < 1 || W % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      cd_bf16 ? launch<__nv_bfloat16>(g_out, stack, K, edges, mask, inv_deg,
                                      root1, root2, dx0, dK, droot1, dbias1,
                                      droot2, dbias2, hist, B, R, W, E, depth,
                                      st)
              : launch<float>(g_out, stack, K, edges, mask, inv_deg, root1,
                              root2, dx0, dK, droot1, dbias1, droot2, dbias2,
                              hist, B, R, W, E, depth, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
