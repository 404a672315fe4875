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
// compute type CD, every sum is f32.
//
// Bound: bytes. At B=128, E=256 (about 202 real edges an example), w=64,
// bf16 the kernel must read the real rows of K once (212 MB) and write the
// activation stack (12 MB): 67 us at 3.35 TB/s, against 3.2 GFLOP.
//
// An example is one stream of the rollout's conv stack (conv_stack.cuh,
// conv_stack::run, the frame conv_head.cu uses): one cluster of 8 blocks,
// edges dealt to blocks by target node so that no partial sum crosses
// blocks, a block's K rows staged once in shared memory and registers, and
// in bf16 at width 64 the tensor-core body (run_mma) with x' exchanged by
// counted stores; f32 and other widths take the CUDA-core body (run_fma).
// The item that forms x' also writes it, unrounded, into the stack; this
// file adds row 0 (x0) and the output. The mask tells a padded slot (mask 0,
// skipped) from node 0's real self-loop; K arrives pre-masked, so a padded
// slot would add zero anyway. The card holds a fixed number of these
// clusters at once (mdno_train_conv_fwd_clusters), and B examples run in
// waves of that many.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, B = 128,
// bf16): 384 us, 15 clusters resident, 9 waves of about 43 us (one stream
// of conv_head's stack is 39 us); the 16-block design before it took
// 1,345 us in the same call.

#include "conv_stack.cuh"

namespace {

template <typename CD, bool MMA>
__global__ void __launch_bounds__(
    MMA ? conv_stack::kMmaThreads : conv_stack::kThreads, 1)
    train_conv_fwd_kernel(
        const float* __restrict__ x0,       // (B, R, W)
        const CD* __restrict__ K,           // (B, E, W*W), padded rows zero
        const int* __restrict__ edges,      // (B, 2, E)
        const float* __restrict__ mask,     // (B, E)
        const float* __restrict__ inv_deg,  // (B, R)
        const CD* __restrict__ root1, const float* __restrict__ bias1,
        const CD* __restrict__ root2, const float* __restrict__ bias2,
        float* __restrict__ out,            // (B, R, W)
        float* __restrict__ stack,          // (B, 2*depth+1, R, W)
        int R, int W, int E, int depth, int cap) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const auto cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank(), ncl = (int)cluster.num_blocks();
  const int s = blockIdx.x / ncl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int RW = R * W;
  // row 0 of the stack is x0: each block copies its share
  float* stack_s = stack + (size_t)s * (2 * depth + 1) * RW;
  for (int i = rank * nt + tid; i < RW; i += ncl * nt)
    stack_s[i] = x0[(size_t)s * RW + i];
  const float* xc = conv_stack::run<CD, MMA>(smem_raw, x0, K, edges, mask,
                                             inv_deg, root1, bias1, root2,
                                             bias2, R, W, E, depth, cap, stack);
  // the last layer, complete in every block: each writes its share
  for (int i = rank * nt + tid; i < RW; i += ncl * nt)
    out[(size_t)s * RW + i] = xc[i];
}

// fn(the kernel of the body conv_stack::plan chooses), with *p that plan
template <typename CD, typename Fn>
int with_kernel(int R, int W, int E, conv_stack::Plan* p, Fn&& fn) {
  const int rc = conv_stack::plan(R, W, E, sizeof(CD), p);
  if (rc != 0) return rc;
  if constexpr (sizeof(CD) == 2) {
    if (p->mma) return fn(train_conv_fwd_kernel<CD, true>);
  }
  return fn(train_conv_fwd_kernel<CD, false>);
}

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the buffers
// do not fit shared memory or the card cannot co-schedule the cluster.
template <typename CD>
int launch(const float* x0, const void* K, const int* edges, const float* mask,
           const float* inv_deg, const void* root1, const float* bias1,
           const void* root2, const float* bias2, float* out, float* stack,
           int B, int R, int W, int E, int depth, cudaStream_t st) {
  conv_stack::Plan p;
  return with_kernel<CD>(R, W, E, &p, [&](auto kernel) {
    return conv_stack::launch_clusters(
        kernel, B, p, st, x0, static_cast<const CD*>(K), edges, mask, inv_deg,
        static_cast<const CD*>(root1), bias1, static_cast<const CD*>(root2),
        bias2, out, stack, R, W, E, depth, p.cap);
  });
}

}  // namespace

// How many of this kernel's clusters (one an example) the card holds at
// once at these shapes: cudaOccupancyMaxActiveClusters of its launch.
extern "C" int mdno_train_conv_fwd_clusters(int R, int W, int E, int cd_bf16,
                                            int* out) {
  conv_stack::Plan p;
  auto count = [&](auto kernel) {
    return conv_stack::max_active_clusters(kernel, p, out);
  };
  return cd_bf16 ? with_kernel<__nv_bfloat16>(R, W, E, &p, count)
                 : with_kernel<float>(R, W, E, &p, count);
}

extern "C" int mdno_train_conv_fwd(
    const float* x0, const void* K, const int* edges, const float* mask,
    const float* inv_deg, const void* root1, const float* bias1,
    const void* root2, const float* bias2, float* out, float* stack, int B,
    int R, int W, int E, int depth, int cd_bf16, void* stream) {
  if (B < 1 || R < 1 || E < 1 || depth < 1 || W % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc =
      cd_bf16 ? launch<__nv_bfloat16>(x0, K, edges, mask, inv_deg, root1,
                                      bias1, root2, bias2, out, stack, B, R, W,
                                      E, depth, st)
              : launch<float>(x0, K, edges, mask, inv_deg, root1, bias1,
                              root2, bias2, out, stack, B, R, W, E, depth, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
