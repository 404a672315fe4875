// fused_edge_conv_stack: the edge-kernel MLP and both tied conv stacks of
// the GKN forward, one call.
//
// Replaces the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/fused_gkn.py
// (fused_edge_conv_stack, body _kernel :76, adapter
// fused_conv_stack_from_graph :141), reached through conv_impl="pallas":
//   ef (E, 6) -> relu(ef w1 + b1) -> relu(. w2 + b2) -> (. w3 + b3) * mask = K
//   2*depth times: x <- relu(mean-aggregate(x_src @ K_e) + x @ root + bias)
// forward only, no head. On the TPU it is one pallas_call with the weights
// and K in VMEM, gather and scatter as one-hot matrix products and R padded
// to 8. Here the edges are int32 indices, R is taken as it is, and a leading
// stream axis S batches independent examples (the JAX package vmaps).
//
// Bound: at S = 1 in bf16 the function must read 10.5 MB of MLP weights and
// do 2 * 224 * (6*1024 + 1024^2 + 1024*4096) = 2.35 GFLOP: 3.1 us at
// 3.35 TB/s against 2.4 us at 989 TFLOP/s, so the weights' bytes bound it;
// at S streams the weights are read once and the operations grow S-fold.
// One SM can hold neither the weights nor K (1.84 MB in bf16), and the three
// products want the whole card while the 12 dependent layers want K close
// to one small group of SMs. So the host entry enqueues, on one stream and
// with no host sync, the three MLP layers over all S*E rows (edge_mlp.cuh,
// shared with the rollout step: TMA-fed wgmma kernels for the two wide
// layers, a small FMA kernel for the 6-wide first; the last one writes K
// with padded rows zeroed) and then one cluster kernel per call that runs
// the 2*depth layers with edges dealt to the cluster's 8 blocks by target
// node, their K rows in registers and shared memory, in bf16 on the tensor
// cores (conv_stack.cuh, shared with conv_head.cu), and writes x. h1, h2 and K
// pass through device memory (L2-resident at these sizes) between the four
// launches; the wrapper owns that scratch. What bounds the two halves on
// this card, and what was tried, is in edge_mlp.cu and conv_head.cu.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 53.3 us at
// S = 1 and 95.5 at S = 8 (the first port: 117.9 and 314.2).
//
// Cast points follow the XLA path (gkn_apply_single with conv_impl="xla"),
// not the Pallas body, which rounds every product xs * K to the compute
// dtype before the f32 sum: messages are f32 sums of exact products, rounded
// once. In f32 all three agree; in bf16 the port's two conv_impl values
// agree with each other and differ from the Pallas body by a few roundings.

#include "conv_stack.cuh"
#include "edge_mlp.cuh"

namespace {

template <typename CD, bool MMA>
__global__ void __launch_bounds__(
    MMA ? conv_stack::kMmaThreads : conv_stack::kThreads, 1)
    fused_conv_stack_kernel(
    const float* __restrict__ x0,       // (S, R, W)
    const CD* __restrict__ K,           // (S, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (S, 2, E)
    const float* __restrict__ mask,     // (S, E)
    const float* __restrict__ inv_deg,  // (S, R)
    const CD* __restrict__ root1, const float* __restrict__ bias1,
    const CD* __restrict__ root2, const float* __restrict__ bias2,
    float* __restrict__ out,            // (S, R, W)
    int R, int W, int E, int depth, int cap) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const float* x = conv_stack::run<CD, MMA>(smem_raw, x0, K, edges, mask,
                                            inv_deg, root1, bias1, root2,
                                            bias2, R, W, E, depth, cap);
  // every block holds all of x: each writes its share
  const auto cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int s = blockIdx.x / ncl;
  const int RW = R * W;
  const int nb_out = (RW + ncl - 1) / ncl;
  for (int idx = rank * nb_out + threadIdx.x;
       idx < min(RW, (rank + 1) * nb_out); idx += blockDim.x)
    out[(size_t)s * RW + idx] = x[idx];
}

template <typename CD>
int launch_stack(const float* x0, const void* K, const int* edges,
                 const float* mask, const float* inv_deg, const void* root1,
                 const float* bias1, const void* root2, const float* bias2,
                 float* out, int S, int R, int W, int E, int depth,
                 cudaStream_t st) {
  conv_stack::Plan p;
  const int rc = conv_stack::plan(R, W, E, sizeof(CD), &p);
  if (rc != 0) return rc;
  auto go = [&](auto kernel) {
    return conv_stack::launch_clusters(
        kernel, S, p, st, x0, static_cast<const CD*>(K), edges, mask, inv_deg,
        static_cast<const CD*>(root1), bias1, static_cast<const CD*>(root2),
        bias2, out, R, W, E, depth, p.cap);
  };
  if constexpr (sizeof(CD) == 2) {
    if (p.mma) return go(fused_conv_stack_kernel<CD, true>);
  }
  return go(fused_conv_stack_kernel<CD, false>);
}

}  // namespace

// ef (S, E, F), w1 (F, KW), w2 (KW, KW), w3 (KW, W*W), root1/root2 (W, W)
// and the scratch h1, h2 (S*E, KW), kmat (S*E, W*W) in the compute dtype;
// everything else f32; edges int32. Writes out (S, R, W).
extern "C" int mdno_fused_edge_conv_stack(
    const void* ef, const float* mask, const int* edges, const float* inv_deg,
    const float* x0, const void* w1, const float* b1, const void* w2,
    const float* b2, const void* w3, const float* b3, const void* root1,
    const float* bias1, const void* root2, const float* bias2, void* h1,
    void* h2, void* kmat, float* out, int S, int R, int W, int E, int KW, int F,
    int depth, int cd_bf16, void* stream) {
  if (S < 1 || R < 1 || E < 1 || F < 1 || depth < 0 || W % 8 != 0 ||
      KW % edge_mlp::FBN != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = S * E;
  int rc = edge_mlp::launch_stack(
      ef, w1, b1, w2, b2, w3, b3, mask, h1, h2, kmat, M, KW, W * W, F, cd_bf16,
      st);
  if (rc != 0) return rc;
  rc = cd_bf16 ? launch_stack<__nv_bfloat16>(x0, kmat, edges, mask, inv_deg,
                                             root1, bias1, root2, bias2, out,
                                             S, R, W, E, depth, st)
               : launch_stack<float>(x0, kmat, edges, mask, inv_deg, root1,
                                     bias1, root2, bias2, out, S, R, W, E,
                                     depth, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
