// graph_encode: the per-step graph rebuild and node encoder of the rollout.
//
// Replaces, from the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py
// (persistent_rollout, body _kernel): the contact test on the window's last
// frame (:164-172), the row-major padded edge extraction with its overflow
// flag (:174-223), and the LSTM + embedding + fc1 node encoder (:225-262)
// with its electrostatics="dh" branch (:248-261, set-up :475-505): the
// Debye-Hueckel potential at each residue, fc1's eighth input.
// One block per stream.
//
// Bound: neither bytes nor operations. Per stream it reads the (T, R, 3)
// window and a few KB of weights and writes the E-slot edge list, edge
// features and the (R, w) node features: under 100 KB and ~0.3 MFLOP at the
// bench shapes, so the bound is well under a microsecond and the kernel's
// time is its latency (a serial LSTM over T frames, a prefix sum over R
// rows). The design keeps the window and the contact matrix in shared
// memory, ranks each row's contacts with warp ballots (integers only), runs
// the LSTM on four lanes per residue (one per gate) with its weights in
// registers, and computes the squared distances with round-to-nearest
// intrinsics in the order (dx*dx + dy*dy) + dz*dz so the contact bits equal
// those of the plain PyTorch version.
//
// The dh branch forms the same d2 again (same intrinsics, same order, so
// the same value the contact test saw) for a row per warp and sums
// l_B q_j exp(-kappa d) / d over the sources j != i with a warp reduction
// in a fixed order. expf, sqrtf and the division round in the last place
// unlike PyTorch's and the sum runs in another order, so phi, and with it
// x0, agrees with the plain version to about 1e-6 of its scale, not to the
// bit; the contact bits do not depend on it. No fast-math flags.

#include "common.cuh"

namespace {

constexpr int kMaxR = 128;
constexpr int kMaxWin = 4096;  // T * R * 3 floats of the staged window
constexpr int kMaxFeat = 16;   // embedding_dim + 3
constexpr int kThreads = 256;
constexpr int kHidden = 3;     // LSTM hidden width = x_position_dim
constexpr int kGates = 4 * kHidden;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <typename CD>
__global__ void __launch_bounds__(kThreads) graph_encode_kernel(
    const float* __restrict__ window,   // (S, T, R, 3)
    const float* __restrict__ emb_aa,   // (R, D)
    const float* __restrict__ w_ih,     // (3, 12)
    const float* __restrict__ w_hh,     // (3, 12)
    const float* __restrict__ b_ih,     // (12)
    const float* __restrict__ b_hh,     // (12)
    const float* __restrict__ lfc_w,    // (3, 3)
    const float* __restrict__ lfc_b,    // (3)
    const float* __restrict__ fc1_w,    // (D + 3 + dh, W)
    const float* __restrict__ fc1_b,    // (W)
    const float* __restrict__ charges,  // (R) or null without dh
    int T, int R, int D, int W, int E, float thr2,
    int dh, float dh_kappa, float dh_lb, float dh_min_dist,
    int* __restrict__ edges,            // (S, 2, E)
    float* __restrict__ mask,           // (S, E)
    int* __restrict__ count,            // (S)
    int* __restrict__ overflow,         // (1), OR-ed across steps
    float* __restrict__ inv_deg,        // (S, R)
    CD* __restrict__ ef,                // (S, E, 6)
    float* __restrict__ x0) {           // (S, R, W)
  __shared__ float win[kMaxWin];
  __shared__ unsigned char cmat[kMaxR * kMaxR];
  __shared__ int rowcnt[kMaxR];
  __shared__ int rowoff[kMaxR + 1];
  __shared__ int deg[kMaxR];
  __shared__ float feat[kMaxR * kMaxFeat];

  const int s = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = nt / 32;
  const float* gwin = window + (size_t)s * T * R * 3;
  for (int i = tid; i < T * R * 3; i += nt) win[i] = gwin[i];
  for (int i = tid; i < R; i += nt) deg[i] = 0;
  __syncthreads();
  const float* pos = win + (T - 1) * R * 3;

  // 1. contact test, bit-equal to geometry/contact.py::contact_map
  for (int p = tid; p < R * R; p += nt) {
    const int i = p / R, j = p % R;
    const float dx = __fsub_rn(pos[i * 3 + 0], pos[j * 3 + 0]);
    const float dy = __fsub_rn(pos[i * 3 + 1], pos[j * 3 + 1]);
    const float dz = __fsub_rn(pos[i * 3 + 2], pos[j * 3 + 2]);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    cmat[p] = d2 < thr2 ? 1 : 0;
  }
  __syncthreads();

  // 2. row counts (one warp per row, ballots), exclusive offsets, count
  for (int i = warp; i < R; i += nwarps) {
    int c = 0;
    for (int j0 = 0; j0 < R; j0 += 32) {
      const int j = j0 + lane;
      c += __popc(__ballot_sync(0xffffffffu, j < R && cmat[i * R + j]));
    }
    if (lane == 0) rowcnt[i] = c;
  }
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int i = 0; i < R; ++i) {
      rowoff[i] = acc;
      acc += rowcnt[i];
    }
    rowoff[R] = acc;
    count[s] = acc;
    if (acc > E) atomicOr(overflow, 1);
  }
  __syncthreads();

  // 3. row-major edge list: contact (i, j) takes slot rowoff[i] + (its rank
  // among row i's contacts); slots at or past E are dropped (the count
  // above still says so)
  int* src_out = edges + (size_t)s * 2 * E;
  int* dst_out = src_out + E;
  float* mask_out = mask + (size_t)s * E;
  CD* ef_out = ef + (size_t)s * E * 6;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = warp; i < R; i += nwarps) {
    int base = rowoff[i];
    for (int j0 = 0; j0 < R; j0 += 32) {
      const int j = j0 + lane;
      const bool hit = j < R && cmat[i * R + j];
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      const int slot = base + __popc(bits & lanes_below);
      if (hit && slot < E) {
        src_out[slot] = i;
        dst_out[slot] = j;
        mask_out[slot] = 1.f;
        for (int k = 0; k < 3; ++k) {
          ef_out[slot * 6 + k] = from_f32<CD>(pos[i * 3 + k]);
          ef_out[slot * 6 + 3 + k] = from_f32<CD>(pos[j * 3 + k]);
        }
        atomicAdd(&deg[j], 1);
      }
      base += __popc(bits);
    }
  }
  // padded slots: src = dst = 0, mask 0, features of node 0
  for (int slot = min(rowoff[R], E) + tid; slot < E; slot += nt) {
    src_out[slot] = 0;
    dst_out[slot] = 0;
    mask_out[slot] = 0.f;
    for (int k = 0; k < 3; ++k) {
      ef_out[slot * 6 + k] = from_f32<CD>(pos[k]);
      ef_out[slot * 6 + 3 + k] = from_f32<CD>(pos[k]);
    }
  }

  // 3b. Debye-Hueckel potential at residue i from the sources j != i:
  // phi_i = l_B sum_j q_j exp(-kappa d_ij) / d_ij, d = sqrt(max(d2, min^2))
  if (dh) {
    const float min2 = dh_min_dist * dh_min_dist;
    for (int i = warp; i < R; i += nwarps) {
      float acc = 0.f;
      for (int j = lane; j < R; j += 32) {
        if (j == i) continue;
        const float dx = __fsub_rn(pos[i * 3 + 0], pos[j * 3 + 0]);
        const float dy = __fsub_rn(pos[i * 3 + 1], pos[j * 3 + 1]);
        const float dz = __fsub_rn(pos[i * 3 + 2], pos[j * 3 + 2]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        const float d = sqrtf(fmaxf(d2, min2));
        acc += dh_lb * charges[j] * expf(-dh_kappa * d) / d;
      }
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) feat[i * kMaxFeat + D + 3] = acc;
    }
  }

  // 4. LSTM over the T frames: four lanes per residue, lane g computes the
  // gates g*3 .. g*3+2 (i, f, g, o blocks) and the four exchange them
  float wi[3][kHidden], wh[kHidden][kHidden], bi[kHidden], bh[kHidden];
  const int gtype = tid % 4;
  for (int q = 0; q < kHidden; ++q) {
    const int k = gtype * kHidden + q;
    for (int a = 0; a < 3; ++a) wi[a][q] = w_ih[a * kGates + k];
    for (int a = 0; a < kHidden; ++a) wh[a][q] = w_hh[a * kGates + k];
    bi[q] = b_ih[k];
    bh[q] = b_hh[k];
  }
  const int lead = lane & ~3;
  for (int r0 = 0; r0 < R; r0 += nt / 4) {
    const int r = r0 + tid / 4;
    const int rr = min(r, R - 1);  // every lane takes part in the shuffles
    float h[kHidden] = {0.f, 0.f, 0.f};
    float c[kHidden] = {0.f, 0.f, 0.f};
    for (int t = 0; t < T; ++t) {
      const float* x = win + (t * R + rr) * 3;
      float act[kHidden];
      for (int q = 0; q < kHidden; ++q) {
        float a = 0.f, b = 0.f;
        for (int p = 0; p < 3; ++p) a = fmaf(x[p], wi[p][q], a);
        for (int p = 0; p < kHidden; ++p) b = fmaf(h[p], wh[p][q], b);
        const float g = ((a + b) + bi[q]) + bh[q];
        act[q] = gtype == 2 ? tanhf(g) : sigmoidf(g);
      }
      for (int q = 0; q < kHidden; ++q) {
        const float ig = __shfl_sync(0xffffffffu, act[q], lead + 0);
        const float fg = __shfl_sync(0xffffffffu, act[q], lead + 1);
        const float gg = __shfl_sync(0xffffffffu, act[q], lead + 2);
        const float og = __shfl_sync(0xffffffffu, act[q], lead + 3);
        c[q] = fg * c[q] + ig * gg;
        h[q] = og * tanhf(c[q]);
      }
    }
    if (r < R && gtype == 0) {
      float* f = feat + r * kMaxFeat;
      for (int d = 0; d < D; ++d) f[d] = emb_aa[r * D + d];
      for (int q = 0; q < 3; ++q) {
        float a = 0.f;
        for (int k = 0; k < kHidden; ++k) a = fmaf(h[k], lfc_w[k * 3 + q], a);
        f[D + q] = a + lfc_b[q];
      }
    }
  }
  __syncthreads();

  for (int j = tid; j < R; j += nt)
    inv_deg[(size_t)s * R + j] = 1.f / (float)max(deg[j], 1);

  // 5. fc1 + ReLU -> x0
  const int nf = D + 3 + (dh ? 1 : 0);  // [emb ; lstm ; phi]
  for (int idx = tid; idx < R * W; idx += nt) {
    const int r = idx / W, o = idx % W;
    float a = 0.f;
    for (int k = 0; k < nf; ++k) a = fmaf(feat[r * kMaxFeat + k], fc1_w[k * W + o], a);
    x0[(size_t)s * R * W + idx] = relu_nan(a + fc1_b[o]);
  }
}

}  // namespace

extern "C" int mdno_graph_encode(
    const float* window, const float* emb_aa, const float* w_ih,
    const float* w_hh, const float* b_ih, const float* b_hh,
    const float* lfc_w, const float* lfc_b, const float* fc1_w,
    const float* fc1_b, const float* charges, int S, int T, int R, int D,
    int W, int E, float thr2, int cd_bf16, int dh, float dh_kappa,
    float dh_lb, float dh_min_dist, int* edges, float* mask, int* count,
    int* overflow, float* inv_deg, void* ef, float* x0, void* stream) {
  if (R > kMaxR || T * R * 3 > kMaxWin || D + 3 + (dh ? 1 : 0) > kMaxFeat ||
      S < 1 || T < 1 || (dh && charges == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cd_bf16) {
    graph_encode_kernel<__nv_bfloat16><<<S, kThreads, 0, st>>>(
        window, emb_aa, w_ih, w_hh, b_ih, b_hh, lfc_w, lfc_b, fc1_w, fc1_b,
        charges, T, R, D, W, E, thr2, dh, dh_kappa, dh_lb, dh_min_dist, edges, mask, count, overflow, inv_deg,
        static_cast<__nv_bfloat16*>(ef), x0);
  } else {
    graph_encode_kernel<float><<<S, kThreads, 0, st>>>(
        window, emb_aa, w_ih, w_hh, b_ih, b_hh, lfc_w, lfc_b, fc1_w, fc1_b,
        charges, T, R, D, W, E, thr2, dh, dh_kappa, dh_lb, dh_min_dist, edges, mask, count, overflow, inv_deg,
        static_cast<float*>(ef), x0);
  }
  return (int)cudaGetLastError();
}
