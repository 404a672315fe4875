// graph_encode: the per-step graph rebuild and node encoder of the rollout.
//
// Replaces, from the TPU kernel
// molecular_dynamics_neural_operator_tpu/ops/pallas/persistent_rollout.py
// (persistent_rollout, body _kernel): the contact test on the window's last
// frame (:164-172), the row-major padded edge extraction with its overflow
// flag (:174-223), and the LSTM + embedding + fc1 node encoder (:225-262)
// with its electrostatics="dh" branch (:248-261, set-up :475-505): the
// Debye-Hueckel potential at each residue, fc1's eighth input.
//
// Bound: neither bytes nor operations. Per stream it reads the (T, R, 3)
// window and a few KB of weights and writes the E-slot edge list, edge
// features and the (R, w) node features: under 100 KB and ~0.3 MFLOP at the
// bench shapes, well under a microsecond on either count. Its time is a
// chain of latencies: the first global round trip, then the LSTM's T serial
// steps, then fc1. The design shortens that chain:
//
// - One block a stream. At entry every thread issues cp.async copies of its
//   share of the window and of every weight the kernel reads, and the block
//   waits once: a single global round trip on the critical path.
// - Warp specialisation. The first NE warps ("edge warps") build the graph
//   from the last frame; the next NN warps ("encoder warps") run the LSTM
//   over the window. Neither half reads the other's results, so they run
//   concurrently; the edge warps synchronise among themselves with named
//   barriers (bar.sync 1, 32 * NE) and the block joins once, before fc1,
//   which all warps share.
// - The contact test writes a bit-packed contact matrix: the ballot of a
//   warp over 32 columns of row i is the matrix's 32-bit word, and its
//   popcount the row count. A warp tests four rows at once against each
//   column it loads (four independent chains); with dh the same pass sums
//   the potential of each row from the same d2. The exclusive row offsets
//   are one warp scan (__shfl_up_sync) over the row counts, each lane
//   summing ceil(R / 32) consecutive rows first. A row's edges are written
//   by one warp: lane k holds word k, a scan over the words gives each
//   word's first slot, and only the non-empty words are visited.
// - The LSTM runs on three lanes a residue, lane q computing the four gates
//   of hidden unit q with their weights in registers, so every lane runs
//   the same code, and the input projection of step t + 1 is formed while
//   step t's chain runs. A step's chain is three FMAs, a sigmoid or tanhf,
//   the cell update, tanhf(c) and the shuffles that hand h to the next
//   step. expf, tanhf and the divisions are the precise ones (no fast-math
//   flags). (Twelve lanes a residue, one gate each, shortened a lane's
//   chain but cost more issue slots than they saved; see PERF.md.)
// - fc1: lane o holds column o of fc1 in registers, a warp takes one
//   residue's row of inputs at a time with 16-byte loads. The inputs are
//   padded with zeros to a compile-time count (8 or 16), so the loop has
//   no runtime bound: on this card a short loop's branches cost more than
//   its arithmetic.
//
// Shared memory grows as 12 T R + R^2 / 8 bytes (the window and the bit
// matrix) and is requested dynamically, above 48 KB with the opt-in: the
// limit on R and T. Besides: at most 16 fc1 inputs (they sit in
// registers) and at most 1,024 residues (32 contact words a row, one a
// lane). mdno_graph_encode_plan gives the bytes and the card's opt-in
// maximum, and the wrapper refuses a shape past any limit before a launch.
//
// Bits that match the plain PyTorch version: d2 by __fmul_rn / __fadd_rn in
// the order (dx*dx + dy*dy) + dz*dz, so the contact bits are equal; slots in
// row-major order; padded slots src = dst = 0, mask 0, node 0's features;
// slots at or past E dropped while the count still counts them. x0 agrees
// to f32 tolerance: the transcendentals and the sums' order differ from
// PyTorch's, and with dh phi's sum over j runs in another order (about 1e-6
// of its scale).

#include "common.cuh"

namespace {

constexpr int kHidden = 3;      // LSTM hidden width = x_position_dim
constexpr int kGates = 4 * kHidden;
constexpr int kLstmFloats = 3 * kGates + kHidden * kGates + 2 * kGates +
                            kHidden * 3 + 3;  // w_ih, w_hh, b_ih, b_hh, lfc
constexpr int kResPerWarp = 10;  // three LSTM lanes a residue
constexpr int kRowsAtOnce = 4;   // contact rows a warp tests together
constexpr int kMaxFeat = 16;     // fc1 inputs, held in registers
constexpr int kMaxWords = 32;    // contact words a row: R <= 1024
constexpr int kMaxWarps = 32;
constexpr int kEdgeBarrier = 1;
constexpr unsigned kFull = 0xffffffffu;

// fc1's inputs padded to a compile-time count: 8 or 16.
__host__ __device__ constexpr int padded_features(int nf) {
  return nf <= 8 ? 8 : 16;
}

// Offsets, in 4-byte words, of the block's shared buffers. feat holds a
// row of fc1's inputs per residue, [emb ; lstm_fc(h) ; phi] and zeros up
// to padded_features(nf) (16-byte aligned rows, first in the block's
// memory); fc1w holds fc1's weights with zero rows up to the same count.
struct Layout {
  int feat, fc1w, fc1b, win, lstm, charges, bits, rowcnt, rowoff, deg, total;
};

__host__ __device__ inline Layout layout(int T, int R, int D, int W, int dh) {
  const int nfp = padded_features(D + 3 + (dh ? 1 : 0));
  const int nw = (R + 31) / 32;
  Layout l;
  l.feat = 0;
  l.fc1w = l.feat + R * nfp;
  l.fc1b = l.fc1w + nfp * W;
  l.win = l.fc1b + W;
  l.lstm = l.win + T * R * 3;
  l.charges = l.lstm + kLstmFloats;
  l.bits = l.charges + (dh ? R : 0);
  l.rowcnt = l.bits + R * nw;
  l.rowoff = l.rowcnt + R;
  l.deg = l.rowoff + R + 1;
  l.total = l.deg + R;
  return l;
}

// Edge warps: one per 4 rows, 4 to 16; encoder warps: one per 10
// residues, at most 16 (more residues take more passes).
__host__ inline void warps(int R, int* ne, int* nn) {
  *ne = (R + 3) / 4;
  *ne = *ne < 4 ? 4 : (*ne > 16 ? 16 : *ne);
  *nn = (R + kResPerWarp - 1) / kResPerWarp;
  *nn = *nn < 1 ? 1 : (*nn > 16 ? 16 : *nn);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// n floats from global to shared, dealt over the block's threads; element
// i lands at dst[(i / cols) * stride + i % cols].
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      int cols = 1, int stride = 1) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + (cols == stride ? i : (i / cols) * stride + i % cols),
              src + i);
}

__device__ __forceinline__ void edge_barrier(int ne) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kEdgeBarrier), "r"(ne * 32)
               : "memory");
}

// d2 of positions a and b, rounded as the plain version rounds it.
__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The edge half, on warps 0 .. ne-1: contact bits (and phi with dh), row
// offsets, the edge list, its features, the count, the overflow flag and
// the inverse in-degrees.
template <typename CD, int NFP>
__device__ __forceinline__ void build_graph(
    const Layout& l, float* sm, int T, int R, int nf, int E, float thr2,
    int dh, float dh_kappa, float dh_lb, float dh_min_dist, int ne, int s,
    int* __restrict__ edges, float* __restrict__ mask, int* __restrict__ count,
    int* __restrict__ overflow, float* __restrict__ inv_deg,
    CD* __restrict__ ef) {
  const int lane = threadIdx.x % 32, ew = threadIdx.x / 32;
  const int nw = (R + 31) / 32;
  const float* pos = sm + l.win + (T - 1) * R * 3;
  unsigned* bits = reinterpret_cast<unsigned*>(sm + l.bits);
  int* rowcnt = reinterpret_cast<int*>(sm + l.rowcnt);
  int* rowoff = reinterpret_cast<int*>(sm + l.rowoff);
  int* deg = reinterpret_cast<int*>(sm + l.deg);
  const float min2 = dh_min_dist * dh_min_dist;

  // 1. contact words and row counts, kRowsAtOnce rows a warp at a time,
  // lane j of word k testing column 32 k + j; with dh the potential
  // phi_i = l_B sum_{j != i} q_j exp(-kappa d) / d, d = sqrt(max(d2, min^2))
  for (int i0 = ew; i0 < R; i0 += kRowsAtOnce * ne) {
    int row[kRowsAtOnce], cnt[kRowsAtOnce];
    float px[kRowsAtOnce], py[kRowsAtOnce], pz[kRowsAtOnce], acc[kRowsAtOnce];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      row[u] = i0 + u * ne;
      const int ri = row[u] < R ? row[u] : i0;
      px[u] = pos[ri * 3];
      py[u] = pos[ri * 3 + 1];
      pz[u] = pos[ri * 3 + 2];
      cnt[u] = 0;
      acc[u] = 0.f;
    }
    for (int k = 0; k < nw; ++k) {
      const int j = k * 32 + lane;
      const bool jin = j < R;
      const int jj = jin ? j : 0;
      const float xj = pos[jj * 3], yj = pos[jj * 3 + 1], zj = pos[jj * 3 + 2];
      const float qj = dh ? sm[l.charges + jj] : 0.f;
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        const float d2 = sq_dist(px[u], py[u], pz[u], xj, yj, zj);
        if (dh && jin && j != row[u]) {
          const float d = sqrtf(fmaxf(d2, min2));
          acc[u] += dh_lb * qj * expf(-dh_kappa * d) / d;
        }
        const unsigned b = __ballot_sync(kFull, jin && d2 < thr2);
        if (lane == 0 && row[u] < R) bits[row[u] * nw + k] = b;
        cnt[u] += __popc(b);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsAtOnce; ++u) {
      if (dh)
        for (int off = 16; off > 0; off >>= 1)
          acc[u] += __shfl_xor_sync(kFull, acc[u], off);
      if (lane == 0 && row[u] < R) {
        rowcnt[row[u]] = cnt[u];
        if (dh) sm[l.feat + row[u] * NFP + nf - 1] = acc[u];
      }
    }
  }
  edge_barrier(ne);

  // 2. exclusive row offsets: each lane sums its run of rows, one warp scan
  if (ew == 0) {
    const int per = (R + 31) / 32;
    const int r0 = min(lane * per, R), r1 = min(r0 + per, R);
    int local = 0;
    for (int i = r0; i < r1; ++i) local += rowcnt[i];
    int incl = local;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    int acc = incl - local;
    for (int i = r0; i < r1; ++i) {
      rowoff[i] = acc;
      acc += rowcnt[i];
    }
    if (lane == 31) {
      rowoff[R] = incl;
      count[s] = incl;
      if (incl > E) atomicOr(overflow, 1);
    }
  }
  edge_barrier(ne);

  // 3. row-major edge list, a warp a row: lane k holds word k, a scan over
  // the words gives each word's first slot, and the non-empty words are
  // written one after the other; contact (i, j) takes slot rowoff[i] + (its
  // rank among row i's contacts). Slots at or past E are dropped (the count
  // above still says so).
  int* src_out = edges + (size_t)s * 2 * E;
  int* dst_out = src_out + E;
  float* mask_out = mask + (size_t)s * E;
  CD* ef_out = ef + (size_t)s * E * 6;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int i = ew; i < R; i += ne) {
    const unsigned word = lane < nw ? bits[i * nw + lane] : 0u;
    const int c = __popc(word);
    int incl = c;
    for (int off = 1; off < nw; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += v;
    }
    const int first = rowoff[i] + incl - c;
    const float xi = pos[i * 3], yi = pos[i * 3 + 1], zi = pos[i * 3 + 2];
    for (unsigned left = __ballot_sync(kFull, word != 0u); left;
         left &= left - 1u) {
      const int k = __ffs(left) - 1;
      const unsigned b = __shfl_sync(kFull, word, k);
      const int slot = __shfl_sync(kFull, first, k) + __popc(b & lanes_below);
      const int j = k * 32 + lane;
      if (((b >> lane) & 1u) && slot < E) {
        src_out[slot] = i;
        dst_out[slot] = j;
        mask_out[slot] = 1.f;
        CD* f = ef_out + slot * 6;
        f[0] = from_f32<CD>(xi);
        f[1] = from_f32<CD>(yi);
        f[2] = from_f32<CD>(zi);
        f[3] = from_f32<CD>(pos[j * 3]);
        f[4] = from_f32<CD>(pos[j * 3 + 1]);
        f[5] = from_f32<CD>(pos[j * 3 + 2]);
        atomicAdd(&deg[j], 1);
      }
    }
  }
  // padded slots: src = dst = 0, mask 0, features of node 0
  for (int slot = min(rowoff[R], E) + threadIdx.x; slot < E;
       slot += ne * 32) {
    src_out[slot] = 0;
    dst_out[slot] = 0;
    mask_out[slot] = 0.f;
    for (int a = 0; a < 3; ++a) {
      ef_out[slot * 6 + a] = from_f32<CD>(pos[a]);
      ef_out[slot * 6 + 3 + a] = from_f32<CD>(pos[a]);
    }
  }
  edge_barrier(ne);
  for (int j = threadIdx.x; j < R; j += ne * 32)
    inv_deg[(size_t)s * R + j] = 1.f / (float)max(deg[j], 1);
}

// The encoder half, on warps ne .. ne+nn-1: the LSTM over the T frames and
// lstm_fc, into columns D .. D+2 of feat. Three lanes a residue, lane q
// computing the four gates of hidden unit q (columns g * 3 + q, g = i, f,
// g, o) with their weights in registers: every lane runs the same code.
template <int NFP>
__device__ __forceinline__ void encode_lstm(const Layout& l, float* sm, int T,
                                            int R, int D, int ne, int nn) {
  const int lane = threadIdx.x % 32, nwarp = threadIdx.x / 32 - ne;
  const int sub = lane / kHidden, q = lane % kHidden, lead = lane - q;
  const float* w_ih = sm + l.lstm;                // (3, 12)
  const float* w_hh = w_ih + 3 * kGates;          // (3, 12)
  const float* b_ih = w_hh + kHidden * kGates;    // (12)
  const float* b_hh = b_ih + kGates;              // (12)
  const float* lfc_w = b_hh + kGates;             // (3, 3)
  const float* lfc_b = lfc_w + kHidden * 3;       // (3)
  float wi[3][4], wh[kHidden][4], bias[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int k = g * kHidden + q;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      wi[a][g] = w_ih[a * kGates + k];
      wh[a][g] = w_hh[a * kGates + k];
    }
    bias[g] = b_ih[k] + b_hh[k];
  }
  const int frame = R * 3;
  for (int r0 = nwarp * kResPerWarp; r0 < R; r0 += nn * kResPerWarp) {
    const int r = r0 + sub;
    const bool valid = sub < kResPerWarp && r < R;
    const float* x = sm + l.win + min(r, R - 1) * 3;
    // input projection and biases of frame t, off the chain of h
    float nxt[4];
    auto project = [&](int t) {
      const float* xt = x + t * frame;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        nxt[g] = fmaf(xt[2], wi[2][g], fmaf(xt[1], wi[1][g], xt[0] * wi[0][g]))
                 + bias[g];
    };
    project(0);
    float h0 = 0.f, h1 = 0.f, h2 = 0.f, c = 0.f;
    for (int t = 0; t < T; ++t) {
      float act[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        act[g] = fmaf(h2, wh[2][g], fmaf(h1, wh[1][g], fmaf(h0, wh[0][g], nxt[g])));
      project(min(t + 1, T - 1));  // the next frame's (the last one's again at the end)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        act[g] = g == 2 ? tanhf(act[g]) : 1.f / (1.f + expf(-act[g]));
      c = act[1] * c + act[0] * act[2];
      const float hq = act[3] * tanhf(c);
      h0 = __shfl_sync(kFull, hq, lead);
      h1 = __shfl_sync(kFull, hq, lead + 1);
      h2 = __shfl_sync(kFull, hq, lead + 2);
    }
    if (valid)
      sm[l.feat + r * NFP + D + q] =
          fmaf(h2, lfc_w[6 + q], fmaf(h1, lfc_w[3 + q], h0 * lfc_w[q])) + lfc_b[q];
  }
}

template <typename CD, int NFP>
__global__ void __launch_bounds__(kMaxWarps * 32) graph_encode_kernel(
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
    int dh, float dh_kappa, float dh_lb, float dh_min_dist, int ne, int nn,
    int* __restrict__ edges,            // (S, 2, E)
    float* __restrict__ mask,           // (S, E)
    int* __restrict__ count,            // (S)
    int* __restrict__ overflow,         // (1), OR-ed across steps
    float* __restrict__ inv_deg,        // (S, R)
    CD* __restrict__ ef,                // (S, E, 6)
    float* __restrict__ x0) {           // (S, R, W)
  extern __shared__ float sm[];
  const Layout l = layout(T, R, D, W, dh);
  const int s = blockIdx.x;
  const int nf = D + 3 + (dh ? 1 : 0);  // fc1 inputs: [emb ; lstm ; phi]

  // 0. one asynchronous staging of the window and every weight, one wait;
  // the padding of feat and fc1w zeroed meanwhile
  stage(sm + l.win, window + (size_t)s * T * R * 3, T * R * 3);
  stage(sm + l.feat, emb_aa, R * D, D, NFP);
  stage(sm + l.fc1w, fc1_w, nf * W);
  for (int i = threadIdx.x; i < R * NFP; i += blockDim.x)
    if (i % NFP >= nf) sm[l.feat + i] = 0.f;
  for (int i = nf * W + threadIdx.x; i < NFP * W; i += blockDim.x)
    sm[l.fc1w + i] = 0.f;
  stage(sm + l.fc1b, fc1_b, W);
  float* lstm = sm + l.lstm;
  stage(lstm, w_ih, 3 * kGates);
  stage(lstm + 3 * kGates, w_hh, kHidden * kGates);
  stage(lstm + 6 * kGates, b_ih, kGates);
  stage(lstm + 7 * kGates, b_hh, kGates);
  stage(lstm + 8 * kGates, lfc_w, kHidden * 3);
  stage(lstm + 8 * kGates + kHidden * 3, lfc_b, 3);
  if (dh) stage(sm + l.charges, charges, R);
  int* deg = reinterpret_cast<int*>(sm + l.deg);
  for (int i = threadIdx.x; i < R; i += blockDim.x) deg[i] = 0;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // 1. the two halves, concurrently
  if ((int)threadIdx.x < ne * 32)
    build_graph<CD, NFP>(l, sm, T, R, nf, E, thr2, dh, dh_kappa, dh_lb,
                    dh_min_dist, ne, s, edges, mask, count, overflow, inv_deg,
                    ef);
  else
    encode_lstm<NFP>(l, sm, T, R, D, ne, nn);
  __syncthreads();

  // 2. fc1 + ReLU -> x0 on every warp: lane o holds column o of fc1 (zero
  // rows past nf) in registers, a warp takes one residue's row of inputs
  // at a time, NFP / 4 16-byte loads; the zero terms come after the real
  // ones and add exactly nothing
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  for (int o = lane; o < W; o += 32) {
    float wc[NFP];
#pragma unroll
    for (int k = 0; k < NFP; ++k) wc[k] = sm[l.fc1w + k * W + o];
    const float b = sm[l.fc1b + o];
    for (int r = warp; r < R; r += nwarps) {
      const float4* f = reinterpret_cast<const float4*>(sm + l.feat + r * NFP);
      float a = 0.f;
#pragma unroll
      for (int v = 0; v < NFP / 4; ++v) {
        const float4 fv = f[v];
        a = fmaf(fv.x, wc[4 * v], a);
        a = fmaf(fv.y, wc[4 * v + 1], a);
        a = fmaf(fv.z, wc[4 * v + 2], a);
        a = fmaf(fv.w, wc[4 * v + 3], a);
      }
      x0[((size_t)s * R + r) * W + o] = relu_nan(a + b);
    }
  }
}

// The current card's per-block opt-in maximum of shared memory (read on
// every call: nothing is kept across devices or threads).
int max_smem_optin(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  return (int)err;
}

// The shapes the kernel takes, besides shared memory: fc1's inputs sit in
// registers, a row's contact words one a lane.
bool takes(int T, int R, int D, int W, int dh) {
  return T >= 1 && R >= 1 && D >= 0 && W >= 1 &&
         D + 3 + (dh ? 1 : 0) <= kMaxFeat && R <= 32 * kMaxWords;
}

template <typename CD, int NFP>
int launch(int S, int threads, size_t smem, cudaStream_t st,
           const float* window, const float* emb_aa, const float* w_ih,
           const float* w_hh, const float* b_ih, const float* b_hh,
           const float* lfc_w, const float* lfc_b, const float* fc1_w,
           const float* fc1_b, const float* charges, int T, int R, int D,
           int W, int E, float thr2, int dh, float dh_kappa, float dh_lb,
           float dh_min_dist, int ne, int nn, int* edges, float* mask,
           int* count, int* overflow, float* inv_deg, void* ef, float* x0) {
  // the opt-in above 48 KB, set on the current device at every launch
  // that needs it (a cheap call; no state kept per device or thread)
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_encode_kernel<CD, NFP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  graph_encode_kernel<CD, NFP><<<S, threads, smem, st>>>(
      window, emb_aa, w_ih, w_hh, b_ih, b_hh, lfc_w, lfc_b, fc1_w, fc1_b,
      charges, T, R, D, W, E, thr2, dh, dh_kappa, dh_lb, dh_min_dist, ne, nn,
      edges, mask, count, overflow, inv_deg, static_cast<CD*>(ef), x0);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch shape of a (T, R, D, W, dh) encoder: the dynamic shared memory
// it needs, its threads a block, the current card's per-block opt-in
// maximum, and the most residues and fc1 inputs the kernel takes (set
// first, whatever the shape). cudaErrorInvalidValue for a shape past those
// two. The wrapper refuses a shape whose smem exceeds max_smem before
// launching.
extern "C" int mdno_graph_encode_plan(int T, int R, int D, int W, int dh,
                                      int* smem, int* threads, int* max_smem,
                                      int* max_nodes, int* max_features) {
  *max_nodes = 32 * kMaxWords;
  *max_features = kMaxFeat;
  if (!takes(T, R, D, W, dh)) return (int)cudaErrorInvalidValue;
  int ne, nn;
  warps(R, &ne, &nn);
  *smem = layout(T, R, D, W, dh).total * 4;
  *threads = (ne + nn) * 32;
  return max_smem_optin(max_smem);
}

extern "C" int mdno_graph_encode(
    const float* window, const float* emb_aa, const float* w_ih,
    const float* w_hh, const float* b_ih, const float* b_hh,
    const float* lfc_w, const float* lfc_b, const float* fc1_w,
    const float* fc1_b, const float* charges, int S, int T, int R, int D,
    int W, int E, float thr2, int cd_bf16, int dh, float dh_kappa,
    float dh_lb, float dh_min_dist, int* edges, float* mask, int* count,
    int* overflow, float* inv_deg, void* ef, float* x0, void* stream) {
  if (S < 1 || E < 1 || !takes(T, R, D, W, dh) || (dh && charges == nullptr))
    return (int)cudaErrorInvalidValue;
  int ne, nn, max_smem = 0;
  warps(R, &ne, &nn);
  const size_t smem = (size_t)layout(T, R, D, W, dh).total * 4;
  const int rc = max_smem_optin(&max_smem);
  if (rc != 0) return rc;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = D + 3 + (dh ? 1 : 0) > 8;
  auto go = cd_bf16 ? (wide ? launch<__nv_bfloat16, 16> : launch<__nv_bfloat16, 8>)
                    : (wide ? launch<float, 16> : launch<float, 8>);
  return go(S, (ne + nn) * 32, smem, st, window, emb_aa, w_ih, w_hh, b_ih,
            b_hh, lfc_w, lfc_b, fc1_w, fc1_b, charges, T, R, D, W, E, thr2,
            dh, dh_kappa, dh_lb, dh_min_dist, ne, nn, edges, mask, count,
            overflow, inv_deg, ef, x0);
}
