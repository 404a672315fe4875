// The reverse sweep of the training conv stack (train_conv_bwd.cu) in the
// frame of conv_stack.cuh: one example a cluster of NCL = 8 blocks. It
// computes, from the saved activations, what ops/conv_stack.py's
// conv_stack_backward does: dx0, dK, droot1/2 and dbias1/2 of one example.
//
// Two bodies, chosen by dtype and width alone (plan(), Plan::mma), as the
// forward's are: run_mma, bf16 at width 64 (the training main path,
// kMmaThreads threads), on the tensor cores with counted stores between
// the layers; run_fma, f32 and other widths (kThreads threads), on CUDA
// cores with one split cluster barrier a layer and every layer's dagg and
// dz kept in device memory, so that it takes widths up to 128 in f32 and
// 256 in bf16 (see run_fma). Both deal by source and keep the same
// padded-slot rule. The rest of this note is run_mma's.
//
// Deal by source. deal() gets the edge rows swapped (dst as the "source",
// src as the "target"), so a block owns node n together with every real
// edge whose source is n: dx[n] = sum over those edges, and no partial sum
// crosses blocks. The contact graph is symmetric, so this is as balanced as
// the forward. The K rows of a block's edges are staged as in run_mma (the
// first kRegEdges edges of a warp's first node in its registers, the rest
// swizzled in shared memory, what is left over read from L2), and each is
// the mma's A operand WITHOUT .trans: dxs_e = K_e dm_e is the forward's
// product turned over. The root product dz @ root^T goes the same way.
//
// A layer l, from 2*depth - 1 down to 0, one warp an item (owned node n, 32
// rows of dx), no cluster barrier:
//   dx'[n] = sum_{e: src = n} cd(K_e cd(dagg_l[dst e])) + cd(root) cd(dz_l[n])
// messages rounded to bf16 on the accumulators and summed in f32 in slot
// order (mma_row). The item that forms dx'[n] forms at once, for its 32
// columns, dz_{l-1}[n] = dx'[n] * (stack[l][n] > 0) and dagg_{l-1}[n] =
// cd(dz * inv_deg[n]), and sends dagg to every block and cd(dz) to its own
// as counted stores (st.async) against the mbarrier of layer l - 1 there;
// at layer 0 it writes dx0 instead. The first layer's dz comes from g_out
// the same way before the sweep. Every layer has its own dagg buffer and
// mbarrier (armed once with R rows from all blocks and the block's own dz
// rows): nothing is overwritten, and the buffers stay for the dK pass.
// Keeping them in shared memory (2 * 2*depth * R * 64 bf16, 86 KB at R =
// 28, depth 6) leaves 15 staged K rows beside the 16 a block holds in
// registers, more than the most loaded block needs at the training shapes
// (at most 14 past its registers over 570 windows of the training chain
// under the deal by in-degree, 15 under the greedy deal before it);
// writing dagg to a scratch in device memory
// instead would stage 4 more rows that no block uses, and the dK pass
// would read its operand from L2.
//
// After the sweep, with every layer's barrier complete:
//   droot, dbias  droot = sum_l sum_{n owned} cd(x_l[n])^T (x) cd(dz_l[n])
//                 on CUDA cores (a thread 16 elements), dbias summed by the
//                 items in registers; the cluster's partials are added in
//                 rank order through distributed shared memory, no atomics.
//   dK            per owned node n, A = X_n^T (w x 2*depth, rows
//                 cd(stack[l][n]), zero-padded to a k-step of 16, staged by
//                 the warp), and per out-edge e, B = DM_e (rows
//                 cd(dagg_l[dst e])): one 64x64x16 product a k-step, 32
//                 mma, rounded once to bf16 and stored as 8-byte rows.
//   padded slots  (mask 0) keep the contract of the plain version and the
//                 TPU kernel: dK = sum_l cd(x_l[0]) (x) cd(dagg_l[0]), the
//                 same product with n = dst = 0, the k-th padded slot
//                 written by block k % NCL; the caller's mask zeroes it.
// Results depend on the example's edge list and the cluster rank alone.
#pragma once

#include "conv_stack.cuh"

namespace conv_stack_bwd {

using namespace conv_stack;

constexpr int kWarps = kMmaThreads / 32;

// Four 8x8 bf16 matrices as they are stored: the A fragment of a row-major
// (16, 16) tile with the addresses the sweep gives it.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Bytes between two layers' (R, 64) bf16 buffers: 16 more than a buffer, so
// that the eight layers of one ldmatrix row group fall on eight bank groups.
__host__ __device__ inline size_t hist_stride(int R) {
  return (size_t)R * kMmaW * 2 + 16;
}

// What the region of the K rows holds after the sweep: from its start the
// droot (2, 64, 64) and dbias (2, 64) partials read by the cluster, then
// each warp's dbias (2, 32), then each warp's X_n^T, 2 KB a k-step of 16
// layers.
__host__ __device__ inline size_t end_warp_dbias() {
  return (size_t)2 * kMmaW * kMmaW * 4 + 2 * kMmaW * 4;
}
__host__ __device__ inline size_t end_xstage() {
  return end_warp_dbias() + (size_t)kWarps * 2 * 32 * 4;
}
__host__ __device__ inline size_t end_bytes(int nlayers) {
  return end_xstage() + (size_t)kWarps * ((nlayers + 15) / 16) * 2048;
}

// Byte offsets of a block's dynamic shared memory, host and device.
struct Layout {
  size_t ks, root, dagg, dz, meta, zero, bar, ints, total;
};

__host__ __device__ inline Layout layout(int R, int E, int nlayers, int cap) {
  Layout l;
  const size_t krows = (size_t)cap * kMmaRow, endb = end_bytes(nlayers);
  l.ks = 0;
  l.root = up16(krows > endb ? krows : endb);
  l.dagg = l.root + (size_t)kMmaRow;
  l.dz = l.dagg + (size_t)nlayers * hist_stride(R);
  l.meta = l.dz + (size_t)nlayers * hist_stride(R);
  l.zero = l.meta + (size_t)E * 16;
  l.bar = l.zero + 16;
  l.ints = l.bar + up16((size_t)nlayers * 8);
  l.total = l.ints + lists_bytes(R, E);
  return l;
}

// The tensor-core body's launch shape: kMmaThreads threads, the K rows
// staged a block, the shared memory. cudaErrorInvalidValue for a dtype or
// width it does not take, cudaErrorInvalidConfiguration when its buffers
// alone exceed shared memory.
inline int plan_mma(int R, int W, int E, int depth, int cd_size, Plan* out) {
  if (!takes_mma(W, cd_size)) return (int)cudaErrorInvalidValue;
  const int nlayers = 2 * depth;
  const size_t fixed = layout(R, E, nlayers, 0).total;
  if (fixed > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const size_t rest = fixed - up16(end_bytes(nlayers));
  const size_t fit = ((size_t)kMaxSmem - rest) / kMmaRow;
  out->mma = true;
  out->threads = kMmaThreads;
  out->cap = (int)(fit < (size_t)E ? fit : (size_t)E);
  out->smem = layout(R, E, nlayers, out->cap).total;
  return 0;
}

// Byte offset, inside a swizzled (64, 64) matrix, of this lane's ldmatrix
// row for the A fragment of rows 16 mt .. (of the stored matrix) at k-step
// kk (its columns 16 kk ..), read as stored (frag_cols reads it turned
// over, as run_mma reads K^T).
__device__ __forceinline__ unsigned frag_rows(int lane, int mt, int kk) {
  const int lq = lane >> 3, lr = lane & 7;
  return swizzled(16 * mt + (lq & 1) * 8 + lr, 2 * kk + (lq >> 1));
}

// droot1, droot2 (W, W) and dbias1, dbias2 (W) of stream s: the sum over
// the cluster, in rank order, of every block's partials, laid out in its
// shared ``scr`` as (2, W, W) then (2, W). Every thread of every block
// calls it after a cluster barrier that follows the partials; it reads the
// other blocks' shared memory, so no block may leave before they are
// through (the caller's closing cluster barrier).
__device__ inline void sum_over_cluster(const float* scr, int W, int s,
                                        float* droot1, float* dbias1,
                                        float* droot2, float* dbias2) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ncl = (int)cluster.num_blocks();
  const int nt = blockDim.x;
  const size_t WW = (size_t)W * W, n_all = 2 * WW + 2 * W;
  for (size_t e = (size_t)rank * nt + threadIdx.x; e < n_all;
       e += (size_t)ncl * nt) {
    float sum = 0.f;
    for (int q = 0; q < ncl; ++q)
      sum += cluster.map_shared_rank(const_cast<float*>(scr), q)[e];
    if (e < WW) droot1[s * WW + e] = sum;
    else if (e < 2 * WW) droot2[s * WW + e - WW] = sum;
    else if (e < 2 * WW + W) dbias1[(size_t)s * W + e - 2 * WW] = sum;
    else dbias2[(size_t)s * W + e - 2 * WW - W] = sum;
  }
}

// This block's padded slots (mask 0): the k-th padded slot of the example
// is block k % ncl's; written in slot order into ``pads`` by warp 0, their
// count returned to every thread. The caller syncs the block before
// reading ``pads``.
__device__ inline int own_pads(const Lists& L, int E, int rank, int ncl,
                               int* pads) {
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  int all = 0;
  for (int e0 = 0; e0 < E; e0 += 32) {
    const int e = e0 + lane;
    const bool pad = e < E && L.gdst[e] < 0;
    const unsigned bits = __ballot_sync(0xffffffffu, pad);
    const int k = all + __popc(bits & lanes_below);
    if (wid == 0 && pad && k % ncl == rank) pads[k / ncl] = e;
    all += __popc(bits);
  }
  return all > rank ? (all - rank + ncl - 1) / ncl : 0;
}

// One example's reverse sweep and gradients. Every thread of every block
// of the cluster calls it; writes dx0, dK, droot and dbias of stream
// blockIdx.x / NCL.
__device__ inline void run_mma(
    unsigned char* smem_raw,
    const float* __restrict__ g_out,    // (S, R, W)
    const float* __restrict__ stack,    // (S, 2*depth+1, R, W)
    const __nv_bfloat16* __restrict__ K,  // (S, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (S, 2, E)
    const float* __restrict__ mask,     // (S, E), 0/1
    const float* __restrict__ inv_deg,  // (S, R)
    const __nv_bfloat16* __restrict__ root1,
    const __nv_bfloat16* __restrict__ root2,
    float* __restrict__ dx0,            // (S, R, W)
    __nv_bfloat16* __restrict__ dK,     // (S, E, W*W)
    float* __restrict__ droot1,         // (S, W, W)
    float* __restrict__ dbias1,         // (S, W)
    float* __restrict__ droot2, float* __restrict__ dbias2,
    int R, int E, int depth, int cap) {
  using bf16 = __nv_bfloat16;
  constexpr int W = kMmaW;
  constexpr int RE = kRegEdges;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int s = blockIdx.x / ncl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, wid = tid / 32, nw = nt / 32;
  const int g = lane >> 2, t = lane & 3;  // the mma's row group and lane of four
  const int lq = lane >> 3, lr = lane & 7;
  const int nlayers = 2 * depth, RW = R * W;

  const Layout l = layout(R, E, nlayers, cap);
  unsigned char* ks = smem_raw + l.ks;
  unsigned char* root_s = smem_raw + l.root;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw + l.bar);
  int4* meta = reinterpret_cast<int4*>(smem_raw + l.meta);
  const unsigned hs = (unsigned)hist_stride(R);
  const unsigned dagg_a = smem_u32(smem_raw + l.dagg);
  const unsigned dz_a = smem_u32(smem_raw + l.dz);
  const unsigned zero_a = smem_u32(smem_raw + l.zero);
  const float* stack_s = stack + (size_t)s * (nlayers + 1) * RW;

  // ---- prologue: the barriers, the deal by source, this block's K rows ----
  if (tid == 0) {
    // two arrivals a layer: the R rows of dagg from the cluster, armed now,
    // before any block can send; the block's own dz rows, once dealt
    for (int i = 0; i < nlayers; ++i) mbar_init(&bar[i], 2);
    mbar_init_fence();
    for (int i = 0; i < nlayers; ++i)
      mbar_arrive_expect_tx(&bar[i], (unsigned)(RW * 2));
  }
  if (tid < 4) reinterpret_cast<unsigned*>(smem_raw + l.zero)[tid] = 0u;
  cluster_arrive();
  stage_matrix(smem_u32(root_s), root2);  // the sweep starts with conv2's
  const int* e_g = edges + (size_t)s * 2 * E;
  const Lists L = deal(smem_raw + l.ints, e_g + E, e_g, mask + (size_t)s * E,
                       inv_deg + (size_t)s * R, R, E, rank, ncl, cap, nw / 2,
                       RE);
  const int nown = L.nown, ne = L.ne;
  if (tid == 0)
    for (int i = 0; i < nlayers; ++i)
      mbar_arrive_expect_tx(&bar[i], (unsigned)(nown * W * 2));
  const unsigned char* Kb = reinterpret_cast<const unsigned char*>(K);
  stage_rows(smem_u32(ks), Kb, s, E, L.pslot, 0, min(ne, cap), 0);
  // what an item reads of edge i: the byte offset of its staged row (-1:
  // none), of its target's dagg row, and its slot
  for (int i = tid; i < ne; i += nt)
    meta[i] = make_int4(L.lrow[i] < 0 ? -1 : L.lrow[i] * kMmaRow,
                        L.lsrc[i] * W * 2, 0, L.lslot[i]);
  cluster_wait();
  cp_async_wait_all();
  __syncthreads();

  // every item of a warp has the same 32 rows: 256 threads, 8 warps
  const int h = wid & 1;
  unsigned fo[2][4];  // fragment offsets of its two tiles, by k-step
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fo[m][kk] = frag_rows(lane, 2 * h + m, kk);
  // d += the (64, 64) matrix at shared address ``mat``, rows 32 h .., times
  // the bf16 row whose B registers start at ``xp``
  auto product_staged = [&](float (&d)[2][2][4], unsigned mat, unsigned xp) {
    unsigned a[2][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4(a[0][kk], mat + fo[0][kk]);
      ldmatrix_x4(a[1][kk], mat + fo[1][kk]);
    }
    mma_row(d, a, xp);
  };
  // the same from a K row in global memory (an edge without a staged row)
  auto product_global = [&](float (&d)[2][2][4], const unsigned* kg,
                            unsigned xp) {
    unsigned a[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned* p = kg + ((32 * h + 16 * m + g) * W + 16 * kk + 2 * t) / 2;
        a[m][kk][0] = p[0];
        a[m][kk][1] = p[4 * W];
        a[m][kk][2] = p[4];
        a[m][kk][3] = p[4 * W + 4];
      }
    mma_row(d, a, xp);
  };

  struct Item {
    int j, first, past, staged_end;
    float invd;
  };
  auto item_of = [&](int u, int nheld) {
    const int n = u >> 1;
    Item it;
    it.j = L.mynode[n];
    it.first = L.nstart[n] + nheld;
    it.past = L.nstart[n + 1];
    it.staged_end = max(it.first, min(it.past, cap + L.regoff[n + 1]));
    it.invd = L.own_invd[n];
    return it;
  };
  const bool works = wid < 2 * nown;  // this warp has items
  unsigned held[RE][2][4][4];
  int nheld = 0;
  Item mine = {};
  if (works) {
    const int n = wid >> 1;
    nheld = L.regoff[n + 1] - L.regoff[n];
    mine = item_of(wid, nheld);
#pragma unroll
    for (int e = 0; e < RE; ++e) {
      const unsigned at =
          smem_u32(ks) + (e < nheld ? L.regoff[n] + e : 0) * kMmaRow;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4(held[e][0][kk], at + fo[0][kk]);
        ldmatrix_x4(held[e][1][kk], at + fo[1][kk]);
      }
    }
  }
  if (ne > cap) {
    __syncthreads();
    stage_rows(smem_u32(ks), Kb, s, E, L.pslot, cap, min(ne, cap + L.nreg), cap);
    cp_async_wait_all();
    __syncthreads();
  }

  // where this lane sends dagg: block 4 (g % 4) + t; its own dz: one lane a
  // half, to this block
  const int to_rank = (g & 3) * 4 + t;
  const bool sends = to_rank < ncl;
  const bool sends_dz = (g & 3) == 0 && t == 0;
  const unsigned to_dagg = map_to_block(dagg_a, sends ? to_rank : rank);
  const unsigned to_bar = map_to_block(smem_u32(bar), sends ? to_rank : rank);
  const unsigned my_dz = map_to_block(dz_a, rank);
  const unsigned my_bar = map_to_block(smem_u32(bar), rank);
  float db[2][2][2] = {};  // dbias of this lane's 4 columns: [root][tile][+8]

  // dz of layer lt for the item's node and 32 columns, from dx (this lane's
  // rows 16 m + g, + 8) and the saved x_out = stack[lt + 1] there: summed
  // into dbias, sent as dagg to every block and as cd(dz) to this one
  auto emit = [&](int lt, const Item& it, const float (&dx)[2][2],
                  const float (&xo)[2][2]) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float z0 = __fmul_rn(dx[m][0], xo[m][0] > 0.f ? 1.f : 0.f);
      const float z1 = __fmul_rn(dx[m][1], xo[m][1] > 0.f ? 1.f : 0.f);
      if (lt < depth) {
        db[0][m][0] += z0;
        db[0][m][1] += z1;
      } else {
        db[1][m][0] += z0;
        db[1][m][1] += z1;
      }
      const uint4 da = tile_half(__fmul_rn(z0, it.invd), __fmul_rn(z1, it.invd), g);
      const uint4 dz = tile_half(z0, z1, g);
      const unsigned off =
          lt * hs + (it.j * W + (2 * h + m) * 16 + (g >> 2) * 8) * 2;
      if (sends) store_counted16(to_dagg + off, da, to_bar + lt * 8);
      if (sends_dz) store_counted16(my_dz + off, dz, my_bar + lt * 8);
    }
  };
  // the lane's rows of (layer, node j): row 16 (2 h + m) + g (+ 8)
  auto load_rows = [&](float (&v)[2][2], const float* base, int j) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      v[m][0] = base[j * W + (2 * h + m) * 16 + g];
      v[m][1] = base[j * W + (2 * h + m) * 16 + g + 8];
    }
  };

  // ---- the sweep ----------------------------------------------------------------
  for (int u = wid; u < 2 * nown; u += nw) {  // dz of the last layer, from g_out
    const Item it = u == wid ? mine : item_of(u, 0);
    float dx[2][2], xo[2][2];
    load_rows(dx, g_out + (size_t)s * RW, it.j);
    load_rows(xo, stack_s + (size_t)nlayers * RW, it.j);
    emit(nlayers - 1, it, dx, xo);
  }
  for (int layer = nlayers - 1; layer >= 0; --layer) {
    if (layer == depth - 1) {  // the only block barriers of the sweep
      __syncthreads();         // every reader of root2 is through
      stage_matrix(smem_u32(root_s), root1);
      cp_async_wait_all();
      __syncthreads();
    }
    if (works) mbar_wait(&bar[layer], 0);
    const unsigned hc = dagg_a + layer * hs;  // this layer's dagg, all nodes
    const unsigned zc = dz_a + layer * hs;    // and dz, the owned nodes
    for (int u = wid; u < 2 * nown; u += nw) {
      const bool first_item = u == wid;
      const Item it = first_item ? mine : item_of(u, 0);
      // the relu mask of the layer below, on its way while the products run
      float xo[2][2] = {};
      if (layer > 0) load_rows(xo, stack_s + (size_t)layer * RW, it.j);
      // the root product first: it waits for nothing
      float dr[2][2][4] = {};
      product_staged(dr, smem_u32(root_s), zc + it.j * W * 2 + t * 8);
      float agg[2][2] = {};
      // a message: the two half sums added and rounded to bf16
      auto add = [&](const float (&d)[2][2][4]) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const unsigned p = pack_bf16(d[m][0][0] + d[m][1][0],
                                       d[m][0][2] + d[m][1][2]);
          agg[m][0] += __uint_as_float(p << 16);
          agg[m][1] += __uint_as_float(p & 0xffff0000u);
        }
      };
      // the node's out-edges in slot order: held in registers, staged, L2
      if (first_item && nheld > 0) {
#pragma unroll
        for (int e = 0; e < RE; ++e) {
          // an edge this warp does not hold repeats the first and is dropped
          const int4 me = meta[it.first - nheld + (e < nheld ? e : 0)];
          float d[2][2][4] = {};
          mma_row(d, held[e], hc + me.y + t * 8);
          if (e < nheld) add(d);
        }
      }
      int i = it.first;
      for (; i < it.staged_end; ++i) {
        const int4 me = meta[i];
        float d[2][2][4] = {};
        product_staged(d, smem_u32(ks) + me.x, hc + me.y + t * 8);
        add(d);
      }
      for (; i < it.past; ++i) {
        const int4 me = meta[i];
        float d[2][2][4] = {};
        product_global(d,
                       reinterpret_cast<const unsigned*>(K) +
                           ((size_t)s * E + me.w) * (W * W / 2),
                       hc + me.y + t * 8);
        add(d);
      }
      float dx[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        dx[m][0] = __fadd_rn(dr[m][0][0] + dr[m][1][0], agg[m][0]);
        dx[m][1] = __fadd_rn(dr[m][0][2] + dr[m][1][2], agg[m][1]);
      }
      if (layer > 0) {
        emit(layer - 1, it, dx, xo);
      } else {
        // lane t stores tile t / 2, row g + 8 (t % 2): 128 bytes a warp
        const float v = t == 0 ? dx[0][0] : t == 1 ? dx[0][1]
                        : t == 2 ? dx[1][0] : dx[1][1];
        dx0[(size_t)s * RW + it.j * W + 32 * h + 8 * t + g] = v;
      }
    }
  }

  // ---- droot and dbias ------------------------------------------------------
  for (int i = 0; i < nlayers; ++i) mbar_wait(&bar[i], 0);
  __syncthreads();  // every item is through with the K rows
  float* scr = reinterpret_cast<float*>(ks);  // (2, W, W), then (2, W)
  float* wdb = reinterpret_cast<float*>(ks + end_warp_dbias());  // (nw, 2, 32)
  {
    // thread: row wi, positions 16 q .. 16 q + 15 of the dz rows
    const int wi = tid >> 2, q = tid & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float acc[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) acc[p] = 0.f;
      for (int lay = r * depth; lay < (r + 1) * depth; ++lay)
        for (int n = 0; n < nown; ++n) {
          const int j = L.mynode[n];
          const float x = round_cd<bf16>(stack_s[(size_t)lay * RW + j * W + wi]);
          const uint4* zp = reinterpret_cast<const uint4*>(
              smem_raw + l.dz + lay * hs + (j * W + 16 * q) * 2);
          const uint4 z0 = zp[0], z1 = zp[1];
          const unsigned zw[8] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
          for (int p = 0; p < 8; ++p) {
            acc[2 * p] = fmaf(x, __uint_as_float(zw[p] << 16), acc[2 * p]);
            acc[2 * p + 1] =
                fmaf(x, __uint_as_float(zw[p] & 0xffff0000u), acc[2 * p + 1]);
          }
        }
      // position p of the group is column 8 ((p >> 1) & 1) + 2 (p >> 2) + p % 2
#pragma unroll
      for (int p = 0; p < 16; ++p)
        scr[(r * W + wi) * W + 16 * q + 8 * ((p >> 1) & 1) + 2 * (p >> 2) + (p & 1)] =
            acc[p];
    }
    if (t == 0)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          wdb[(wid * 2 + r) * 32 + 16 * m + g] = db[r][m][0];
          wdb[(wid * 2 + r) * 32 + 16 * m + 8 + g] = db[r][m][1];
        }
  }
  __syncthreads();
  for (int c = tid; c < 2 * W; c += nt) {
    // the block's dbias: the warps of column half c / 32 in warp order
    const int r = c / W, col = c % W;
    float sum = 0.f;
    for (int w = col / 32; w < nw; w += 2) sum += wdb[(w * 2 + r) * 32 + col % 32];
    scr[2 * W * W + c] = sum;
  }
  cluster_arrive();
  cluster_wait();  // every block's partials are there
  sum_over_cluster(scr, W, s, droot1, dbias1, droot2, dbias2);
  cluster_arrive();  // through with the other blocks' partials

  // ---- dK -----------------------------------------------------------------------
  // this block's padded slots, into the list the K staging is done with
  int* pads = L.pslot;
  const int npad = own_pads(L, E, rank, ncl, pads);
  __syncthreads();
  // jobs: the block's edges in list order, then its padded slots; a warp
  // takes a run of them, so consecutive jobs share their node's X
  const int nks = (nlayers + 15) / 16;
  unsigned char* xst = ks + end_xstage() + (size_t)wid * nks * 2048;
  const int njobs = ne + npad;
  const int j0 = wid * njobs / nw, j1 = (wid + 1) * njobs / nw;
  int cur = -1, n = 0;
  for (int jb = j0; jb < j1; ++jb) {
    int src, dst_off, slot;
    if (jb < ne) {
      while (L.nstart[n + 1] <= jb) ++n;
      src = L.mynode[n];
      const int4 me = meta[jb];
      dst_off = me.y;
      slot = me.w;
    } else {
      src = 0;
      dst_off = 0;
      slot = pads[jb - ne];
    }
    if (src != cur) {
      // X_src^T: row l = cd(stack[l][src]), zero past the last layer,
      // swizzled as a K row
      __syncwarp();
      for (int idx = lane; idx < nks * 16 * 8; idx += 32) {
        const int row = idx >> 3, ch = idx & 7;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < nlayers) {
          const float4* p = reinterpret_cast<const float4*>(
              stack_s + (size_t)row * RW + src * W + ch * 8);
          const float4 a = p[0], b = p[1];
          v = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                         pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
        }
        *reinterpret_cast<uint4*>(xst + (row >> 4) * 2048 + swizzled(row & 15, ch)) = v;
      }
      __syncwarp();
      cur = src;
    }
    bf16* out = dK + ((size_t)s * E + slot) * W * W;
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {  // positions 16 q .. 16 q + 15 of a row
      float acc[4][2][4] = {};
      for (int kk = 0; kk < nks; ++kk) {
        unsigned a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4_trans(a[mt], smem_u32(xst) + kk * 2048 + frag_cols(lane, mt));
        // B: rows l = 16 kk + 8 (lq % 2) + lr of DM_e, positions
        // 16 q + 8 (lq / 2) ..; two n-tiles
        const int lay = 16 * kk + (lq & 1) * 8 + lr;
        unsigned b[4];
        ldmatrix_x4_trans(b, lay < nlayers ? dagg_a + lay * hs + dst_off +
                                                 (16 * q + (lq >> 1) * 8) * 2
                                           : zero_a);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_16816(acc[mt][0], a[mt], b[0], b[1]);
          mma_16816(acc[mt][1], a[mt], b[2], b[3]);
        }
      }
      // lane t holds columns {0, 1 | 4, 5} + (8 if t odd) + (2 if t >= 2)
      // of the group's 16 (n-tile 0 | 1): one exchange with lane t ^ 2 gives
      // it four consecutive ones, 8 bytes a store
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          const unsigned p0 = pack_bf16(acc[mt][0][2 * rh], acc[mt][0][2 * rh + 1]);
          const unsigned p1 = pack_bf16(acc[mt][1][2 * rh], acc[mt][1][2 * rh + 1]);
          const unsigned got = __shfl_xor_sync(0xffffffffu, t < 2 ? p1 : p0, 2);
          const uint2 v = t < 2 ? make_uint2(p0, got) : make_uint2(got, p1);
          const int row = 16 * mt + 8 * rh + g;
          const int col = 16 * q + 8 * (t & 1) + 4 * (t >> 1);
          *reinterpret_cast<uint2*>(out + row * W + col) = v;
        }
    }
  }
  cluster_wait();  // no block leaves while another reads its partials
}

// ---- run_fma ----------------------------------------------------------------------

// Byte offsets of the CUDA-core body's shared memory: the K^T rows staged,
// root^T, the dagg of the layer being swept (f32, rounded to CD), dz of two
// layers rounded to CD (the root product's operand), and the message and
// sum buffers. No buffer grows with the depth or W * W beyond root: every
// layer's dagg and dz go to the example's history in device memory
// (``hist``), which the sweep reads a layer at a time and the gradient pass
// reads whole.
struct FmaLayout {
  size_t kt, root, dagg, dz, msl, aggs, rxs, ints, total;
};

__host__ __device__ inline FmaLayout fma_layout(int R, int W, int E,
                                                int cd_size, int cap) {
  FmaLayout l;
  const size_t rw = (size_t)R * W * 4;
  l.kt = 0;
  l.root = up16((size_t)cap * W * W * cd_size);
  l.dagg = l.root + up16((size_t)W * W * cd_size);
  l.dz = l.dagg + rw;
  l.msl = l.dz + 2 * rw;
  l.aggs = l.msl + up16((size_t)kMsgRows * W * cd_size);
  l.rxs = l.aggs + rw;
  l.ints = l.rxs + rw;
  l.total = l.ints + lists_bytes(R, E);
  return l;
}

// Floats of the CUDA-core body's history an example: dagg and dz of every
// layer, (2, 2 * depth, R, W).
__host__ __device__ inline size_t hist_floats(int R, int W, int depth) {
  return (size_t)2 * 2 * depth * R * W;
}

// Four floats rounded to CD and stored at p (16-byte aligned for f32,
// 8-byte for bf16).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]),
                                            pack_bf16(v[2], v[3]));
}

// The body on CUDA cores, f32 and bf16 at widths other than 64 (kThreads
// threads a block), any width that is a multiple of 8 with W * sizeof(CD)
// <= 512. Same contract as run_mma, plus ``hist`` (S, 2, 2*depth, R, W)
// f32, device memory it may overwrite. Dealt by source as run_mma is; a
// layer is run_fma's (conv_stack.cuh) on the transposed graph, with ONE
// cluster barrier, split:
//   load     the layer's dagg from the history into shared memory (L2
//            reads: other blocks wrote it in this launch).
//   items    one warp an item: a message cd(K_e dagg[dst e]) of a local
//            edge, from K^T staged at the prologue (the edges beyond read
//            K from L2 a column at a time), or an owned node's root
//            product root cd(dz[n]); lanes split the item's w columns into
//            16-byte groups and its w-deep sum into parts, a butterfly
//            adds the parts.
//   combine  four lanes per owned node and 4 columns add the node's
//            messages in slot order, dx' = root product + their sum; then
//            dz and dagg of the layer below into the history (dz also into
//            this block's shared memory), or dx0 after layer 0.
// After the sweep, from the history: droot and dbias, each element summed
// by one thread over its layers in order and the nodes in index order (no
// partial sums, so nothing of W * W is held across the sweep), and dK of
// each edge and padded slot in 4 x 4 tiles of f32 sums over the layers, in
// layer order.
template <typename CD>
__device__ void run_fma(
    unsigned char* smem_raw, const float* __restrict__ g_out,
    const float* __restrict__ stack, const CD* __restrict__ K,
    const int* __restrict__ edges, const float* __restrict__ mask,
    const float* __restrict__ inv_deg, const CD* __restrict__ root1,
    const CD* __restrict__ root2, float* __restrict__ dx0,
    CD* __restrict__ dK, float* __restrict__ droot1,
    float* __restrict__ dbias1, float* __restrict__ droot2,
    float* __restrict__ dbias2, float* hist, int R, int W, int E, int depth,
    int cap) {
  constexpr int CPL = 16 / sizeof(CD);  // columns a lane owns in an item
  cluster_arrive();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int s = blockIdx.x / ncl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, wid = tid / 32, nw = nt / 32;
  const int nlayers = 2 * depth, RW = R * W, WW = W * W;

  const FmaLayout l = fma_layout(R, W, E, sizeof(CD), cap);
  CD* kt = reinterpret_cast<CD*>(smem_raw + l.kt);
  CD* rootT = reinterpret_cast<CD*>(smem_raw + l.root);
  float* dagg = reinterpret_cast<float*>(smem_raw + l.dagg);  // (R, W)
  float* dzb = reinterpret_cast<float*>(smem_raw + l.dz);     // (2, R, W)
  CD* msl = reinterpret_cast<CD*>(smem_raw + l.msl);
  float* aggs = reinterpret_cast<float*>(smem_raw + l.aggs);
  float* rxs = reinterpret_cast<float*>(smem_raw + l.rxs);
  const float* stack_s = stack + (size_t)s * (nlayers + 1) * RW;
  // the example's history, written and read in this launch: through L2
  // only (st.cg / ld.cg), never the non-coherent path
  float* hdagg = hist + (size_t)s * hist_floats(R, W, depth);  // (L, R, W)
  float* hdz = hdagg + (size_t)nlayers * RW;                    // (L, R, W)
  // dz of layer ``lay`` rounded to CD, for this block's owned nodes
  auto dzr = [&](int lay) { return dzb + (size_t)(lay & 1) * RW; };

  // ---- prologue: the deal by source, K^T of the staged edges --------------------
  const int* e_g = edges + (size_t)s * 2 * E;
  const Lists L = deal(smem_raw + l.ints, e_g + E, e_g, mask + (size_t)s * E,
                       inv_deg + (size_t)s * R, R, E, rank, ncl, cap, 0, 0);
  const int nown = L.nown, ne = L.ne;
  const int nst = min(ne, cap);  // edges whose K^T is staged
  for (size_t idx = tid; idx < (size_t)nst * WW; idx += nt) {
    const int i = (int)(idx / WW), r = (int)(idx % WW);  // r = wi W + v
    kt[(size_t)i * WW + (r % W) * W + r / W] = K[((size_t)s * E + L.lslot[i]) * WW + r];
  }
  // the owner of every local edge (for dK), in the list deal() is done with
  int* eown = L.lrow;
  for (int n = tid; n < nown; n += nt)
    for (int i = L.nstart[n]; i < L.nstart[n + 1]; ++i) eown[i] = L.mynode[n];

  // dz of layer lt at (node j, columns c4 ..) from dx there: part 0 of the
  // 4 lanes of a (node, columns) stores dz, part 1 dagg
  auto emit4 = [&](int lt, int j, int c4, const float (&dx)[4], float invd,
                   int part) {
    const float4 xo = *reinterpret_cast<const float4*>(
        stack_s + (size_t)(lt + 1) * RW + j * W + c4);
    const float xv[4] = {xo.x, xo.y, xo.z, xo.w};
    float z[4], zr[4], a[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      z[k] = __fmul_rn(dx[k], xv[k] > 0.f ? 1.f : 0.f);
      zr[k] = round_cd<CD>(z[k]);
      a[k] = round_cd<CD>(__fmul_rn(z[k], invd));
    }
    const size_t at = ((size_t)lt * R + j) * W + c4;
    if (part == 0) {
      *reinterpret_cast<float4*>(dzr(lt) + j * W + c4) =
          make_float4(zr[0], zr[1], zr[2], zr[3]);
      __stcg(reinterpret_cast<float4*>(hdz + at),
             make_float4(z[0], z[1], z[2], z[3]));
    } else if (part == 1) {
      __stcg(reinterpret_cast<float4*>(hdagg + at),
             make_float4(a[0], a[1], a[2], a[3]));
    }
  };

  // An output of the per-node sums: owned node n (node j of the stream),
  // columns c4 .. c4 + 3, one of four lanes that share the node's messages.
  struct Slot {
    bool valid;
    int part, n, c4, first, past, j;
    float invd;
  };
  const int W4 = W / 4;
  const int total = nown * W4 * 4;
  auto slot_of = [&](int idx) {
    Slot sl;
    sl.valid = idx < total;
    sl.part = idx & 3;
    const int q = idx >> 2;
    sl.n = sl.valid ? q / W4 : 0;
    sl.c4 = (q % W4) * 4;
    sl.first = L.nstart[sl.n];
    sl.past = L.nstart[sl.n + 1];
    sl.j = L.mynode[sl.n];
    sl.invd = L.own_invd[sl.n];
    return sl;
  };

  cluster_wait();
  // dz of the last layer, from g_out
  for (int idx = tid; idx < total; idx += nt) {
    const Slot sl = slot_of(idx);
    const float4 go = *reinterpret_cast<const float4*>(
        g_out + (size_t)s * RW + sl.j * W + sl.c4);
    const float dx[4] = {go.x, go.y, go.z, go.w};
    emit4(nlayers - 1, sl.j, sl.c4, dx, sl.invd, sl.part);
  }
  cluster_arrive();
  cluster_wait();  // the last layer's dagg is complete in the history

  // ---- lanes of an item -------------------------------------------------------
  const int groups = W / CPL;  // 16-byte column groups, at most 32
  const int splits = (groups & (groups - 1)) == 0 ? 32 / groups : 1;
  const int g = lane % groups, sp = lane / groups;
  const int nvi = (W + splits - 1) / splits;
  const int v0 = min(W, sp * nvi);
  const int v1 = sp < splits ? min(W, v0 + nvi) : v0;
  const bool writer = sp == 0 && lane < groups;

  for (int layer = nlayers - 1; layer >= 0; --layer) {
    if (layer == nlayers - 1 || layer == depth - 1) {
      const CD* root = layer < depth ? root1 : root2;
      for (int i = tid; i < WW; i += nt) rootT[(i % W) * W + i / W] = root[i];
    }
    {
      const float4* from = reinterpret_cast<const float4*>(hdagg + (size_t)layer * RW);
      float4* to = reinterpret_cast<float4*>(dagg);
      for (int i = tid; i < RW / 4; i += nt) to[i] = __ldcg(from + i);
    }
    __syncthreads();
    const float* zl = dzr(layer);

    // the block's edges in chunks (chunk_end): the first pass runs even
    // without edges, for the root products
    for (int base = 0, nchunk = -1; nchunk < 0 || base < ne; base += nchunk) {
      nchunk = chunk_end(L.nstart, nown, base, ne) - base;
      const int nitems = nchunk + (base == 0 ? nown : 0);
      // last items first: the root products and the edges read from L2
      for (int rev = wid; rev < nitems; rev += nw) {
        const int it = nitems - 1 - rev;
        const bool is_edge = it < nchunk;
        const int i = base + it, n = it - nchunk;
        const float* xs = is_edge ? dagg + L.lsrc[i] * W : zl + L.mynode[n] * W;
        float acc[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
        if (is_edge && i >= nst) {
          // K^T from L2: column v of the edge's K, CPL rows at a time
          const CD* kg = K + ((size_t)s * E + L.lslot[i]) * WW + (size_t)g * CPL * W;
          for (int v = v0; v < v1; ++v) {
            const float xv = xs[v];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              acc[c] = fmaf(xv, to_f32<CD>(kg[(size_t)c * W + v]), acc[c]);
          }
        } else {
          const CD* p = (is_edge ? kt + (size_t)i * WW : rootT) +
                        (size_t)v0 * W + g * CPL;
#pragma unroll 4
          for (int v = v0; v < v1; ++v, p += W) {
            float kv[CPL];
            load16(p, kv);
            const float xv = xs[v];
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[c] = fmaf(xv, kv[c], acc[c]);
          }
        }
        for (int off = groups; off < groups * splits; off <<= 1)
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
        if (writer) {
          if (is_edge) {
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              msl[it * W + g * CPL + c] = from_f32<CD>(acc[c]);
          } else {
#pragma unroll
            for (int c = 0; c < CPL; ++c) rxs[n * W + g * CPL + c] = acc[c];
          }
        }
      }
      __syncthreads();

      // per owned node and 4 columns, four lanes: each adds every fourth of
      // the node's messages of this chunk (in slot order), a butterfly adds
      // the four parts, (0 + 1) + (2 + 3)
      const bool more = base + nchunk < ne;
      for (int idx0 = 0; idx0 < total; idx0 += nt) {
        const Slot sl = slot_of(idx0 + tid);
        const int part = sl.part, n = sl.n, c4 = sl.c4;
        const int lo = max(sl.first, base);
        const int hi = sl.valid ? min(sl.past, base + nchunk) : lo;
        float agg[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = lo + part; i < hi; i += 4) {
          float m[4];
          load4(msl + (i - base) * W + c4, m);
          for (int k = 0; k < 4; ++k) agg[k] += m[k];
        }
        for (int k = 0; k < 4; ++k) {
          agg[k] += __shfl_xor_sync(0xffffffffu, agg[k], 1);
          agg[k] += __shfl_xor_sync(0xffffffffu, agg[k], 2);
        }
        if (!sl.valid) continue;
        if (base > 0)
          for (int k = 0; k < 4; ++k) agg[k] += aggs[n * W + c4 + k];
        if (more) {
          if (part == 0)
            for (int k = 0; k < 4; ++k) aggs[n * W + c4 + k] = agg[k];
          continue;
        }
        // dx' = cd(dz) @ cd(root)^T + the messages
        float rx[4], dx[4];
        load4(rxs + n * W + c4, rx);
        for (int k = 0; k < 4; ++k) dx[k] = __fadd_rn(rx[k], agg[k]);
        if (layer > 0) {
          emit4(layer - 1, sl.j, c4, dx, sl.invd, part);
        } else if (part == 0) {
          *reinterpret_cast<float4*>(dx0 + (size_t)s * RW + sl.j * W + c4) =
              make_float4(dx[0], dx[1], dx[2], dx[3]);
        }
      }
      if (more) __syncthreads();  // the next chunk overwrites the messages
    }
    cluster_arrive();
    cluster_wait();  // the layer below's dagg and dz complete in the history
  }

  // ---- droot and dbias of the example, from the history ------------------------
  // element e of (droot1, droot2, dbias1, dbias2), dealt over the cluster's
  // threads: sum over the conv's layers in order, the nodes in index order
  const size_t n_all = (size_t)2 * WW + 2 * W;
  for (size_t e = (size_t)rank * nt + tid; e < n_all; e += (size_t)ncl * nt) {
    const bool is_bias = e >= (size_t)2 * WW;
    const int idx = (int)(is_bias ? e - (size_t)2 * WW : e);
    const int conv = is_bias ? idx / W : idx / WW;  // 0 conv1, 1 conv2
    const int wi = is_bias ? 0 : (idx % WW) / W, v = idx % W;
    float sum = 0.f;
    for (int lay = conv * depth; lay < (conv + 1) * depth; ++lay) {
      const float* zc = hdz + (size_t)lay * RW + v;
      const float* xc = stack_s + (size_t)lay * RW + wi;
      if (is_bias) {
        for (int j = 0; j < R; ++j) sum += __ldcg(zc + (size_t)j * W);
      } else {
        for (int j = 0; j < R; ++j)
          sum = fmaf(round_cd<CD>(xc[(size_t)j * W]),
                     round_cd<CD>(__ldcg(zc + (size_t)j * W)), sum);
      }
    }
    if (!is_bias) (conv == 0 ? droot1 : droot2)[(size_t)s * WW + idx % WW] = sum;
    else (conv == 0 ? dbias1 : dbias2)[(size_t)s * W + v] = sum;
  }

  // ---- dK: 4 x 4 tiles, f32 sums over the layers in layer order ---------------------
  int* pads = L.pslot;
  const int npad = own_pads(L, E, rank, ncl, pads);
  __syncthreads();
  const int G = W / 4;
  const int njobs = ne + npad;
  for (size_t item = tid; item < (size_t)njobs * G * G; item += nt) {
    const int jb = (int)(item / (G * G)), tt = (int)(item % (G * G));
    const int wi0 = (tt / G) * 4, c0 = (tt % G) * 4;
    const bool edge = jb < ne;
    const int src = edge ? eown[jb] : 0, dst = edge ? L.lsrc[jb] : 0;
    const int slot = edge ? L.lslot[jb] : pads[jb - ne];
    float acc[4][4] = {};
    for (int lay = 0; lay < nlayers; ++lay) {
      const float4 x = *reinterpret_cast<const float4*>(
          stack_s + (size_t)lay * RW + src * W + wi0);
      const float xv[4] = {round_cd<CD>(x.x), round_cd<CD>(x.y),
                           round_cd<CD>(x.z), round_cd<CD>(x.w)};
      const float4 d = __ldcg(reinterpret_cast<const float4*>(
          hdagg + ((size_t)lay * R + dst) * W + c0));
      const float dm[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], dm[b], acc[a][b]);
    }
    CD* out = dK + ((size_t)s * E + slot) * WW;
#pragma unroll
    for (int a = 0; a < 4; ++a) store4(out + (size_t)(wi0 + a) * W + c0, acc[a]);
  }
}

// The launch shape of either body: cudaErrorInvalidValue for a width the
// bodies do not take, cudaErrorInvalidConfiguration when the buffers alone
// exceed shared memory. Plan::mma (bf16 at width 64) chooses the body.
inline int plan(int R, int W, int E, int depth, int cd_size, Plan* out) {
  if (takes_mma(W, cd_size)) return plan_mma(R, W, E, depth, cd_size, out);
  if (W % 8 != 0 || W * cd_size > 32 * 16) return (int)cudaErrorInvalidValue;
  const size_t fixed = fma_layout(R, W, E, cd_size, 0).total;
  if (fixed > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const size_t row = (size_t)W * W * cd_size;
  const size_t fit = ((size_t)kMaxSmem - fixed) / row;
  out->mma = false;
  out->threads = kThreads;
  out->cap = (int)(fit < (size_t)E ? fit : (size_t)E);
  out->smem = fma_layout(R, W, E, cd_size, out->cap).total;
  return 0;
}

}  // namespace conv_stack_bwd
