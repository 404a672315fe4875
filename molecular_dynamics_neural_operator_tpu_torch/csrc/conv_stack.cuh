// The 2*depth weight-tied edge convs of one stream on one thread-block
// cluster, shared by conv_head.cu (the rollout step: stack, head, slide),
// fused_gkn.cu (the fused MLP + conv stack, no head) and train_conv_fwd.cu
// (the training forward, one example a stream, which also keeps every
// layer's activations: the optional ``stack``). The training backward
// (conv_stack_bwd.cuh) runs in the same frame and shares deal(), the
// staging of K rows, mma_row() and the counted-store exchange. See
// conv_head.cu for what bounds it on an H100 and what was measured.
//
// One stream is one cluster of NCL blocks (kWideNCL in conv_head's wide
// plan, run_mma only: see run_mma). Edges are dealt to blocks by
// TARGET node (deal()): every block reads the stream's edge list, counts the
// real (mask > 0) incoming edges of each node and deals the nodes in order
// of in-degree (largest first, ties by index) back and forth over the blocks,
// a big node beside a small one, a rule that sees the stream's own graph
// only. A block keeps its nodes'
// incoming edge slots grouped by node, in slot order, and so owns the whole
// sum of every node it owns: no partial sums cross blocks. As many of its
// edges' K rows as fit are copied into shared memory once; the 2*depth
// layers read them there, and the edges left over from L2. x' of a layer is
// stored into the other of two x buffers in every block of the cluster
// through distributed shared memory; the buffers alternate, so a block still
// reading layer l's input is never written under.
//
// Two bodies share that frame.
//
// run_mma (bf16 at width 64, the rollout's shapes, 256 threads): the tensor
// cores. A message x_src @ K_e is one row times a 64x64 matrix, so the
// product is turned over: K_e^T is the mma's A operand (16 output columns by
// 16 of the sum a fragment, read from the staged row by ldmatrix.trans; the
// rows are stored with their 16-byte chunks XOR-swizzled by the row index,
// so the eight rows of a fragment fall on eight different bank groups) and
// x_src fills every column of B, so each lane ends with the outputs of two
// columns. No element of K is unpacked or multiplied by a CUDA core. A work
// item is (owned node, 32 output columns), one warp: it walks the node's
// incoming edges in slot order, rounds each message to bf16 on the
// accumulator registers (the XLA path's cast point), adds them in f32, adds
// the root product (the same mma against root, not rounded), scales, adds
// the bias, applies the ReLU and sends x' to all blocks: no message ever
// touches shared memory. The first edges of a warp's node stay in its
// registers across the layers, so about half of a block's K is read from
// shared memory once and never again. x is kept in bf16 (exact: x' is
// rounded to bf16 anyway) in an order in which the B registers of a lane
// and k-step are 8 consecutive bytes and an item's output 2 x 32; the last
// layer's output, which is not rounded, goes to an f32 buffer of its own.
// The layers have no cluster barrier between them: x' travels as counted
// stores (st.async) against an mbarrier per x buffer, and a warp starts a
// layer when its input buffer's bytes are all there (see run_mma).
//
// run_fma (f32, the parity configuration, and bf16 at other widths, 512
// threads): CUDA cores, and ONE cluster barrier a layer, split: arrive
// (release) after the stores of x', wait (acquire) before the next layer
// reads them; a writer of layer l + 1's output has passed barrier l, which a
// block joins only after its reads. A layer, every thread busy in each phase:
//   items    one warp an item, an item being a local edge (K_e) or an owned
//            node's root product (root): lanes split the item's w columns
//            into 16-byte groups and its w-deep sum into parts, and add the
//            parts by a butterfly of shuffles, an order fixed by the code.
//            A message is masked and rounded to CD; a root product is not.
//   combine  four lanes per owned node and 4 columns add the node's messages
//            (each every fourth, in slot order, then (0 + 1) + (2 + 3)),
//            x' = relu(agg * inv_deg + root product + bias), and write x'
//            (rounded to CD, the operand the next layer reads; unrounded
//            after the last layer) into the next x buffer of every block.
//
// The math follows the XLA path (models/gkn.py::gkn_apply_single): gathered
// rows, messages and the root product's operands are rounded to CD, every
// sum is f32 and taken in an order the edge list alone fixes (a node's sum,
// by its own slots: not by the deal). Padded slots
// (mask 0) add exactly zero to a finite sum and are skipped. Nothing depends
// on the number of streams in the launch.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace conv_stack {

namespace cg = cooperative_groups;

// The launch shape is one per body, fixed here.
constexpr int kThreads = 512;  // run_fma's block
constexpr int kMaxSmem = 227 * 1024;
constexpr int NCL = 8;  // blocks per stream (one cluster, a portable size)
// blocks per stream of conv_head's wide plan (a non-portable cluster size)
constexpr int kWideNCL = 16;
constexpr int kMsgRows = 48;  // messages a block of run_fma holds at a time
constexpr int kMmaW = 64;     // the width run_mma is written for
constexpr int kMmaRow = kMmaW * kMmaW * 2;  // bytes of one of its K rows
// run_mma's block and the edges a warp of it keeps in registers across the
// layers at NCL blocks (32 registers a thread each; twice as many, of 16
// each, in the wide plan).
constexpr int kMmaThreads = 256;
constexpr int kRegEdges = 4;

// With -DMDNO_CONV_PROFILE (tools/port_conv_stack_profile.py) thread 0 of block 0 leaves the SM clock at the
// marks below in conv_profile: 0 start, 1 degrees and x0, 2 nodes dealt,
// 3 edge lists, 4 cluster up, 5 K staged; then for layer l: 6 + 3 l
// messages formed, 7 + 3 l x' written (run_mma: the same moment, its items
// do both), 8 + 3 l barrier passed.
#ifdef MDNO_CONV_PROFILE
__device__ long long conv_profile[64];
#define MDNO_MARK(k) \
  if (blockIdx.x == 0 && threadIdx.x == 0 && (k) < 64) conv_profile[k] = clock64();
// and every warp of stream 0's blocks (ncl of them, at most kWideNCL) at
// moments of layer 3: 0 before the wait for x, 1 after it, 2 after the root
// product and the edges held in registers, 3 after the other edges, 5 x'
// sent (its first item), 6 through with the layer
__device__ long long conv_warp_profile[kWideNCL * 32 * 8];
#define MDNO_WARP_MARK(layer, k) \
  if ((layer) == 3 && (int)blockIdx.x < ncl && threadIdx.x % 32 == 0)    \
    conv_warp_profile[(blockIdx.x * 32 + threadIdx.x / 32) * 8 + (k)] = clock64();
#else
#define MDNO_MARK(k)
#define MDNO_WARP_MARK(layer, k)
#endif

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

// Sixteen bytes of CD values as floats: 4 of f32, 8 of bf16.
__device__ __forceinline__ void load16(const float* p, float* out) {
  load4(p, out);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// acc += x * (the eight bf16 of one 16-byte word), f32.
__device__ __forceinline__ void fma_row(const uint4& k, float x, float (&acc)[8]) {
  const unsigned w[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    acc[2 * c] = fmaf(x, __uint_as_float(w[c] << 16), acc[2 * c]);
    acc[2 * c + 1] = fmaf(x, __uint_as_float(w[c] & 0xffff0000u), acc[2 * c + 1]);
  }
}

__device__ __forceinline__ void fma_row(const uint4&, float, float (&)[4]) {}

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) / 16 * 16; }

// ---- the deal: which nodes and edges a block owns ---------------------------

// A block's share of the stream's graph, in its shared memory.
struct Lists {
  int* gdst;        // (E) target of a real slot, -1 of a padded one
  int* gsrc;        // (E) source of every slot
  float* gmsk;      // (E) mask of every slot
  int* lslot;       // (ne) this block's slots, grouped by node, in slot order
  int* lsrc;        // (ne) their source nodes
  float* lmsk;      // (ne) their mask values
  int* deg;         // (R) real in-degree of every node of the stream
  int* mynode;      // (nown) the nodes this block owns, ascending
  int* nstart;      // (nown + 1) where each owned node's edges start in lslot
  int* regoff;      // (nown + 1) register-held edges before each owned node
  int* lrow;        // (ne) the staged row of an edge's K, -1 if it has none
  int* pslot;       // (ne) the slots again, by place (see deal)
  int* counts;      // nown, ne, nreg
  float* own_invd;  // (nown) inv_deg of the owned nodes
  int nown, ne, nreg;
};

__host__ __device__ inline size_t lists_bytes(int R, int E) {
  return ((size_t)8 * E + 5 * R + 2 + 3) * 4;
}

// run_fma's chunks of a block's edge list (at most kMsgRows messages held at
// a time): where the chunk that starts at ``base`` ends. It ends at the last
// of the owned nodes' boundaries (``nstart``, ascending, nown + 1 of them)
// that it can hold, or after kMsgRows where one node alone has more. So a
// node's messages share a chunk, or its chunks start at its first edge and
// every kMsgRows after it: each per-node sum takes an order that the node's
// own edge slots fix, whatever other nodes the deal gives its block.
__device__ inline int chunk_end(const int* nstart, int nown, int base,
                                int ne) {
  const int lim = min(ne, base + kMsgRows);
  int end = lim;
  for (int k = nown; k >= 0; --k) {
    const int b = nstart[k];
    if (b <= base) break;
    if (b <= lim) {
      end = b;
      break;
    }
  }
  return end;
}

// Every thread of the block calls it; the lists are complete when it returns
// (it ends in a block barrier, which also covers what the caller wrote to
// shared memory before the call).
//
// Where an edge's K row lives: the first ``reg_edges`` edges of each of the
// block's first ``reg_nodes`` owned nodes are held in registers by the body
// (run_mma; run_fma holds none), nreg in all and at most ``cap``. Every edge
// has a place p: the register-held ones 0 .. nreg - 1 in list order, then
// the others in list order. Places below cap are staged in shared-memory row
// p at once; the register-held rows leave shared memory for the registers,
// and places cap .. cap + nreg - 1 then take their rows (p - cap); an edge
// beyond has no row and is read from L2 in every layer.
//
// The deal by in-degree (the note at the top) is each node's place found by
// a lane at once. It replaced a greedy deal, node after node in index order
// to the block of least in-degree-plus-one so far, which balanced a sum of
// work; but a block's warps run its nodes side by side, so what the deal
// must spread is the big nodes and the K rows a block stages. Measured on
// an H100 (bench shapes, us; greedy -> by in-degree): conv_head at 8
// streams 47.9 -> 39.5, fused_gkn at 8 104.6 -> 96.8, train_conv_fwd at 32
// examples 131.4 -> 120.6 (f32 254.0 -> 241.0), train_conv_bwd 202.8 ->
// 185.5 (f32 2,535 -> 2,238). It moves no bit of a forward sum (a node's
// sum stays in its owner; run_fma's chunks, chunk_end); it does move the
// training backward's droot, whose blocks' partials are added in rank
// order.
__device__ inline Lists deal(unsigned char* at, const int* __restrict__ src_g,
                             const int* __restrict__ dst_g,
                             const float* __restrict__ mask_g,
                             const float* __restrict__ inv_deg_s, int R, int E,
                             int rank, int ncl, int cap, int reg_nodes,
                             int reg_edges) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, wid = tid / 32, nw = nt / 32;
  Lists L;
  L.gdst = reinterpret_cast<int*>(at);
  L.gsrc = L.gdst + E;
  L.gmsk = reinterpret_cast<float*>(L.gsrc + E);
  L.lslot = reinterpret_cast<int*>(L.gmsk + E);
  L.lsrc = L.lslot + E;
  L.lmsk = reinterpret_cast<float*>(L.lsrc + E);
  L.deg = reinterpret_cast<int*>(L.lmsk + E);
  L.mynode = L.deg + R;
  L.nstart = L.mynode + R;
  L.regoff = L.nstart + R + 1;
  L.lrow = L.regoff + R + 1;
  L.pslot = L.lrow + E;
  L.counts = L.pslot + E;
  L.own_invd = reinterpret_cast<float*>(L.counts + 3);

  for (int i = tid; i < R; i += nt) L.deg[i] = 0;
  for (int e = tid; e < E; e += nt) {
    // the three reads at once, not one after the other
    const int d = dst_g[e], sr = src_g[e];
    const float mk = mask_g[e];
    L.gdst[e] = mk > 0.f ? d : -1;
    L.gsrc[e] = sr;
    L.gmsk[e] = mk;
  }
  __syncthreads();
  for (int e = tid; e < E; e += nt)
    if (L.gdst[e] >= 0) atomicAdd(&L.deg[L.gdst[e]], 1);
  __syncthreads();
  MDNO_MARK(1)
  if (wid == 0) {
    int nown = 0, ne = 0, nreg = 0;
    // One warp deals. A node's place is its rank by in-degree
    // (descending, then index), dealt back and forth over the blocks (0 ..
    // ncl - 1, then ncl - 1 .. 0, ...); each lane finds one node's. The
    // lists keep the nodes ascending, and nreg = min(the register-held
    // so far, cap).
    const unsigned below = (1u << lane) - 1u;
    int regsum = 0;
    for (int j0 = 0; j0 < R; j0 += 32) {
      const int j = j0 + lane;
      int d = 0;
      bool own = false;
      if (j < R) {
        d = L.deg[j];
        int pos = 0;
#pragma unroll 4
        for (int i = 0; i < R; ++i) {
          const int di = L.deg[i];
          pos += di > d || (di == d && i < j);
        }
        const int k = pos % ncl;
        own = ((pos / ncl) & 1 ? ncl - 1 - k : k) == rank;
      }
      const unsigned bits = __ballot_sync(0xffffffffu, own);
      const int idx = nown + __popc(bits & below);
      const int r = own && idx < reg_nodes ? min(reg_edges, d) : 0;
      // inclusive sums over the owned nodes of this chunk, in order
      int dsum = own ? d : 0, rsum = r;
      for (int off = 1; off < 32; off <<= 1) {
        const int dv = __shfl_up_sync(0xffffffffu, dsum, off);
        const int rv = __shfl_up_sync(0xffffffffu, rsum, off);
        if (lane >= off) {
          dsum += dv;
          rsum += rv;
        }
      }
      if (own) {
        L.mynode[idx] = j;
        L.nstart[idx] = ne + dsum - d;
        L.regoff[idx] = min(regsum + rsum - r, cap);
      }
      nown += __popc(bits);
      ne += __shfl_sync(0xffffffffu, dsum, 31);
      regsum += __shfl_sync(0xffffffffu, rsum, 31);
    }
    nreg = min(regsum, cap);
    if (lane == 0) {
      L.nstart[nown] = ne;
      L.regoff[nown] = nreg;
      L.counts[0] = nown;
      L.counts[1] = ne;
      L.counts[2] = nreg;
    }
  }
  __syncthreads();
  MDNO_MARK(2)
  L.nown = L.counts[0];
  L.ne = L.counts[1];
  L.nreg = L.counts[2];
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int n = tid; n < L.nown; n += nt) L.own_invd[n] = inv_deg_s[L.mynode[n]];
  for (int n = wid; n < L.nown; n += nw) {
    const int j = L.mynode[n];
    const int first = L.nstart[n], regs_before = L.regoff[n];
    const int c = L.regoff[n + 1] - regs_before;  // this node's register-held
    int pos = first;
    for (int e0 = 0; e0 < E; e0 += 32) {
      const int e = e0 + lane;
      const bool hit = e < E && L.gdst[e] == j;
      const unsigned bits = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        const int i = pos + __popc(bits & lanes_below);
        const int li = i - first;
        const int p = li < c ? regs_before + li : L.nreg + i - regs_before - c;
        L.lslot[i] = e;
        L.lsrc[i] = L.gsrc[e];
        L.lmsk[i] = L.gmsk[e];
        L.pslot[p] = e;
        L.lrow[i] = p < cap ? p : p < cap + L.nreg ? p - cap : -1;
      }
      pos += __popc(bits);
    }
  }
  __syncthreads();
  MDNO_MARK(3)
  return L;
}

// ---- shared memory ------------------------------------------------------------

// Byte offsets of a block's dynamic shared memory, the same on the host
// (sizes) and the device (pointers). run_mma uses ks, root, xa, xb (bf16),
// xout, bias, bar (two barriers), meta and the lists; run_fma all but xout
// and meta.
struct Layout {
  size_t ks, root, xa, xb, xout, msl, aggs, rxs, bias, bar, meta, ints, total;
};

__host__ __device__ inline bool takes_mma(int W, int cd_size) {
  return cd_size == 2 && W == kMmaW;
}

__host__ __device__ inline Layout layout(int R, int W, int E, int cd_size,
                                         int cap) {
  Layout l;
  const bool mma = takes_mma(W, cd_size);
  const size_t x_bytes = (size_t)R * W * (mma ? 2 : 4);
  l.ks = 0;
  l.root = up16((size_t)cap * W * W * cd_size);
  l.xa = l.root + up16((size_t)W * W * cd_size);
  l.xb = l.xa + up16(x_bytes);
  l.xout = l.xb + up16(x_bytes);
  l.msl = l.xout + (mma ? up16((size_t)R * W * 4) : 0);
  l.aggs = l.msl + (mma ? 0 : up16((size_t)kMsgRows * W * cd_size));
  l.rxs = l.aggs + (mma ? 0 : up16((size_t)R * W * 4));
  l.bias = l.rxs + (mma ? 0 : up16((size_t)R * W * 4));
  l.bar = l.bias + up16((size_t)2 * W * 4);
  l.meta = l.bar + 16;
  l.ints = l.meta + (mma ? (size_t)E * 16 : 0);
  l.total = l.ints + lists_bytes(R, E);
  return l;
}

// ---- run_mma ----------------------------------------------------------------------

// Where column m of a node's features lies in its 64-value bf16 row: the
// mma's B fragment of k-step ks gives lane t (of four) the values
// 16 ks + 2 t + {0, 1} and 16 ks + 8 + 2 t + {0, 1}; in this order they are
// the 8 consecutive bytes at 32 ks + 8 t, and the 16 columns an item
// produces stay 32 consecutive bytes.
__device__ __forceinline__ int xpos(int m) {
  return (m & ~15) + ((m & 7) >> 1) * 4 + ((m >> 3) & 1) * 2 + (m & 1);
}

// Two floats rounded to bf16, ``lo`` in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Byte offset of 16-byte chunk c of row k in a swizzled (64, 64) bf16 matrix.
__device__ __forceinline__ unsigned swizzled(int k, int c) {
  return (unsigned)(k * 128 + ((c ^ (k & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 bf16 matrices, each transposed on the way: with the addresses
// run_mma gives it, the A fragment (16 output columns x 16 of the sum).
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&a)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Eight bytes at a shared address. Explicit, because the x buffer of a layer
// is chosen at run time and the compiler would fall back to generic loads.
__device__ __forceinline__ uint2 lds64(unsigned addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr));
  return v;
}

// d += A (16x16, row) * B (16x8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[m][0] + d[m][1] = the bf16 row whose B registers start at the shared
// address ``xp`` (its 32 ks + 8 t bytes, see xpos) times the (64, 64) matrix
// whose fragments are a[m]: [0] sums the first 32 products and [1] the last
// 32, so 2 M chains run side by side. Lane (g, t) ends with row 16 m + g of
// the matrix's tile m in [..][0] (and [1]) and 16 m + 8 + g in [..][2] (and
// [3]). A tile's chains are the same whatever M is: so are its bits.
template <int M>
__device__ __forceinline__ void mma_row(float (&d)[M][2][4],
                                        const unsigned (&a)[M][4][4],
                                        unsigned xp) {
  const uint2 b0 = lds64(xp), b1 = lds64(xp + 32), b2 = lds64(xp + 64),
              b3 = lds64(xp + 96);
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mma_16816(d[m][0], a[m][0], b0.x, b0.y);
    mma_16816(d[m][1], a[m][2], b2.x, b2.y);
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mma_16816(d[m][0], a[m][1], b1.x, b1.y);
    mma_16816(d[m][1], a[m][3], b3.x, b3.y);
  }
}

// The K rows of places p0 .. p1 - 1 of stream s (slot pslot[p]) into the
// swizzled shared rows p0 - row0 .. from the shared address ``ks``, by
// cp.async; every thread of the block calls it.
__device__ __forceinline__ void stage_rows(unsigned ks, const unsigned char* Kb,
                                           int s, int E, const int* pslot,
                                           int p0, int p1, int row0) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int idx = tid + p0 * 512; idx < p1 * 512; idx += nt) {
    const int p = idx >> 9, ch = idx & 511;
    cp_async16(ks + (p - row0) * kMmaRow + swizzled(ch >> 3, ch & 7),
               Kb + ((size_t)s * E + pslot[p]) * kMmaRow + ch * 16);
  }
}

// A (64, 64) bf16 matrix into the swizzled shared matrix at ``dst``, by
// cp.async; every thread of the block calls it.
__device__ __forceinline__ void stage_matrix(unsigned dst, const void* src) {
  for (int ch = threadIdx.x; ch < 512; ch += blockDim.x)
    cp_async16(dst + swizzled(ch >> 3, ch & 7),
               reinterpret_cast<const uint4*>(src) + ch);
}

// This lane's ldmatrix.trans row inside a swizzled (64, 64) matrix for the
// A fragment of the stored columns 16 mt .. 16 mt + 15 (A's rows) at
// k-step 0 (the stored rows 0 .. 15); k-step ks lies 2048 ks further.
__device__ __forceinline__ unsigned frag_cols(int lane, int mt) {
  const int lq = lane >> 3, lr = lane & 7;
  return swizzled((lq >> 1) * 8 + lr, mt * 2 + (lq & 1));
}

// An item's output of one 16-column tile, o0 (row 16 m + g) and o1 (+ 8)
// on lane (g, t), rounded to bf16: the tile is 32 consecutive bytes of its
// row (xpos); three shuffles bring every lane the 16-byte half that its
// 8-lane group g / 4 stands for.
__device__ __forceinline__ uint4 tile_half(float o0, float o1, int g) {
  const unsigned own = pack_bf16(o0, o1);
  const unsigned other = __shfl_xor_sync(0xffffffffu, own, 4);
  const unsigned even = g & 1 ? other : own, odd = g & 1 ? own : other;
  const unsigned w0 = __byte_perm(even, odd, 0x5410);  // columns g, g + 1
  const unsigned w1 = __byte_perm(even, odd, 0x7632);  // and 8 further
  const unsigned v0 = __shfl_xor_sync(0xffffffffu, w0, 8);
  const unsigned v1 = __shfl_xor_sync(0xffffffffu, w1, 8);
  return g & 2 ? make_uint4(v0, v1, w0, w1) : make_uint4(w0, w1, v0, v1);
}

// Sixteen bytes into another block's shared memory, counted on that block's
// mbarrier ``bar`` (both shared::cluster addresses): whoever sees the
// barrier's phase complete sees the bytes.
__device__ __forceinline__ void store_counted16(unsigned dst, const uint4& v,
                                                unsigned bar) {
  asm volatile(
      "st.async.weak.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// The body for bf16 at width 64 (kMmaThreads threads a block) on clusters
// of NB blocks. Same contract as run().
//
// At NB = NCL a work item is (owned node, 32 output columns), one warp: two
// of the mma's 16-column tiles share one load of x_src. The first kRegEdges
// edges of the node of a warp's first item stay in its registers across
// the layers (32 registers a thread each), so half of a block's K is never
// read again; the rest and root come from shared memory by ldmatrix.
//
// At NB = kWideNCL (conv_head's wide plan) each block holds half as many
// nodes and K rows, and an item is (owned node, 16 output columns): four
// warps a node, each keeping 2 kRegEdges edges in registers at 16 registers
// an edge, so the largest node's tail from shared memory is about half as
// many reads of half the bytes. A 16-column product is two mma chains, half
// what the narrow plan keeps in flight, so the wide items form two messages
// before adding either (the held pairs with no branch, an edge a warp does
// not hold adding +0). At NB = NCL, whose products are four chains already,
// that was slower on an H100 (train_conv_fwd at 32 examples 131.4 -> 134.1
// us, conv_head at one stream 40.7 -> 40.9; with the deal by in-degree
// 120.6 -> 122.5, and conv_head at 8 streams 39.5 -> 40.9), so it runs at
// NB = kWideNCL only. Every output is the same sum in the same order at both sizes (a
// tile's mma chains do not depend on its neighbour, and messages are added
// in slot order), so the two plans give the same bits.
//
// Warps poll for x (mbar_wait_spin) rather than sleep in try_wait: at 16
// blocks 0.75 us faster a call; at 8 the same within the runs' noise on an
// H100 (polling against sleeping, us: conv_head 39.5 and 39.5 at one
// stream, 40.5 and 40.6 at 8, fused_gkn at 8 97.7 and 97.6,
// train_conv_fwd 120.6 and 121.3).
//
// Between the layers there is no cluster barrier: x' travels as counted
// stores (st.async) and each block's two x buffers have an mbarrier each,
// armed with the bytes of one full x (R rows from all blocks, its own
// included). A warp waits for its input buffer's phase, runs its items and
// sends. A block's buffer b is written again two layers on, by senders that
// have by then received every item's output of the layer between, and an
// item sends only after its reads: nothing is overwritten while it is read.
// Only the last layer, whose output is f32 and read by the caller, ends in
// plain remote stores and the cluster barrier.
template <int NB = NCL>
__device__ inline float* run_mma(
    unsigned char* smem_raw, const float* __restrict__ x0,
    const __nv_bfloat16* __restrict__ K, const int* __restrict__ edges,
    const float* __restrict__ mask, const float* __restrict__ inv_deg,
    const __nv_bfloat16* __restrict__ root1, const float* __restrict__ bias1,
    const __nv_bfloat16* __restrict__ root2, const float* __restrict__ bias2,
    int R, int E, int depth, int cap, float* __restrict__ stack) {
  static_assert(NB == NCL || NB == kWideNCL, "a cluster of 8 or 16 blocks");
  using bf16 = __nv_bfloat16;
  constexpr int W = kMmaW;
  constexpr int TI = NB == NCL ? 2 : 1;       // 16-column tiles an item
  constexpr int IPN = 4 / TI;                 // items a node
  constexpr int IPN_LOG = IPN == 2 ? 1 : 2;
  constexpr int RE = kRegEdges * 2 / TI;      // edges a warp holds
  static_assert(TI == 2 || RE % 2 == 0, "held edges go in pairs at TI = 1");
  MDNO_MARK(0)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int s = blockIdx.x / ncl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, wid = tid / 32, nw = nt / 32;
  const int g = lane >> 2, t = lane & 3;  // the mma's row group and lane of four
  const int nlayers = 2 * depth;

  const Layout l = layout(R, W, E, 2, cap);
  unsigned char* ks = smem_raw + l.ks;
  unsigned char* root_s = smem_raw + l.root;
  bf16* xbuf[2] = {reinterpret_cast<bf16*>(smem_raw + l.xa),
                   reinterpret_cast<bf16*>(smem_raw + l.xb)};
  float* xout = reinterpret_cast<float*>(smem_raw + l.xout);
  float* bias_s = reinterpret_cast<float*>(smem_raw + l.bias);
  unsigned long long* xbar = reinterpret_cast<unsigned long long*>(smem_raw + l.bar);
  int4* meta = reinterpret_cast<int4*>(smem_raw + l.meta);
  const unsigned x_bytes = (unsigned)(R * W * 2);

  // ---- prologue: x0, the deal, this block's K rows, root ----------------------
  if (tid == 0) {
    // layer l < nlayers - 1 fills buffer (l + 1) % 2: the first phase of
    // each barrier is armed here, the later ones by whoever waited last
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    mbar_init_fence();
    if (nlayers >= 2) mbar_arrive_expect_tx(&xbar[1], x_bytes);
    if (nlayers >= 3) mbar_arrive_expect_tx(&xbar[0], x_bytes);
  }
  cluster_arrive();  // every block's barriers are up before a remote store
  stage_matrix(smem_u32(root_s), root1);
  const int* src_g = edges + (size_t)s * 2 * E;
  const Lists L = deal(smem_raw + l.ints, src_g, src_g + E,
                           mask + (size_t)s * E, inv_deg + (size_t)s * R, R,
                           E, rank, ncl, cap, nw / IPN, RE);
  const int nown = L.nown, ne = L.ne;
  const unsigned char* Kb = reinterpret_cast<const unsigned char*>(K);
  stage_rows(smem_u32(ks), Kb, s, E, L.pslot, 0, min(ne, cap), 0);
  // with the rows on their way, what is off the critical path:
  // a thread's reads of x0 four at a time before their writes: few trips
  for (int base = tid; base < R * W; base += 4 * nt) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + q * nt;
      v[q] = i < R * W ? x0[(size_t)s * R * W + i] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = base + q * nt;
      if (i < R * W) {
        xbuf[0][(i / W) * W + xpos(i % W)] = __float2bfloat16_rn(v[q]);
        xout[i] = v[q];  // what a stack of no layers returns
      }
    }
  }
  for (int i = tid; i < 2 * W; i += nt)
    bias_s[i] = i < W ? bias1[i] : bias2[i - W];
  // what an item reads of edge i, one 16-byte load: the byte offset of its
  // staged row (-1: none), of its source's x row, its mask and its slot
  for (int i = tid; i < ne; i += nt)
    meta[i] = make_int4(L.lrow[i] < 0 ? -1 : L.lrow[i] * kMmaRow,
                        L.lsrc[i] * W * 2, __float_as_int(L.lmsk[i]), L.lslot[i]);
  cluster_wait();
  MDNO_MARK(4)
  cp_async_wait_all();
  __syncthreads();
  MDNO_MARK(5)

  // This lane's byte offset inside a swizzled matrix for the fragment of
  // output columns 16 mt .. 16 mt + 15 at k-step 0; k-step ks lies 2048 ks
  // further.
  auto frag_off = [&](int mt) { return frag_cols(lane, mt); };
  // d[m][0] + d[m][1] = x (the row at byte offset ``xoff`` of buffer xc) @ a
  // (64, 64) matrix, columns 16 (TI q + m) .., whose fragments are a[m]
  // (mma_row: lane (g, t) ends with column 16 mt + g and 16 mt + 8 + g)
  auto product = [&](float (&d)[TI][2][4], const unsigned (&a)[TI][4][4],
                     unsigned xc, int xoff) { mma_row(d, a, xc + xoff + t * 8); };
  // the same with the fragments of the item's tiles at shared addresses
  // at0 (and at1)
  auto product_staged = [&](float (&d)[TI][2][4], unsigned at0, unsigned at1,
                            unsigned xc, int xoff) {
    unsigned a[TI][4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      ldmatrix_x4_trans(a[0][kk], at0 + kk * 2048);
      if constexpr (TI == 2) ldmatrix_x4_trans(a[1][kk], at1 + kk * 2048);
    }
    product(d, a, xc, xoff);
  };
  // the same from a K row in global memory (an edge without a staged row)
  auto product_global = [&](float (&d)[TI][2][4], const unsigned short* kg,
                            int q, unsigned xc, int xoff) {
    unsigned a[TI][4][4];
#pragma unroll
    for (int m = 0; m < TI; ++m)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned short* p =
            kg + (kk * 16 + 2 * t) * W + (TI * q + m) * 16 + g;
        a[m][kk][0] = (unsigned)p[0] | (unsigned)p[W] << 16;
        a[m][kk][1] = (unsigned)p[8] | (unsigned)p[W + 8] << 16;
        a[m][kk][2] = (unsigned)p[8 * W] | (unsigned)p[9 * W] << 16;
        a[m][kk][3] = (unsigned)p[8 * W + 8] | (unsigned)p[9 * W + 8] << 16;
      }
    product(d, a, xc, xoff);
  };

  // An item: node n (j of the stream), its edges first .. past - 1 of which
  // those below staged_end have a row, its tiles' fragment offsets (off1
  // unused at TI = 1).
  struct Item {
    int j, first, past, staged_end;
    float invd;
    unsigned off0, off1;
  };
  auto item_of = [&](int u, int nheld) {
    const int n = u >> IPN_LOG, q = u & (IPN - 1);
    Item it;
    it.j = L.mynode[n];
    it.first = L.nstart[n] + nheld;
    it.past = L.nstart[n + 1];
    it.staged_end = max(it.first, min(it.past, cap + L.regoff[n + 1]));
    it.invd = L.own_invd[n];
    it.off0 = frag_off(TI * q);
    it.off1 = frag_off(TI * q + 1);
    return it;
  };
  const bool works = wid < IPN * nown;  // this warp has items
  // its first item keeps the fragments of its node's first edges in
  // registers; their rows then go to the edges that had none
  unsigned held[RE][TI][4][4];
  int nheld = 0;
  Item mine = {};
  if (works) {
    const int n = wid >> IPN_LOG;
    nheld = L.regoff[n + 1] - L.regoff[n];
    mine = item_of(wid, nheld);
#pragma unroll
    for (int e = 0; e < RE; ++e) {
      const unsigned at =
          smem_u32(ks) + (e < nheld ? L.regoff[n] + e : 0) * kMmaRow;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldmatrix_x4_trans(held[e][0][kk], at + mine.off0 + kk * 2048);
        if constexpr (TI == 2)
          ldmatrix_x4_trans(held[e][1][kk], at + mine.off1 + kk * 2048);
      }
    }
  }
  if (ne > cap) {
    __syncthreads();
    stage_rows(smem_u32(ks), Kb, s, E, L.pslot, cap, min(ne, cap + L.nreg), cap);
    cp_async_wait_all();
    __syncthreads();
  }

  // where this lane sends its 16 bytes of a tile's output: block
  // 4 (g % 4) + t, the x buffers and their barriers there
  const int to_rank = (g & 3) * 4 + t;
  const bool sends = to_rank < ncl;
  unsigned to_x[2], to_bar[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    to_x[b] = map_to_block(smem_u32(xbuf[b]), sends ? to_rank : rank);
    to_bar[b] = map_to_block(smem_u32(&xbar[b]), sends ? to_rank : rank);
  }

  for (int layer = 0; layer < nlayers; ++layer) {
    const float* bias = layer < depth ? bias_s : bias_s + W;
    const bool last = layer == nlayers - 1;
    if (layer == depth) {  // the only block barriers of the layers
      __syncthreads();     // every reader of root1 is through
      stage_matrix(smem_u32(root_s), root2);
      cp_async_wait_all();
      __syncthreads();
    }
    MDNO_WARP_MARK(layer, 0)
    if (layer > 0 && (works || wid == 0)) {
      mbar_wait_spin(&xbar[layer & 1], ((layer - 1) >> 1) & 1);
      // this buffer is filled again by layer + 1, unless that is the last
      if (tid == 0 && layer + 2 < nlayers)
        mbar_arrive_expect_tx(&xbar[layer & 1], x_bytes);
      MDNO_MARK(8 + 3 * (layer - 1))
    }
    MDNO_WARP_MARK(layer, 1)
    // the shared address of this layer's input buffer
    const unsigned xc = smem_u32(smem_raw) + (unsigned)(layer & 1 ? l.xb : l.xa);
    for (int u = wid; u < IPN * nown; u += nw) {
      const bool first_item = u == wid;
      const Item it = first_item ? mine : item_of(u, 0);
      const int q = u & (IPN - 1);
      float bs[TI][2];
#pragma unroll
      for (int m = 0; m < TI; ++m) {
        bs[m][0] = bias[(TI * q + m) * 16 + g];
        bs[m][1] = bias[(TI * q + m) * 16 + g + 8];
      }
      // the root product first: it waits for nothing but x
      float dr[TI][2][4] = {};
      product_staged(dr, smem_u32(root_s) + it.off0, smem_u32(root_s) + it.off1,
                     xc, it.j * W * 2);
      float agg[TI][2] = {};
      // a message: the two half sums added, masked, rounded to bf16 (both
      // columns of a tile by one conversion)
      auto add = [&](const float (&d)[TI][2][4], int mk) {
#pragma unroll
        for (int m = 0; m < TI; ++m) {
          const unsigned p = pack_bf16((d[m][0][0] + d[m][1][0]) * __int_as_float(mk),
                                       (d[m][0][2] + d[m][1][2]) * __int_as_float(mk));
          agg[m][0] += __uint_as_float(p << 16);
          agg[m][1] += __uint_as_float(p & 0xffff0000u);
        }
      };
      // the same, or +0 where ``keep`` is false: agg starts at +0 and so is
      // never -0, and adding +0 leaves it as it is (a select, no branch)
      auto add_if = [&](const float (&d)[TI][2][4], int mk, bool keep) {
#pragma unroll
        for (int m = 0; m < TI; ++m) {
          const unsigned p =
              keep ? pack_bf16((d[m][0][0] + d[m][1][0]) * __int_as_float(mk),
                               (d[m][0][2] + d[m][1][2]) * __int_as_float(mk))
                   : 0u;
          agg[m][0] += __uint_as_float(p << 16);
          agg[m][1] += __uint_as_float(p & 0xffff0000u);
        }
      };
      // The node's edges in slot order: those held in registers, those with
      // a staged row, those read from L2. Rows are given in list order, so
      // each kind is a run. At TI = 1 two edges are formed before either
      // message is added, in slot order (see the note above run_mma).
      if (first_item && nheld > 0) {
        if constexpr (TI == 1) {
          const int held0 = it.first - nheld;
#pragma unroll
          for (int e = 0; e < RE; e += 2) {
            // an edge this warp does not hold repeats the first and adds +0:
            // no branch, so the products of later pairs can start early
            const int4 m0 = meta[held0 + (e < nheld ? e : 0)];
            const int4 m1 = meta[held0 + (e + 1 < nheld ? e + 1 : 0)];
            float d0[TI][2][4] = {}, d1[TI][2][4] = {};
            product(d0, held[e], xc, m0.y);
            product(d1, held[e + 1], xc, m1.y);
            add_if(d0, m0.z, e < nheld);
            add_if(d1, m1.z, e + 1 < nheld);
          }
        } else {
#pragma unroll
          for (int e = 0; e < RE; ++e) {
            // an edge this warp does not hold repeats the first and is
            // dropped
            const int4 me = meta[it.first - nheld + (e < nheld ? e : 0)];
            float d[TI][2][4] = {};
            product(d, held[e], xc, me.y);
            if (e < nheld) add(d, me.z);
          }
        }
      }
      MDNO_WARP_MARK(layer, 2)
      int i = it.first;
      if constexpr (TI == 1) {
        for (; i + 1 < it.staged_end; i += 2) {
          const int4 m0 = meta[i], m1 = meta[i + 1];
          float d0[TI][2][4] = {}, d1[TI][2][4] = {};
          product_staged(d0, smem_u32(ks) + m0.x + it.off0, 0, xc, m0.y);
          product_staged(d1, smem_u32(ks) + m1.x + it.off0, 0, xc, m1.y);
          add(d0, m0.z);
          add(d1, m1.z);
        }
      }
      for (; i < it.staged_end; ++i) {
        const int4 me = meta[i];
        float d[TI][2][4] = {};
        product_staged(d, smem_u32(ks) + me.x + it.off0,
                       smem_u32(ks) + me.x + it.off1, xc, me.y);
        add(d, me.z);
      }
      for (; i < it.past; ++i) {
        float d[TI][2][4] = {};
        const int4 me = meta[i];
        product_global(d,
                       reinterpret_cast<const unsigned short*>(K) +
                           ((size_t)s * E + me.w) * (W * W),
                       q, xc, me.y);
        add(d, me.z);
      }
      MDNO_WARP_MARK(layer, 3)
#pragma unroll
      for (int m = 0; m < TI; ++m) {
        // x' = relu(agg * inv_deg + cd(x) @ cd(root) + bias)
        const int mt = TI * q + m, col = mt * 16 + g;
        const float z0 = __fadd_rn(
            __fadd_rn(__fmul_rn(agg[m][0], it.invd), dr[m][0][0] + dr[m][1][0]),
            bs[m][0]);
        const float z1 = __fadd_rn(
            __fadd_rn(__fmul_rn(agg[m][1], it.invd), dr[m][0][2] + dr[m][1][2]),
            bs[m][1]);
        const float o0 = relu_nan(z0), o1 = relu_nan(z1);
        if (stack != nullptr && t == 0) {
          // x' before its rounding; the four lanes of a row group hold the
          // same values
          float* row = stack + (((size_t)s * (nlayers + 1) + layer + 1) * R +
                                it.j) * W;
          row[col] = o0;
          row[col + 8] = o1;
        }
        if (last) {
          // the four lanes of a row group hold the same two values: each
          // stores them into its share of the cluster's blocks
          for (int r = t; r < ncl; r += 4) {
            float* to = cluster.map_shared_rank(xout, r) + it.j * W + col;
            to[0] = o0;
            to[8] = o1;
          }
        } else {
          // lane (g % 4, t) sends the 16-byte half of the tile its 8-lane
          // group g / 4 stands for
          const uint4 half = tile_half(o0, o1, g);
          if (sends)
            store_counted16(to_x[(layer + 1) & 1] +
                                (it.j * W + mt * 16 + (g >> 2) * 8) * 2,
                            half, to_bar[(layer + 1) & 1]);
        }
      }
      MDNO_WARP_MARK(layer, 5)
    }
    MDNO_WARP_MARK(layer, 6)
    MDNO_MARK(6 + 3 * layer)
    MDNO_MARK(7 + 3 * layer)
  }
  if (nlayers > 0) {
    cluster_arrive();
    cluster_wait();  // the last x' is complete everywhere
    MDNO_MARK(8 + 3 * (nlayers - 1))
  }
  return xout;
}

// ---- run_fma ----------------------------------------------------------------------

// The body on CUDA cores, any CD and width. Same contract as run().
template <typename CD>
__device__ float* run_fma(
    unsigned char* smem_raw, const float* __restrict__ x0,
    const CD* __restrict__ K, const int* __restrict__ edges,
    const float* __restrict__ mask, const float* __restrict__ inv_deg,
    const CD* __restrict__ root1, const float* __restrict__ bias1,
    const CD* __restrict__ root2, const float* __restrict__ bias2,
    int R, int W, int E, int depth, int cap, float* __restrict__ stack) {
  constexpr int CPL = 16 / sizeof(CD);  // columns a lane owns in an item
  MDNO_MARK(0)
  cluster_arrive();  // every block of the cluster runs before a remote store
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const int s = blockIdx.x / ncl;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid % 32, wid = tid / 32, nw = nt / 32;
  const int RW = R * W, WW = W * W;

  const Layout l = layout(R, W, E, sizeof(CD), cap);
  CD* ks = reinterpret_cast<CD*>(smem_raw + l.ks);
  CD* root_s = reinterpret_cast<CD*>(smem_raw + l.root);
  float* xa = reinterpret_cast<float*>(smem_raw + l.xa);
  float* xb = reinterpret_cast<float*>(smem_raw + l.xb);
  CD* msl = reinterpret_cast<CD*>(smem_raw + l.msl);
  float* aggs = reinterpret_cast<float*>(smem_raw + l.aggs);
  float* rxs = reinterpret_cast<float*>(smem_raw + l.rxs);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw + l.bar);
  float* bias_s = reinterpret_cast<float*>(smem_raw + l.bias);

  // ---- prologue: x0, the deal, this block's K rows ----------------------------
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  for (int i = tid; i < RW; i += nt) {
    const float v = x0[(size_t)s * RW + i];
    xa[i] = depth > 0 ? round_cd<CD>(v) : v;
  }
  for (int i = tid; i < 2 * W; i += nt)
    bias_s[i] = i < W ? bias1[i] : bias2[i - W];
  const int* src_g = edges + (size_t)s * 2 * E;
  const Lists L = deal(smem_raw + l.ints, src_g, src_g + E, mask + (size_t)s * E,
                       inv_deg + (size_t)s * R, R, E, rank, ncl, cap, 0, 0);
  const int nown = L.nown, ne = L.ne;
  const int* lslot = L.lslot;
  const int* lsrc = L.lsrc;
  const float* lmsk = L.lmsk;
  const int* mynode = L.mynode;
  const int* nstart = L.nstart;
  const float* own_invd = L.own_invd;
  const int nst = min(ne, cap);  // edges whose K row is staged

  // ---- lanes of an item -------------------------------------------------------
  const int groups = W / CPL;  // 16-byte column groups, at most 32
  const int splits = (groups & (groups - 1)) == 0 ? 32 / groups : 1;
  const int g = lane % groups, sp = lane / groups;
  const int nwi = (W + splits - 1) / splits;
  const int wi0 = min(W, sp * nwi);
  const int wi1 = sp < splits ? min(W, wi0 + nwi) : wi0;
  const bool writer = sp == 0 && lane < groups;

  // one bulk copy a row by the copy engine, counted on the mbarrier
  if (tid == 0 && nst > 0) {
    const unsigned row_bytes = (unsigned)(WW * sizeof(CD));
    mbar_arrive_expect_tx(bar, nst * row_bytes);
    for (int i = 0; i < nst; ++i)
      bulk_copy_g2s(ks + (size_t)i * WW,
                    K + ((size_t)s * E + lslot[i]) * WW, row_bytes, bar);
  }
  cluster_wait();
  MDNO_MARK(4)
  if (nst > 0) mbar_wait(bar, 0);
  MDNO_MARK(5)

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
    sl.first = nstart[sl.n];
    sl.past = nstart[sl.n + 1];
    sl.j = mynode[sl.n];
    sl.invd = own_invd[sl.n];
    return sl;
  };
  const Slot mine = slot_of(tid);

  float* xc = xa;
  float* xn = xb;

  for (int layer = 0; layer < 2 * depth; ++layer) {
    const float* bias = layer < depth ? bias_s : bias_s + W;
    const bool last = layer == 2 * depth - 1;
    if (layer == 0 || layer == depth) {
      const uint4* from = reinterpret_cast<const uint4*>(layer < depth ? root1 : root2);
      uint4* to = reinterpret_cast<uint4*>(root_s);
      for (int i = tid; i < WW / CPL; i += nt) to[i] = from[i];
      __syncthreads();
    }

    // the block's edges in chunks (chunk_end; one at the bench shapes): the
    // first pass runs even without edges, for the root products
    for (int base = 0, nchunk = -1; nchunk < 0 || base < ne; base += nchunk) {
      nchunk = chunk_end(nstart, nown, base, ne) - base;
      const int nitems = nchunk + (base == 0 ? nown : 0);
      // the parts of an item's sum, added across its lanes, and the result
      // stored: a message masked and rounded to CD, a root product as it is
      auto finish = [&](float (&acc)[CPL], int it, bool is_edge, int i, int n) {
        if (CPL == 8 && splits == 4) {
          // pairwise, (0 + 1) + (2 + 3), while the lanes of a column group
          // share out its columns: a lane ends with two, 6 shuffles in all
          const bool up1 = lane & groups, up2 = lane & (2 * groups);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float got = __shfl_xor_sync(
                0xffffffffu, up1 ? acc[c] : acc[c + 4], groups);
            acc[c] = (up1 ? acc[c + 4] : acc[c]) + got;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float got = __shfl_xor_sync(
                0xffffffffu, up2 ? acc[c] : acc[c + 2], 2 * groups);
            acc[c] = (up2 ? acc[c + 2] : acc[c]) + got;
          }
          const int col = g * CPL + (up1 ? 4 : 0) + (up2 ? 2 : 0);
          if (is_edge) {
            const float mk = lmsk[i];
            msl[it * W + col] = from_f32<CD>(acc[0] * mk);
            msl[it * W + col + 1] = from_f32<CD>(acc[1] * mk);
          } else {
            rxs[n * W + col] = acc[0];
            rxs[n * W + col + 1] = acc[1];
          }
          return;
        }
        for (int off = groups; off < groups * splits; off <<= 1)
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
        if (writer) {
          if (is_edge) {
            const float mk = lmsk[i];
#pragma unroll
            for (int c = 0; c < CPL; ++c)
              msl[it * W + g * CPL + c] = from_f32<CD>(acc[c] * mk);
          } else {
#pragma unroll
            for (int c = 0; c < CPL; ++c) rxs[n * W + g * CPL + c] = acc[c];
          }
        }
      };

      // last items first: the root products and the edges read from L2,
      // whose latency the staged items then hide
      for (int rev = wid; rev < nitems; rev += nw) {
        const int it = nitems - 1 - rev;
        const bool is_edge = it < nchunk;
        const int i = base + it, n = it - nchunk;
        const CD* kp = !is_edge ? root_s
                       : i < nst ? ks + (size_t)i * WW
                                 : K + ((size_t)s * E + lslot[i]) * WW;
        const float* xs = xc + (is_edge ? lsrc[i] : mynode[n]) * W;
        float acc[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
        const CD* p = kp + (size_t)wi0 * W + g * CPL;
        bool done = false;
        if constexpr (sizeof(CD) == 2) {
          // 16-deep parts (bf16 at width 64), eight rows in flight at a time
          if (wi1 - wi0 == 16) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint4 raw[8];
#pragma unroll
              for (int r = 0; r < 8; ++r)
                raw[r] = *reinterpret_cast<const uint4*>(p + (8 * h + r) * W);
              float xv[8];
              load4(xs + wi0 + 8 * h, xv);
              load4(xs + wi0 + 8 * h + 4, xv + 4);
#pragma unroll
              for (int r = 0; r < 8; ++r) fma_row(raw[r], xv[r], acc);
            }
            done = true;
          }
        }
        if (!done) {
#pragma unroll 8
          for (int wi = wi0; wi < wi1; ++wi, p += W) {
            float kv[CPL];
            load16(p, kv);
            const float xv = xs[wi];
#pragma unroll
            for (int c = 0; c < CPL; ++c) acc[c] = fmaf(xv, kv[c], acc[c]);
          }
        }
        finish(acc, it, is_edge, i, n);
      }
      __syncthreads();
      MDNO_MARK(6 + 3 * layer)

      // per owned node and 4 columns, four lanes: each adds every fourth of
      // the node's messages of this chunk (in slot order), a butterfly adds
      // the four parts, (0 + 1) + (2 + 3)
      const bool more = base + nchunk < ne;
      for (int idx0 = 0; idx0 < total; idx0 += nt) {
        // this thread's output on the first pass (the only one unless a
        // block owns more than threads / w nodes) was decoded once, before
        // the layers
        Slot sl = mine;
        if (idx0 > 0) sl = slot_of(idx0 + tid);
        const bool valid = sl.valid;
        const int part = sl.part, n = sl.n, c4 = sl.c4;
        const int lo = max(sl.first, base);
        const int hi = valid ? min(sl.past, base + nchunk) : lo;
        float agg[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 3
        for (int i = lo + part; i < hi; i += 4) {
          float m[4];
          load4(msl + (i - base) * W + c4, m);
          for (int k = 0; k < 4; ++k) agg[k] += m[k];
        }
        for (int k = 0; k < 4; ++k) {
          agg[k] += __shfl_xor_sync(0xffffffffu, agg[k], 1);
          agg[k] += __shfl_xor_sync(0xffffffffu, agg[k], 2);
        }
        if (!valid) continue;
        if (base > 0)
          for (int k = 0; k < 4; ++k) agg[k] += aggs[n * W + c4 + k];
        if (more) {
          if (part == 0)
            for (int k = 0; k < 4; ++k) aggs[n * W + c4 + k] = agg[k];
          continue;
        }
        // x' = relu(agg * inv_deg + cd(x) @ cd(root) + bias); each of the
        // four lanes writes it into its share of the cluster's blocks
        float rx[4], bs[4], out[4];
        load4(rxs + n * W + c4, rx);
        load4(bias + c4, bs);
        for (int k = 0; k < 4; ++k) {
          const float z =
              __fadd_rn(__fadd_rn(__fmul_rn(agg[k], sl.invd), rx[k]), bs[k]);
          out[k] = relu_nan(z);
        }
        if (stack != nullptr && part == 0)
          *reinterpret_cast<float4*>(
              stack + (((size_t)s * (2 * depth + 1) + layer + 1) * R + sl.j) * W +
              c4) = make_float4(out[0], out[1], out[2], out[3]);
        if (!last)
          for (int k = 0; k < 4; ++k) out[k] = round_cd<CD>(out[k]);
        const float4 v = make_float4(out[0], out[1], out[2], out[3]);
        for (int r = part; r < ncl; r += 4)
          *reinterpret_cast<float4*>(cluster.map_shared_rank(xn, r) + sl.j * W + c4) = v;
      }
      if (more) __syncthreads();  // the next chunk overwrites the messages
    }
    MDNO_MARK(7 + 3 * layer)
    cluster_arrive();
    cluster_wait();  // x' complete everywhere; messages free again
    MDNO_MARK(8 + 3 * layer)
    { float* t = xc; xc = xn; xn = t; }
  }
  return xc;
}

// Runs the 2*depth layers of stream blockIdx.x / (blocks of the cluster).
// Every thread of every block of the cluster calls it. Returns the final
// node features (R, W) f32 in this block's shared memory, complete in every
// block of the cluster (the last cluster barrier has passed). MMA chooses
// the body, as Plan::mma says; the block has Plan::threads threads. With
// ``stack`` set, the item that forms x' of layer l for (node, columns) also
// stores its f32 value, before the rounding to CD, into
// stack[s, l + 1, node, columns] (row 0, x0, is the caller's); null (the
// rollout kernels) compiles that store away.
template <typename CD, bool MMA, int NB = NCL>
__device__ float* run(
    unsigned char* smem_raw,
    const float* __restrict__ x0,       // (S, R, W)
    const CD* __restrict__ K,           // (S, E, W*W), padded rows zero
    const int* __restrict__ edges,      // (S, 2, E)
    const float* __restrict__ mask,     // (S, E)
    const float* __restrict__ inv_deg,  // (S, R)
    const CD* __restrict__ root1, const float* __restrict__ bias1,
    const CD* __restrict__ root2, const float* __restrict__ bias2,
    int R, int W, int E, int depth, int cap,
    float* __restrict__ stack = nullptr) {  // (S, 2*depth+1, R, W) or null
  if constexpr (MMA)
    return run_mma<NB>(smem_raw, x0, K, edges, mask, inv_deg, root1, bias1,
                       root2, bias2, R, E, depth, cap, stack);
  else
    return run_fma<CD>(smem_raw, x0, K, edges, mask, inv_deg, root1, bias1,
                       root2, bias2, R, W, E, depth, cap, stack);
}

// The launch shape of a kernel that calls run(): the body (one per width
// and compute dtype), its threads a block, the K rows staged per block, the
// dynamic shared memory and the blocks of a cluster (NCL unless the caller
// launches run_mma<kWideNCL>).
struct Plan {
  bool mma;
  int threads;
  int cap;
  size_t smem;
  int ncl = NCL;
};

// cudaErrorInvalidValue for a width the item lanes do not cover,
// cudaErrorInvalidConfiguration when the buffers alone exceed shared memory.
inline int plan(int R, int W, int E, int cd_size, Plan* out) {
  if (W % 8 != 0 || W * cd_size > 32 * 16) return (int)cudaErrorInvalidValue;
  const size_t fixed = layout(R, W, E, cd_size, 0).total;
  if (fixed > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  const size_t row = (size_t)W * W * cd_size;
  const size_t fit = ((size_t)kMaxSmem - fixed) / row;
  out->mma = takes_mma(W, cd_size);
  out->threads = out->mma ? kMmaThreads : kThreads;
  out->cap = (int)(fit < (size_t)E ? fit : (size_t)E);
  out->smem = layout(R, W, E, cd_size, out->cap).total;
  return 0;
}

// The launch of ``kernel`` as S clusters of ``p.ncl`` blocks of
// ``p.threads`` threads with ``p.smem`` bytes of dynamic shared memory on
// ``st``.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;
};

template <typename... Params>
int prepare(void (*kernel)(Params...), int S, const Plan& p, cudaStream_t st,
            ClusterLaunch* cl) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  if (p.ncl > NCL) {  // more than the portable 8 blocks
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cl->attr[0].id = cudaLaunchAttributeClusterDimension;
  cl->attr[0].val.clusterDim.x = p.ncl;
  cl->attr[0].val.clusterDim.y = 1;
  cl->attr[0].val.clusterDim.z = 1;
  cl->config = cudaLaunchConfig_t{};
  cl->config.gridDim = dim3(S * p.ncl);
  cl->config.blockDim = dim3(p.threads);
  cl->config.dynamicSmemBytes = p.smem;
  cl->config.stream = st;
  cl->config.attrs = cl->attr;
  cl->config.numAttrs = 1;
  return 0;
}

// How many clusters of this launch shape the card holds at once.
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), const Plan& p, int* out) {
  ClusterLaunch cl;
  const int rc = prepare(kernel, 1, p, nullptr, &cl);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cl.config);
}

// Returns a CUDA error code; cudaErrorInvalidConfiguration when the card
// cannot co-schedule the cluster.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int S, const Plan& p,
                    cudaStream_t st, Args... args) {
  ClusterLaunch cl;
  int rc = prepare(kernel, S, p, st, &cl);
  if (rc != 0) return rc;
  int clusters = 0;
  rc = (int)cudaOccupancyMaxActiveClusters(&clusters, kernel, &cl.config);
  if (rc != 0) return rc;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaLaunchKernelEx(&cl.config, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace conv_stack
