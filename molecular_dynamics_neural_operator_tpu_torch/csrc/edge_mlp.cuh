// The edge-kernel MLP shared by edge_mlp.cu (the rollout step) and
// fused_gkn.cu (the fused MLP + conv stack): the bf16 warpgroup-MMA kernel,
// the narrow first-layer kernel, the FMA kernel (f32, and bf16 layers whose
// K is no multiple of 64), the
// TMA descriptors and the host functions that pick a kernel and enqueue it.
// See edge_mlp.cu for what bounds the function on an H100 and why the
// design is what it is.
//
// bf16 kernel, one launch per layer C = act(A @ B + bias) * row_mask:
//   - a block owns a (64 * NC) x BN output tile; NC consumer warpgroups of
//     128 threads each hold 64 rows of it in wgmma accumulators (f32), one
//     more warp is the producer;
//   - the producer's lane 0 keeps TMA loads in flight into a ring of
//     kStages stages; A (M, K) arrives as 64-column boxes (K-major, 128-byte
//     swizzle), B (K, N) as 64 x 64 boxes straight from the row-major weight
//     (N contiguous: the "MN-major" operand form, transposed by the
//     descriptor, same swizzle). Stages are handed over through mbarriers:
//     full[] counts the TMA bytes, empty[] one arrival per consumer warp;
//   - every product is the same wgmma shape, m64n64k16, run in k
//     order, so the order in which an output's K products are summed does
//     not depend on the tile shape, the grid or M; the persistent plan of
//     large M (edge_mlp_persistent_kernel, from kPersistentMinRows rows on)
//     runs m64n256k16 in k order and gives the same bits;
//   - bias, ReLU, the row mask and the single rounding to bf16 are applied
//     on the accumulator registers; two lanes swap halves so that each
//     writes 8 contiguous bytes.
// The 6-wide first layer has a kernel of its own (edge_mlp_narrow_kernel):
// a thread forms eight outputs of a row from the row's K inputs by FMAs.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <dlfcn.h>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace edge_mlp {

// ---- bf16: TMA + wgmma -----------------------------------------------------
constexpr int BK = 64;          // k-tile: 128 bytes of bf16, one swizzle row
constexpr int kStages = 4;      // depth of the TMA ring
constexpr int kBoxBytes = 64 * 128;  // one 64-row box of 128-byte rows

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile whose 8-row
// groups lie 1024 bytes apart. ``lbo16`` is the leading byte offset in
// 16-byte units: unused (1) for a K-major operand; for the MN-major B it is
// the distance between 64-column blocks, of which one wgmma spans
// exactly one.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo16) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)lbo16 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

#define MDNO_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define MDNO_ACC32_REGS                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (64 x 64, f32) += A (64 x 16, K-major, shared) @ B (16 x 64, MN-major,
// shared), bf16 operands.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MDNO_ACC32_REGS
      ", %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : MDNO_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16) @ B (16 x 256): the four 64-column
// blocks of B lie kBoxBytes apart (the descriptor's leading byte offset).
// d[j][i] holds what d[i] of the m64n64 form holds for block j.
#define MDNO_ACC128(d) \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
  "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]), \
  "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), \
  "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]), \
  "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), \
  "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]), \
  "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), \
  "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]), \
  "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
  "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]), \
  "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), \
  "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]), \
  "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), \
  "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]), \
  "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), \
  "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]), \
  "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), \
  "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]), \
  "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]), \
  "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]), \
  "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]), \
  "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]), \
  "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]), \
  "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]), \
  "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
  "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]), \
  "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]), \
  "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]), \
  "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]), \
  "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]), \
  "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]), \
  "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])

#define MDNO_ACC128_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127}"

__device__ __forceinline__ void wgmma_ss_n256(float (&d)[4][32],
                                              uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " MDNO_ACC128_REGS
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : MDNO_ACC128(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Dynamic shared memory of the kernel below, with 1024 bytes of slack to
// align the first stage to the swizzle pattern's period.
constexpr size_t wgmma_smem_bytes(int nc, int bn) {
  return 1024 + (size_t)kStages * (nc + bn / 64) * kBoxBytes + 2 * kStages * 8;
}

// The epilogue of a consumer warpgroup: bias, ReLU, the row mask and the
// single rounding to bf16 on its accumulators of the 64 x (64 NJ) output
// tile at column n0, stored to C (M, N). d[4 c + 0, 1] of a 64-column block
// is (row_a, 8 c + 2 quad + 0, 1), d[4 c + 2, 3] the same columns of
// row_b = row_a + 8. Lanes quad and quad ^ 1 swap so that the even lane
// stores four columns of chunk c and the odd lane four of chunk c + 1.
template <int NJ>
__device__ __forceinline__ void store_tile(
    const float (&acc)[NJ][32], const float* __restrict__ bias,
    const float* __restrict__ row_mask, __nv_bfloat16* __restrict__ C, int M,
    int N, int n0, int row_a, int quad, int relu) {
  const int row_b = row_a + 8;
  const float mask_a = (row_mask && row_a < M) ? row_mask[row_a] : 1.f;
  const float mask_b = (row_mask && row_b < M) ? row_mask[row_b] : 1.f;
  const bool odd = quad & 1;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 8; c += 2) {
      const int col = n0 + j * 64 + c * 8 + quad * 2;
      const float2 bc0 = *reinterpret_cast<const float2*>(bias + col);
      const float2 bc1 = *reinterpret_cast<const float2*>(bias + col + 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mk = h ? mask_b : mask_a;
        float v[4] = {acc[j][4 * c + 2 * h] + bc0.x,
                      acc[j][4 * c + 2 * h + 1] + bc0.y,
                      acc[j][4 * (c + 1) + 2 * h] + bc1.x,
                      acc[j][4 * (c + 1) + 2 * h + 1] + bc1.y};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (relu) v[i] = relu_nan(v[i]);
          if (row_mask) v[i] = v[i] * mk;
        }
        const __nv_bfloat162 q0 = __floats2bfloat162_rn(v[0], v[1]);
        const __nv_bfloat162 q1 = __floats2bfloat162_rn(v[2], v[3]);
        const uint32_t p0 = *reinterpret_cast<const uint32_t*>(&q0);
        const uint32_t p1 = *reinterpret_cast<const uint32_t*>(&q1);
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? p0 : p1, 1);
        const int row = h ? row_b : row_a;
        if (row < M) {
          const uint2 out = odd ? make_uint2(got, p1) : make_uint2(p0, got);
          *reinterpret_cast<uint2*>(C + (size_t)row * N + (odd ? col + 6 : col)) = out;
        }
      }
    }
}

template <int NC, int BN>
__global__ void __launch_bounds__(NC * 128 + 32) edge_mlp_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a,  // A (M, K)
    const __grid_constant__ CUtensorMap map_b,  // B (K, N)
    const float* __restrict__ bias,             // (N)
    const float* __restrict__ row_mask,         // (M) or null
    __nv_bfloat16* __restrict__ C,              // (M, N)
    int M, int N, int K, int relu) {
  constexpr int NJ = BN / 64;                       // 64-column blocks of B
  constexpr int kABytes = NC * kBoxBytes;
  constexpr int kStageBytes = kABytes + NJ * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(stages + kStages * kStageBytes);
  unsigned long long* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * (NC * 64), n0 = blockIdx.x * BN;
  const int nk = K / BK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NC * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == NC * 4) {
    // ---- producer: one lane keeps the ring full ---------------------------
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int stage = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
        unsigned char* st = stages + stage * kStageBytes;
        mbar_arrive_expect_tx(&full[stage], kStageBytes);
        tma_load_2d(st, &map_a, &full[stage], kt * BK, m0);
        for (int j = 0; j < NJ; ++j)
          tma_load_2d(st + kABytes + j * kBoxBytes, &map_b, &full[stage],
                      n0 + j * 64, kt * BK);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows m0 + 64 wg .. + 63 ---------------
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int row_a = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt % kStages;
    mbar_wait(&full[stage], (kt / kStages) & 1);
    const unsigned a_addr = smem_u32(stages + stage * kStageBytes) + wg * kBoxBytes;
    const unsigned b_addr = smem_u32(stages + stage * kStageBytes) + kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // 16 columns of a K-major row are 32 bytes; 16 rows of the
      // MN-major B are two 8-row groups
      const uint64_t da = smem_desc(a_addr + kk * 32, 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        wgmma_ss(acc[j], da,
                 smem_desc(b_addr + j * kBoxBytes + kk * 2048, 1024 >> 4));
    }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();  // tile kt - 1 is done with its stage
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    }
  }
  wgmma_wait<0>();

  store_tile(acc, bias, row_mask, C, M, N, n0, row_a, quad, relu);
}

// ---- large M: persistent blocks over 128 x 256 tiles -------------------------
// From kPersistentMinRows rows on (the 10,000-atom step's 480,000 slots; no
// rollout or serving launch comes near), a block an SM walks over the output
// tiles, row band by row band, so that B stays in L2 and a band's A is read
// from it by the band's column tiles. The producer runs on into the next
// tile's k-tiles while the consumers finish a tile's epilogue, so that a
// tile starts on loads already in flight. Each k16 step is one m64n256k16
// wgmma a warpgroup (n256 reads a quarter of the A bytes a product that
// four m64n64k16 read); an output still sums its K products in k order.
constexpr int kPersistentMinRows = 16384;
constexpr int kPBN = 256;  // tile columns; two consumer warpgroups, 128 rows

__global__ void __launch_bounds__(2 * 128 + 32, 1) edge_mlp_persistent_kernel(
    const __grid_constant__ CUtensorMap map_a,  // A (M, K), 128-row boxes
    const __grid_constant__ CUtensorMap map_b,  // B (K, N)
    const float* __restrict__ bias,             // (N)
    const float* __restrict__ row_mask,         // (M) or null
    __nv_bfloat16* __restrict__ C,              // (M, N)
    int M, int N, int K, int relu) {
  constexpr int NC = 2, NJ = kPBN / 64;
  constexpr int kABytes = NC * kBoxBytes;
  constexpr int kStageBytes = kABytes + NJ * kBoxBytes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(stages + kStages * kStageBytes);
  unsigned long long* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = N / kPBN;
  const int tiles = n_tiles * ((M + NC * 64 - 1) / (NC * 64));
  const int nk = K / BK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NC * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // it counts the block's k-tiles over all its tiles: the ring's stage and
  // phase run on from one tile into the next
  if (warp == NC * 4) {
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * (NC * 64), n0 = (t % n_tiles) * kPBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int stage = it % kStages, round = it / kStages;
          if (round > 0) mbar_wait(&empty[stage], (round - 1) & 1);
          unsigned char* st = stages + stage * kStageBytes;
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(st, &map_a, &full[stage], kt * BK, m0);
          for (int j = 0; j < NJ; ++j)
            tma_load_2d(st + kABytes + j * kBoxBytes, &map_b, &full[stage],
                        n0 + j * 64, kt * BK);
        }
      }
    }
    return;
  }

  const int wg = warp / 4, quad = lane % 4;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / n_tiles) * (NC * 64), n0 = (t % n_tiles) * kPBN;
    float acc[NJ][32];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int stage = it % kStages;
      mbar_wait(&full[stage], (it / kStages) & 1);
      const unsigned a_addr =
          smem_u32(stages + stage * kStageBytes) + wg * kBoxBytes;
      const unsigned b_addr = smem_u32(stages + stage * kStageBytes) + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_n256(acc, smem_desc(a_addr + kk * 32, 1),
                      smem_desc(b_addr + kk * 2048, kBoxBytes >> 4));
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
    store_tile(acc, bias, row_mask, C, M, N, n0,
               m0 + wg * 64 + (warp % 4) * 16 + lane / 4, quad, relu);
  }
}

// ---- FMA kernel: f32, and bf16 layers the wgmma kernel does not take --------
constexpr int FBM = 64, FBN = 64, FBK = 16, kFmaThreads = 256;

template <typename CD>
__global__ void __launch_bounds__(kFmaThreads) edge_mlp_fma_kernel(
    const CD* __restrict__ A, const CD* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ row_mask,
    CD* __restrict__ C, int M, int N, int K, int relu) {
  __shared__ float As[FBK][FBM + 4];  // transposed tile: As[k][m]
  __shared__ float Bs[FBK][FBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // 4 x 4 outputs each, stride 16
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int idx = tid; idx < FBM * FBK; idx += kFmaThreads) {
      const int r = idx / FBK, c = idx % FBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32<CD>(A[(size_t)gm * K + gk]) : 0.f;
    }
    for (int idx = tid; idx < FBK * FBN; idx += kFmaThreads) {
      const int r = idx / FBN, c = idx % FBN;
      const int gk = k0 + r;
      Bs[r][c] = gk < K ? to_f32<CD>(B[(size_t)gk * N + n0 + c]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < FBK; ++kk) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      float v = acc[i][j] + bias[gn];
      if (relu) v = relu_nan(v);
      if (row_mask) v = v * row_mask[gm];
      C[(size_t)gm * N + gn] = from_f32<CD>(v);
    }
  }
}

// ---- bf16 layers with a few inputs (the MLP's first, K = 6) -------------------
constexpr int kNarrowMaxK = 16;

// A thread forms eight neighbouring outputs of one row: the row's K inputs
// times eight columns of B (one 16-byte load a k), f32 sums in k order,
// bias, ReLU, row mask, one 16-byte store.
__global__ void __launch_bounds__(kFmaThreads) edge_mlp_narrow_kernel(
    const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    const float* __restrict__ bias, const float* __restrict__ row_mask,
    __nv_bfloat16* __restrict__ C, int M, int N, int K, int relu) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int n8 = N / 8;
  if (idx >= M * n8) return;
  const int row = idx / n8, col = (idx % n8) * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float a = __bfloat162float(A[(size_t)row * K + k]);
    const uint4 raw = *reinterpret_cast<const uint4*>(B + (size_t)k * N + col);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[2 * c] = fmaf(a, __uint_as_float(w[c] << 16), acc[2 * c]);
      acc[2 * c + 1] = fmaf(a, __uint_as_float(w[c] & 0xffff0000u), acc[2 * c + 1]);
    }
  }
  const float mk = row_mask ? row_mask[row] : 1.f;
  uint32_t out[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float v[2] = {acc[2 * c] + bias[col + 2 * c], acc[2 * c + 1] + bias[col + 2 * c + 1]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (relu) v[i] = relu_nan(v[i]);
      if (row_mask) v[i] = v[i] * mk;
    }
    const __nv_bfloat162 q = __floats2bfloat162_rn(v[0], v[1]);
    out[c] = *reinterpret_cast<const uint32_t*>(&q);
  }
  *reinterpret_cast<uint4*>(C + (size_t)row * N + col) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

// ---- host side ---------------------------------------------------------------

// The TMA descriptor of a row-major bf16 matrix (rows, cols) read in boxes
// of 64 columns (128 bytes) by ``box_rows`` rows with the 128-byte swizzle.
// A descriptor holds only the address and the shape, so the ones made are
// kept by those: a step's buffers and weights are encoded once, not at
// every launch. Returns a CUDA error code.
inline int tensor_map(const void* base, uint64_t rows, uint64_t cols,
                      uint32_t box_rows, CUtensorMap* out) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static std::mutex lock;
  static Encode encode = nullptr;
  static std::map<std::tuple<const void*, uint64_t, uint64_t, uint32_t>,
                  CUtensorMap> made;
  std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(base, rows, cols, box_rows);
  const auto hit = made.find(key);
  if (hit != made.end()) {
    *out = hit->second;
    return 0;
  }
  if (!encode) {
    // libcuda is already in the process (the CUDA runtime loaded it)
    void* libcuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (libcuda)
      encode = reinterpret_cast<Encode>(dlsym(libcuda, "cuTensorMapEncodeTiled"));
    if (!encode) return (int)cudaErrorSharedObjectSymbolNotFound;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (rc != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (made.size() >= 256) made.clear();
  made.emplace(key, *out);
  return 0;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NC, int BN>
int launch_wgmma(const void* A, const void* B, const float* bias,
                 const float* row_mask, void* C, int M, int N, int K, int relu,
                 cudaStream_t st) {
  CUtensorMap map_a, map_b;
  int rc = tensor_map(B, K, N, 64, &map_b);
  if (rc == 0) rc = tensor_map(A, M, K, NC * 64, &map_a);
  if (rc != 0) return rc;
  auto kernel = edge_mlp_wgmma_kernel<NC, BN>;
  constexpr size_t smem = wgmma_smem_bytes(NC, BN);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / BN, (M + NC * 64 - 1) / (NC * 64));
  kernel<<<grid, NC * 128 + 32, smem, st>>>(map_a, map_b, bias, row_mask,
                                            static_cast<__nv_bfloat16*>(C), M,
                                            N, K, relu);
  return (int)cudaGetLastError();
}

// The persistent plan at kPersistentMinRows rows and more: a block an SM,
// never more blocks than tiles. Returns a CUDA error code.
inline int launch_persistent(const void* A, const void* B, const float* bias,
                             const float* row_mask, void* C, int M, int N,
                             int K, int relu, cudaStream_t st) {
  CUtensorMap map_a, map_b;
  int rc = tensor_map(B, K, N, 64, &map_b);
  if (rc == 0) rc = tensor_map(A, M, K, 128, &map_a);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr size_t smem = wgmma_smem_bytes(2, kPBN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(edge_mlp_persistent_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N / kPBN) * ((M + 127) / 128);
  edge_mlp_persistent_kernel<<<tiles < sms ? tiles : sms, 2 * 128 + 32, smem,
                               st>>>(map_a, map_b, bias, row_mask,
                                     static_cast<__nv_bfloat16*>(C), M, N, K,
                                     relu);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles (two consumer warpgroups) where they still give the card
// about a block an SM, 64 x 64 tiles otherwise: at one stream (224 rows)
// the wide layer is 256 small blocks, two an SM, in one wave. The choice
// changes which block computes an output, never the order of its sum.
inline bool big_tiles(int M, int N) {
  return N % 128 == 0 && ((M + 127) / 128) * (N / 128) >= 96;
}

// 128 x 64 tiles (two consumer warpgroups, half the A traffic of 64 x 64)
// where those cover the card and the 128 x 128 ones do not.
inline bool tall_tiles(int M, int N) {
  return !big_tiles(M, N) && ((M + 127) / 128) * (N / 64) >= 96;
}

// Enqueues one layer C = act(A @ B + bias) * row_mask on ``st``; A (M, K),
// B (K, N), C (M, N) in the compute dtype, N a multiple of 64, any K.
// Which kernel runs depends on the dtype and K alone: bf16 with K a multiple
// of 64 the wgmma kernel (persistent from kPersistentMinRows rows on where
// N is a multiple of 256), bf16 with K <= 16 the narrow kernel, anything
// else the FMA kernel. The first two need 16-byte-aligned matrices (A too for
// TMA); a misaligned one is cudaErrorInvalidValue, never another kernel.
// Returns a CUDA error code.
inline int launch(const void* A, const void* B, const float* bias,
                  const float* row_mask, void* C, int M, int N, int K,
                  int relu, int cd_bf16, cudaStream_t st) {
  if (M < 1 || K < 1 || N % FBN != 0) return (int)cudaErrorInvalidValue;
  if (cd_bf16 && K % BK == 0) {
    if (!aligned16(A) || !aligned16(B) || !aligned16(C))
      return (int)cudaErrorInvalidValue;
    if (M >= kPersistentMinRows && N % kPBN == 0)
      return launch_persistent(A, B, bias, row_mask, C, M, N, K, relu, st);
    if (big_tiles(M, N))
      return launch_wgmma<2, 128>(A, B, bias, row_mask, C, M, N, K, relu, st);
    if (tall_tiles(M, N))
      return launch_wgmma<2, 64>(A, B, bias, row_mask, C, M, N, K, relu, st);
    return launch_wgmma<1, 64>(A, B, bias, row_mask, C, M, N, K, relu, st);
  }
  if (cd_bf16 && K <= kNarrowMaxK) {
    if (!aligned16(B) || !aligned16(C)) return (int)cudaErrorInvalidValue;
    const int items = M * (N / 8);
    edge_mlp_narrow_kernel<<<(items + kFmaThreads - 1) / kFmaThreads,
                             kFmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
        bias, row_mask, static_cast<__nv_bfloat16*>(C), M, N, K, relu);
    return (int)cudaGetLastError();
  }
  const dim3 grid(N / FBN, (M + FBM - 1) / FBM);
  if (cd_bf16)
    edge_mlp_fma_kernel<__nv_bfloat16><<<grid, kFmaThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(A), static_cast<const __nv_bfloat16*>(B),
        bias, row_mask, static_cast<__nv_bfloat16*>(C), M, N, K, relu);
  else
    edge_mlp_fma_kernel<float><<<grid, kFmaThreads, 0, st>>>(
        static_cast<const float*>(A), static_cast<const float*>(B), bias,
        row_mask, static_cast<float*>(C), M, N, K, relu);
  return (int)cudaGetLastError();
}

// Enqueues the whole edge-kernel MLP on ``st``, three launches:
//   kmat = (relu(relu(ef @ w1 + b1) @ w2 + b2) @ w3 + b3) * row_mask
// ef (M, F), w1 (F, KW), w2 (KW, KW), w3 (KW, N3); h1, h2 (M, KW) scratch.
// Returns a CUDA error code.
inline int launch_stack(const void* ef, const void* w1, const float* b1,
                        const void* w2, const float* b2, const void* w3,
                        const float* b3, const float* row_mask, void* h1,
                        void* h2, void* kmat, int M, int KW, int N3, int F,
                        int cd_bf16, cudaStream_t st) {
  if (M < 1 || F < 1 || KW % FBN != 0 || N3 % FBN != 0)
    return (int)cudaErrorInvalidValue;
  int rc = launch(ef, w1, b1, nullptr, h1, M, KW, F, 1, cd_bf16, st);
  if (rc == 0)
    rc = launch(h1, w2, b2, nullptr, h2, M, KW, KW, 1, cd_bf16, st);
  if (rc == 0)
    rc = launch(h2, w3, b3, row_mask, kmat, M, N3, KW, 0, cd_bf16, st);
  return rc;
}

}  // namespace edge_mlp
