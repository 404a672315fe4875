// Shared helpers of the port's kernels (every .cu and .cuh here). CD is
// the compute dtype of the products: float or __nv_bfloat16. Every product accumulates in f32; a value is
// rounded to CD exactly where the JAX package casts it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to CD and widened back: the operand an f32-accumulated
// product sees after a cast to CD.
template <typename T>
__device__ __forceinline__ float round_cd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// ReLU that keeps NaN, as torch.relu and jnp.maximum(x, 0) do.
__device__ __forceinline__ float relu_nan(float v) {
  return v < 0.f ? 0.f : v;
}

// ---- Hopper primitives (PTX) shared by the redesigned kernels ---------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarrier: a barrier in shared memory that counts thread arrivals and the
// bytes of asynchronous copies. A wait with parity p returns once the
// barrier's phase of that parity has completed.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done, polls = 0;
  unsigned long long since = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    // A phase that never completes is a bug: fault, do not hang the card.
    // The limit is time, not polls (a block that is merely held up, under a
    // debugger or while the card is shared, must not fault): the clock is
    // read every 65,536 polls, and a wait of 20 s from the first reading
    // traps.
    if (!done && (++polls & 0xffffu) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (since == 0) since = now;
      else if (now - since > 20000000000ull) __trap();
    }
  } while (!done);
}

// The same by test_wait: the thread polls and is never suspended, so it
// sees the phase complete at once, at the cost of issue slots while it
// waits.
__device__ __forceinline__ void mbar_wait_spin(unsigned long long* bar,
                                               unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done, polls = 0;
  unsigned long long since = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (++polls & 0xffffu) == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (since == 0) since = now;
      else if (now - since > 20000000000ull) __trap();
    }
  } while (!done);
}

// ``bytes`` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory by the copy engine; completion is
// counted on ``bar``.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The cluster-wide barrier, split: everything a thread wrote before its
// arrive (also into other blocks' shared memory) is visible to every thread
// of the cluster after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of this block's shared address ``addr`` in
// block ``rank`` of the cluster.
__device__ __forceinline__ unsigned map_to_block(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}
