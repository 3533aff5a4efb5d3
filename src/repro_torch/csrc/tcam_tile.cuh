// Device helpers shared by the two match kernels, tcam_match.cu (bitplane)
// and tcam_packed.cu (packed popcount): cp.async staging of a division's
// search words into shared memory, vector loads of a row's words, and the
// mask of a tile's words.  Each kernel's body and arithmetic stay in its
// own source.  An edit here rebuilds both libraries (kernels/_cuda.py
// hashes every csrc/*.cuh with each source).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n consecutive 32-bit words from 8-byte (n odd) or 16-byte (n even)
// aligned memory.
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&w)[N],
                                           const uint32_t* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z,
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = p[i];
  }
}

// One row's 2·SW words of a division, read-only path.
template <int SW>
__device__ __forceinline__ void load_row(uint32_t (&w)[2 * SW],
                                         const uint32_t* p) {
  if constexpr (SW % 2 == 0) {
#pragma unroll
    for (int i = 0; i < SW / 2; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z,
      w[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SW; ++i) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    }
  }
}

// `chunks` 16-byte copies of one division's words of the tile into shared
// memory by the block's kThreads threads, as one commit group (empty past
// the last division, so that wait_group counts stay in step).
template <int kThreads>
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* src,
                                      int chunks) {
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(dst + 4 * c, src + 4 * c);
  cp_async_commit();
}

// Bits of mask word c that index words < nb of the tile.
__device__ __forceinline__ uint32_t tile_bits(int c, int nb) {
  const int n = nb - 32 * c;
  return n >= 32 ? 0xffffffffu : (n <= 0 ? 0u : (1u << n) - 1u);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace
