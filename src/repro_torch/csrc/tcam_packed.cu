// Bit-packed ternary CAM match with selective precharge, for sm_90a.
//
// Replaces: src/repro/kernels/tcam_packed.py, `_kernel` launched by
// `tcam_match_packed_pallas` (the Pallas TPU kernel behind engine "packed").
//
// Computes, for every search word b and TCAM row r, walking the column
// divisions d = 0..D-1 of width S = 32*SW bits in order:
//     mism  = sum over the division's words of popc((x ^ val) & care)
//     match = mism <= kmax[r, d]
// A row is evaluated in division d iff it matched every earlier division.
// Outputs survive[b, r] (matched all D divisions) and evals[b, r] (divisions
// evaluated), both int32, row-major (B, R).
//
// What bounds it on this card: bytes.  The inputs are small (the packed rows
// of a Give Me Some Credit layout are 5 MB) but the two (B, R) int32 outputs
// are 8 bytes per (b, r) pair, 825 MB at B = 12027, R = 8576; the popcount
// work per pair is a few integer operations, because almost every row of a
// decision-tree TCAM fails its first or second division.
//
// What the design does about it:
//  * The TPU kernel keeps the precharge carry in a revisited output block
//    across a sequential grid axis.  Blocks on this card run in no order, so
//    the division loop is inside the thread: one thread owns one row r and
//    walks the divisions for each search word of its block's batch tile.
//  * The thread stops at its first mismatching division.  That is exact:
//    after it the row is inactive, evals stops growing and survive stays 0.
//    A TPU cannot branch per element; here it removes nearly all the work,
//    leaving the output stores, which are coalesced (consecutive threads own
//    consecutive rows r of one output row b).
//  * Division 0, which every pair evaluates, keeps its val/care words in
//    registers for the whole batch tile; later divisions load theirs with
//    16-byte loads when the division is 4 words (S = 128).
//  * The batch tile's search words sit in shared memory; every thread of a
//    warp reads the same word, a broadcast.
//  * kmax = -1 never matches (mism >= 0); a fully masked division has
//    kmax = S and always matches.  Ragged B and R edges are masked here, so
//    the caller pads nothing.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 128;     // threads per block, one TCAM row each
constexpr int kMaxBatchPerBlock = 32;  // search words tiled in shared memory
constexpr size_t kSmemBudget = 48 * 1024;

template <int SW>
__device__ __forceinline__ void load_words(uint32_t (&out)[SW],
                                           const uint32_t* __restrict__ p) {
  if constexpr (SW % 4 == 0) {
#pragma unroll
    for (int w = 0; w < SW; w += 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + w));
      out[w] = q.x;
      out[w + 1] = q.y;
      out[w + 2] = q.z;
      out[w + 3] = q.w;
    }
  } else if constexpr (SW % 2 == 0) {
#pragma unroll
    for (int w = 0; w < SW; w += 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p + w));
      out[w] = q.x;
      out[w + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < SW; ++w) out[w] = __ldg(p + w);
  }
}

template <int SW>
__device__ __forceinline__ int mismatches(const uint32_t* __restrict__ x,
                                          const uint32_t (&v)[SW],
                                          const uint32_t (&c)[SW]) {
  int m = 0;
#pragma unroll
  for (int w = 0; w < SW; ++w) m += __popc((x[w] ^ v[w]) & c[w]);
  return m;
}

// Search words of rows [b0, b0 + nb) into shared memory.
__device__ __forceinline__ void load_batch_tile(uint32_t* xs,
                                                const uint32_t* __restrict__ x,
                                                int b0, int nb, int W32) {
  const uint32_t* xg = x + static_cast<size_t>(b0) * W32;
  for (int i = threadIdx.x; i < nb * W32; i += blockDim.x) xs[i] = __ldg(xg + i);
  __syncthreads();
}

// S/32 = SW words per division, known at compile time.
template <int SW>
__global__ void __launch_bounds__(kRowsPerBlock)
tcam_packed_kernel(const uint32_t* __restrict__ x,
                   const uint32_t* __restrict__ val,
                   const uint32_t* __restrict__ care,
                   const int32_t* __restrict__ kmax,
                   int32_t* __restrict__ survive, int32_t* __restrict__ evals,
                   int B, int R, int W32, int D, int batch_per_block) {
  extern __shared__ uint32_t xs[];  // [batch_per_block][W32]
  const int b0 = blockIdx.y * batch_per_block;
  const int nb = min(batch_per_block, B - b0);
  load_batch_tile(xs, x, b0, nb, W32);

  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= R) return;
  const uint32_t* vr = val + static_cast<size_t>(r) * W32;
  const uint32_t* cr = care + static_cast<size_t>(r) * W32;
  const int32_t* kr = kmax + static_cast<size_t>(r) * D;

  uint32_t v0[SW], c0[SW];
  load_words<SW>(v0, vr);
  load_words<SW>(c0, cr);
  const int k0 = __ldg(kr);

  for (int i = 0; i < nb; ++i) {
    const uint32_t* xb = xs + i * W32;
    int ev = 1;
    bool alive = mismatches<SW>(xb, v0, c0) <= k0;
    for (int d = 1; alive && d < D; ++d) {
      uint32_t v[SW], c[SW];
      load_words<SW>(v, vr + d * SW);
      load_words<SW>(c, cr + d * SW);
      ++ev;
      alive = mismatches<SW>(xb + d * SW, v, c) <= __ldg(kr + d);
    }
    const size_t o = static_cast<size_t>(b0 + i) * R + r;
    survive[o] = alive ? 1 : 0;
    evals[o] = ev;
  }
}

// Any division width: the same walk with the word count read at run time.
__global__ void __launch_bounds__(kRowsPerBlock)
tcam_packed_kernel_any(const uint32_t* __restrict__ x,
                       const uint32_t* __restrict__ val,
                       const uint32_t* __restrict__ care,
                       const int32_t* __restrict__ kmax,
                       int32_t* __restrict__ survive,
                       int32_t* __restrict__ evals, int B, int R, int W32,
                       int SW, int batch_per_block) {
  extern __shared__ uint32_t xs[];
  const int b0 = blockIdx.y * batch_per_block;
  const int nb = min(batch_per_block, B - b0);
  load_batch_tile(xs, x, b0, nb, W32);

  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= R) return;
  const int D = W32 / SW;
  const uint32_t* vr = val + static_cast<size_t>(r) * W32;
  const uint32_t* cr = care + static_cast<size_t>(r) * W32;
  const int32_t* kr = kmax + static_cast<size_t>(r) * D;
  for (int i = 0; i < nb; ++i) {
    const uint32_t* xb = xs + i * W32;
    int ev = 0;
    bool alive = true;
    for (int d = 0; alive && d < D; ++d) {
      int m = 0;
      for (int w = d * SW; w < (d + 1) * SW; ++w)
        m += __popc((xb[w] ^ __ldg(vr + w)) & __ldg(cr + w));
      ++ev;
      alive = m <= __ldg(kr + d);
    }
    const size_t o = static_cast<size_t>(b0 + i) * R + r;
    survive[o] = alive ? 1 : 0;
    evals[o] = ev;
  }
}

template <int SW>
void launch(dim3 grid, size_t smem, cudaStream_t stream, const uint32_t* x,
            const uint32_t* val, const uint32_t* care, const int32_t* kmax,
            int32_t* survive, int32_t* evals, int B, int R, int W32, int bb) {
  tcam_packed_kernel<SW><<<grid, kRowsPerBlock, smem, stream>>>(
      x, val, care, kmax, survive, evals, B, R, W32, W32 / SW, bb);
}

}  // namespace

// x (B, W32), val and care (R, W32) packed words; kmax (R, W32/SW) int32;
// survive and evals (B, R) int32 outputs.  All row-major, contiguous and
// 16-byte aligned.  Launches on `stream`; returns cudaGetLastError().
extern "C" int dt2cam_tcam_packed(const void* x, const void* val,
                                  const void* care, const void* kmax,
                                  void* survive, void* evals, int B, int R,
                                  int W32, int SW, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (SW <= 0 || W32 <= 0 || W32 % SW != 0) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(W32) * sizeof(uint32_t);
  const int bb = static_cast<int>(
      row_bytes * kMaxBatchPerBlock <= kSmemBudget ? kMaxBatchPerBlock
                                                   : kSmemBudget / row_bytes);
  if (bb < 1) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, (B + bb - 1) / bb);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = bb * row_bytes;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* xw = static_cast<const uint32_t*>(x);
  auto* vw = static_cast<const uint32_t*>(val);
  auto* cw = static_cast<const uint32_t*>(care);
  auto* km = static_cast<const int32_t*>(kmax);
  auto* sv = static_cast<int32_t*>(survive);
  auto* ev = static_cast<int32_t*>(evals);
  switch (SW) {
    case 1: launch<1>(grid, smem, s, xw, vw, cw, km, sv, ev, B, R, W32, bb); break;
    case 2: launch<2>(grid, smem, s, xw, vw, cw, km, sv, ev, B, R, W32, bb); break;
    case 4: launch<4>(grid, smem, s, xw, vw, cw, km, sv, ev, B, R, W32, bb); break;
    default:
      tcam_packed_kernel_any<<<grid, kRowsPerBlock, smem, s>>>(
          xw, vw, cw, km, sv, ev, B, R, W32, SW, bb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dt2cam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
