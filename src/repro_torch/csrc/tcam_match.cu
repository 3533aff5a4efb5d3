// Bitplane ternary CAM match with selective precharge, for sm_90a.
//
// Replaces: src/repro/kernels/tcam_match.py, `_kernel` launched by
// `tcam_match_pallas` (the Pallas TPU kernel behind engine "mxu").
//
// Computes, for every search word b and TCAM row r, walking the column
// divisions d = 0..D-1 of width S in order:
//     mism  = sum over the division's cells of (x ? is0 : is1)
//     match = mism <= kmax[r, d]
// which is the TPU kernel's X·is0ᵀ + (1-X)·is1ᵀ for x in {0,1}.  A CELL_MM
// cell sets both planes and so mismatches either input bit.  A row is
// evaluated in division d iff it matched every earlier division.  Outputs
// survive[b, r] and evals[b, r], both int32, row-major (B, R).
//
// Banked entry (dt2cam_tcam_match_banked) replaces the forest's launch of the
// same TPU kernel, src/repro/kernels/banked.py `tcam_match_banked` (engine
// "mxu": `jax.vmap(tcam_match_pallas)`, one pallas_call over G same-shape
// banks).  blockIdx.z is the bank: each block offsets every operand by its
// bank's slab (x by g*B*W, the planes by g*R*W, kmax by g*R*D, the outputs
// by g*B*R; all in size_t, since G*B*R passes 2^31 at forest scale).  The
// single-bank entry is the G = 1 launch of the same kernels.  Stacking pad
// rows carry kmax = -1 and die in division 0 with evals 1; pad divisions
// are all-don't-care and match.  Evals are not clamped to a bank's real
// division count: the caller does that.
//
// What bounds it on this card: bytes.  The two (B, R) int32 outputs are
// 8 bytes per (b, r) pair, 825 MB at the Give Me Some Credit layout
// (B = 12027, R = 8576), against 43 MB per uint8 plane; the arithmetic per
// evaluated division is a few integer operations per 4 cells, and almost
// every row of a decision-tree TCAM fails its first or second division.
//
// What the design does about it:
//  * The planes and search words are uint8 {0,1}, not the TPU path's f32:
//    4x fewer bytes.  Four cells share one 32-bit word, and one
//    __popc((x & is0) | (~x & is1)) counts their mismatches.
//  * The TPU kernel keeps the precharge carry in a revisited output block
//    across a sequential grid axis.  Blocks on this card run in no order, so
//    the division loop is inside the thread: one thread owns one row r and
//    walks the divisions for each search word of its block's batch tile.
//  * The thread stops at its first mismatching division.  That is exact:
//    after it the row is inactive, evals stops growing and survive stays 0.
//    A TPU cannot branch per element; here it removes nearly all the work,
//    leaving the output stores, which are coalesced (consecutive threads own
//    consecutive rows r of one output row b).
//  * Division 0, which every pair evaluates, keeps its plane bytes in
//    registers for the whole batch tile (S = 128: 16 uint4).  Search words
//    are read with 16-byte loads that every thread of a warp shares.
//  * kmax = -1 never matches (mism >= 0); a fully masked division has
//    kmax = S and always matches.  Ragged B and R edges are masked here, so
//    the caller pads nothing.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 128;   // threads per block, one TCAM row each
constexpr int kBatchPerBlock = 32;   // search words walked by each thread

// Bytes of x, a and b are 0 or 1: counts the bytes where (x ? a : b) is 1.
__device__ __forceinline__ int sel_popc(uint32_t x, uint32_t a, uint32_t b) {
  return __popc((x & a) | ((x ^ 0x01010101u) & b));
}

__device__ __forceinline__ int sel_popc4(const uint4& x, const uint4& a,
                                         const uint4& b) {
  return sel_popc(x.x, a.x, b.x) + sel_popc(x.y, a.y, b.y) +
         sel_popc(x.z, a.z, b.z) + sel_popc(x.w, a.w, b.w);
}

__device__ __forceinline__ uint4 ldg16(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// S (a multiple of 16) known at compile time; rows 16-byte aligned.
template <int S>
__global__ void __launch_bounds__(kRowsPerBlock)
tcam_match_kernel(const uint8_t* __restrict__ x,
                  const uint8_t* __restrict__ is0,
                  const uint8_t* __restrict__ is1,
                  const int32_t* __restrict__ kmax,
                  int32_t* __restrict__ survive, int32_t* __restrict__ evals,
                  int B, int R, int W, int D) {
  constexpr int kChunks = S / 16;
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * kBatchPerBlock;
  const int nb = min(kBatchPerBlock, B - b0);
  const size_t g = blockIdx.z;
  x += g * B * W;
  survive += g * B * R;
  evals += g * B * R;
  const size_t row = g * R + r;
  const uint8_t* p0 = is0 + row * W;
  const uint8_t* p1 = is1 + row * W;
  const int32_t* kr = kmax + row * D;

  uint4 a0[kChunks], c0[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    a0[c] = ldg16(p0 + 16 * c);
    c0[c] = ldg16(p1 + 16 * c);
  }
  const int k0 = __ldg(kr);

  for (int i = 0; i < nb; ++i) {
    const uint8_t* xb = x + static_cast<size_t>(b0 + i) * W;
    int m = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) m += sel_popc4(ldg16(xb + 16 * c), a0[c], c0[c]);
    int ev = 1;
    bool alive = m <= k0;
    for (int d = 1; alive && d < D; ++d) {
      const int off = d * S;
      m = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int o = off + 16 * c;
        m += sel_popc4(ldg16(xb + o), ldg16(p0 + o), ldg16(p1 + o));
      }
      ++ev;
      alive = m <= __ldg(kr + d);
    }
    const size_t o = static_cast<size_t>(b0 + i) * R + r;
    survive[o] = alive ? 1 : 0;
    evals[o] = ev;
  }
}

// Any division width or alignment: one byte per cell.
__global__ void __launch_bounds__(kRowsPerBlock)
tcam_match_kernel_any(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ is0,
                      const uint8_t* __restrict__ is1,
                      const int32_t* __restrict__ kmax,
                      int32_t* __restrict__ survive,
                      int32_t* __restrict__ evals, int B, int R, int W, int S) {
  const int r = blockIdx.x * kRowsPerBlock + threadIdx.x;
  if (r >= R) return;
  const int D = W / S;
  const int b0 = blockIdx.y * kBatchPerBlock;
  const int nb = min(kBatchPerBlock, B - b0);
  const size_t g = blockIdx.z;
  x += g * B * W;
  survive += g * B * R;
  evals += g * B * R;
  const size_t row = g * R + r;
  const uint8_t* p0 = is0 + row * W;
  const uint8_t* p1 = is1 + row * W;
  const int32_t* kr = kmax + row * D;
  for (int i = 0; i < nb; ++i) {
    const uint8_t* xb = x + static_cast<size_t>(b0 + i) * W;
    int ev = 0;
    bool alive = true;
    for (int d = 0; alive && d < D; ++d) {
      int m = 0;
      for (int c = d * S; c < (d + 1) * S; ++c)
        m += __ldg(xb + c) ? __ldg(p0 + c) : __ldg(p1 + c);
      ++ev;
      alive = m <= __ldg(kr + d);
    }
    const size_t o = static_cast<size_t>(b0 + i) * R + r;
    survive[o] = alive ? 1 : 0;
    evals[o] = ev;
  }
}

template <int S>
void launch(dim3 grid, cudaStream_t stream, const uint8_t* x,
            const uint8_t* is0, const uint8_t* is1, const int32_t* kmax,
            int32_t* survive, int32_t* evals, int B, int R, int W) {
  tcam_match_kernel<S><<<grid, kRowsPerBlock, 0, stream>>>(
      x, is0, is1, kmax, survive, evals, B, R, W, W / S);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// G banks of the same shape: x (G, B, W) and is0, is1 (G, R, W) uint8 in
// {0,1}; kmax (G, R, W/S) int32; survive and evals (G, B, R) int32 outputs.
// All row-major and contiguous.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dt2cam_tcam_match_banked(const void* x, const void* is0,
                                        const void* is1, const void* kmax,
                                        void* survive, void* evals, int G,
                                        int B, int R, int W, int S,
                                        void* stream) {
  if (G <= 0 || B <= 0 || R <= 0) return 0;
  if (S <= 0 || W <= 0 || W % S != 0) return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock,
                  (B + kBatchPerBlock - 1) / kBatchPerBlock, G);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* xb = static_cast<const uint8_t*>(x);
  auto* p0 = static_cast<const uint8_t*>(is0);
  auto* p1 = static_cast<const uint8_t*>(is1);
  auto* km = static_cast<const int32_t*>(kmax);
  auto* sv = static_cast<int32_t*>(survive);
  auto* ev = static_cast<int32_t*>(evals);
  // Every bank slab starts a multiple of W bytes past an aligned base, so
  // W % 16 == 0 keeps each slab's rows 16-byte aligned too.
  const bool vec = W % 16 == 0 && aligned16(x) && aligned16(is0) && aligned16(is1);
  switch (vec ? S : 0) {
    case 16: launch<16>(grid, s, xb, p0, p1, km, sv, ev, B, R, W); break;
    case 32: launch<32>(grid, s, xb, p0, p1, km, sv, ev, B, R, W); break;
    case 64: launch<64>(grid, s, xb, p0, p1, km, sv, ev, B, R, W); break;
    case 128: launch<128>(grid, s, xb, p0, p1, km, sv, ev, B, R, W); break;
    default:
      tcam_match_kernel_any<<<grid, kRowsPerBlock, 0, s>>>(xb, p0, p1, km, sv,
                                                          ev, B, R, W, S);
  }
  return static_cast<int>(cudaGetLastError());
}

// One bank: x (B, W) and is0, is1 (R, W) uint8 in {0,1}; kmax (R, W/S)
// int32; survive and evals (B, R) int32 outputs.  The G = 1 launch of the
// banked entry.
extern "C" int dt2cam_tcam_match(const void* x, const void* is0,
                                 const void* is1, const void* kmax,
                                 void* survive, void* evals, int B, int R,
                                 int W, int S, void* stream) {
  return dt2cam_tcam_match_banked(x, is0, is1, kmax, survive, evals, 1, B, R,
                                  W, S, stream);
}

extern "C" const char* dt2cam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
