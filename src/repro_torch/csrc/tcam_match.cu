// Bitplane ternary CAM match with selective precharge, for sm_90a, on
// bit-packed, division-major operands.
//
// Replaces: src/repro/kernels/tcam_match.py:38, `_kernel` launched by
// `tcam_match_pallas` (the Pallas TPU kernel behind engine "mxu"), and the
// forest's launch of the same kernel over a bank axis,
// src/repro/kernels/banked.py `tcam_match_banked(engine="mxu")`
// (`jax.vmap(tcam_match_pallas)`).  blockIdx.z is the bank; the single-bank
// call is the G = 1 launch.
//
// Computes, for every bank g, search word b and TCAM row r, walking the
// column divisions d = 0..D-1 of width S in order:
//     mism  = sum over the division's cells of (x ? is0 : is1)
//     match = mism <= kmax[r, d]
// which is the TPU kernel's X·is0ᵀ + (1-X)·is1ᵀ for x in {0,1}.  A CELL_MM
// cell sets both planes and so mismatches either input bit; kmax = -1 never
// matches and kmax = S always does.  A row is evaluated in division d iff
// it matched every earlier division.  Outputs survive[g, b, r] and
// evals[g, b, r] (divisions evaluated, unclamped), int32, row-major.
//
// Operands (made by the two pack entries below, whose plain versions are
// repro_torch/kernels/ref.py `pack_words` and `pack_planes`):
//   planes (G, D, R, 2·SW) uint32, SW = ceil(S/32): for each (division,
//          row) the SW words of is0 then the SW words of is1, one bit per
//          cell, little-endian as `ref.pack_bits` (bit i of word j = cell
//          32j+i of the division); a division narrower than SW·32 cells is
//          zero-padded, and a zero bit in both planes never mismatches;
//   kmax_t (G, D, R) int32, kmax transposed;
//   xw     (G, D, Bp, SW) uint32, the search words packed the same way,
//          Bp = B rounded up to 4 so that every division's slab of words
//          starts 16-byte aligned.
// The mismatch count is then sum popc((x & P0) | (~x & P1)): one LOP3 and
// one POPC per 32 cells, exact for CELL_MM.
//
// What bounds it on this card: the bytes of the two int32 outputs, 8 bytes
// per (g, b, r) pair (825 MB at the Give Me Some Credit tree, 9.85 GB for
// the credit forest's two groups), then the popcounts (one per 32 cells per
// evaluated triple, 16 per clock per SM).  The operands are small beside
// them: the credit tree's planes are 10.7 MB packed and stay in the 50 MB L2.
//
// What the design does about it:
//  * Bit-packed operands, 8x fewer bytes than the uint8 planes they replace
//    and 8x fewer popcounts (one per 32 cells, not per 4).  Division-major
//    planes put one (row, division) in 2·SW consecutive words (one 32-byte
//    sector at S = 128), so a warp's 32 rows read one contiguous 1 KB per
//    division, and a warp's kmax for a division is one 128-byte line.
//  * Divisions in the outer loop over a tile of 128 rows (one thread each)
//    x 64 search words.  The precharge carry is a live bitmask over the
//    tile's words, two registers a thread.  A row's plane words and kmax for
//    a division are loaded once per tile, one division ahead, not once per
//    (word, division).  Division 0, which every pair evaluates, walks the
//    words in step across the warp (shared-memory loads broadcast), eight
//    words per unrolled step; a warp whose rows all have kmax < 0 (the
//    stacking pad rows of a forest group, 45 % of its rows) skips it.
//    Later divisions walk only each thread's live words (__ffs over the
//    mask).  The block leaves the division loop when __syncthreads_or finds
//    no live pair in it; a warp whose pairs are all dead walks nothing.
//  * Search words: each division's words of the tile (Bb x SW x 4 bytes,
//    1 KB at S = 128) are staged in shared memory with cp.async, double
//    buffered, so division d+1 arrives while d is evaluated.  This was
//    taken over loading the whole tile's words at once (39 KB at credit):
//    18 KB of static shared memory a block, and __launch_bounds__(128, 8)
//    holding registers to 64, let eight blocks (32 warps) share an SM, so
//    one block's output stores overlap other blocks' popcounts.  A fully
//    unrolled division 0, or 128-word tiles, needed more registers, fit
//    half as many blocks an SM, and ran slower on the card.
//  * Outputs: each pair's evals is recorded in shared memory (uint16) in
//    the divisions after the first as it is evaluated; survive is the live
//    bit after the loop.  At the end, for each word of the tile, the 128
//    threads write 128 consecutive int32 of survive and of evals: coalesced
//    and streaming (__stcs), so they do not evict the planes from L2.
//  * Offsets into the (G, B, R) outputs and the operands are size_t:
//    G·B·R passes 2^31 at forest scale.
//  * S > 128 (SW > 4) takes match_bits_any, a thread per row walking every
//    word of its tile with no staging: the same operands and results, for
//    division widths the tiled kernel does not unroll.  Every shape of the
//    repo's configurations (S in 16..128) takes the tiled kernel.
//  * The search words are packed per call on the card: where S % 32 == 0
//    and rows are 16-byte aligned by pack_kernel_wide (a 16-byte load per
//    thread, two threads per word), else by pack_kernel (one __ballot_sync
//    per 32 cells).  The planes are packed the same way, once per layout.
//    The packed kernel (tcam_packed.cu) uses the same word pack.
//  * The cp.async staging and row loads are in tcam_tile.cuh, shared with
//    tcam_packed.cu.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tcam_tile.cuh"

namespace {

constexpr int kRows = 128;            // threads per block, one TCAM row each
constexpr int kWords = 64;            // search words per block
constexpr int kMasks = kWords / 32;   // live-mask registers per thread
constexpr int kMinBlocks = 8;         // blocks an SM: at most 64 registers
constexpr int kUnroll0 = 8;           // division-0 words per unrolled step
constexpr int kMaxTiledSW = 4;        // S <= 128 takes the tiled kernel

// Mismatches of one search word's division against one row's planes.
template <int SW>
__device__ __forceinline__ int mismatches(const uint32_t (&x)[SW],
                                          const uint32_t (&p)[2 * SW]) {
  int m = 0;
#pragma unroll
  for (int k = 0; k < SW; ++k) m += __popc((x[k] & p[k]) | (~x[k] & p[SW + k]));
  return m;
}

template <int SW>
__global__ void __launch_bounds__(kRows, kMinBlocks)
match_bits_kernel(const uint32_t* __restrict__ xw,       // (G, D, Bp, SW)
                  const uint32_t* __restrict__ planes,   // (G, D, R, 2SW)
                  const int32_t* __restrict__ kt,        // (G, D, R)
                  int32_t* __restrict__ survive,         // (G, B, R)
                  int32_t* __restrict__ evals,           // (G, B, R)
                  int B, int Bp, int R, int D) {
  __shared__ __align__(16) uint32_t xs[2][kWords * SW];
  __shared__ uint16_t ev[kWords][kRows];

  const int t = threadIdx.x;
  const int r = blockIdx.x * kRows + t;
  const bool row_ok = r < R;
  const int b0 = blockIdx.y * kWords;
  const int nb = min(kWords, B - b0);
  const int chunks = min(kWords, Bp - b0) * SW / 4;   // 16-byte copies
  const size_t g = blockIdx.z;
  const size_t x_div = static_cast<size_t>(Bp) * SW;  // words per division
  const size_t p_div = static_cast<size_t>(R) * 2 * SW;
  const uint32_t* xg = xw + g * D * x_div + static_cast<size_t>(b0) * SW;
  const uint32_t* pg = planes + g * D * p_div + static_cast<size_t>(r) * 2 * SW;
  const int32_t* kg = kt + g * D * R + r;

  stage<kRows>(xs[0], xg, chunks);
  stage<kRows>(xs[1], xg + x_div, D > 1 ? chunks : 0);
  uint32_t cur[2 * SW], nxt[2 * SW];
#pragma unroll
  for (int w = 0; w < 2 * SW; ++w) cur[w] = nxt[w] = 0;
  int kmax = -1, knxt = -1;   // rows past R never match
  if (row_ok) {
    load_row<SW>(cur, pg);
    kmax = __ldg(kg);
    if (D > 1) {
      load_row<SW>(nxt, pg + p_div);
      knxt = __ldg(kg + R);
    }
  }
  cp_async_wait<1>();
  __syncthreads();

  // Division 0: every pair is evaluated; the warp walks the words in step.
  // A warp whose rows all have kmax < 0 (stacking pad rows, past R) cannot
  // match and skips the popcounts.
  uint32_t live[kMasks], live0[kMasks];
  const bool warp_can_match = __any_sync(0xffffffffu, kmax >= 0);
#pragma unroll
  for (int c = 0; c < kMasks; ++c) {
    uint32_t m = 0;
    if (warp_can_match) {
#pragma unroll kUnroll0
      for (int j = 0; j < 32; ++j) {
        uint32_t x[SW];
        load_words<SW>(x, &xs[0][(32 * c + j) * SW]);
        m |= static_cast<uint32_t>(mismatches<SW>(x, cur) <= kmax) << j;
      }
    }
    live[c] = live0[c] = m & tile_bits(c, nb);
  }

  for (int d = 1; d < D; ++d) {
    bool any = false;
#pragma unroll
    for (int c = 0; c < kMasks; ++c) any |= live[c] != 0;
    // Every thread is done with division d-1, so xs[(d+1) & 1] is free.
    if (!__syncthreads_or(any)) break;
    stage<kRows>(xs[(d + 1) & 1], xg + static_cast<size_t>(d + 1) * x_div,
                 d + 1 < D ? chunks : 0);
#pragma unroll
    for (int w = 0; w < 2 * SW; ++w) cur[w] = nxt[w];
    kmax = knxt;
    if (row_ok && d + 1 < D) {
      load_row<SW>(nxt, pg + static_cast<size_t>(d + 1) * p_div);
      knxt = __ldg(kg + static_cast<size_t>(d + 1) * R);
    }
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t* xd = xs[d & 1];
#pragma unroll
    for (int c = 0; c < kMasks; ++c) {
      uint32_t todo = live[c];
      while (todo) {
        const int j = __ffs(todo) - 1;
        todo &= todo - 1;
        const int i = 32 * c + j;
        uint32_t x[SW];
        load_words<SW>(x, xd + i * SW);
        if (mismatches<SW>(x, cur) > kmax) live[c] &= ~(1u << j);
        ev[i][t] = static_cast<uint16_t>(d + 1);
      }
    }
  }
  cp_async_wait<0>();   // no copy may land after the block has left
  if (!row_ok) return;

  // A pair dead after division 0 was evaluated once; one alive after it was
  // evaluated in every division up to the one recorded in ev.
  const size_t o = (g * B + b0) * static_cast<size_t>(R) + r;
#pragma unroll
  for (int c = 0; c < kMasks; ++c) {
    for (int j = 0; j < 32; ++j) {
      const int i = 32 * c + j;
      if (i >= nb) break;
      const size_t oi = o + static_cast<size_t>(i) * R;
      const bool past0 = D > 1 && ((live0[c] >> j) & 1u);
      __stcs(survive + oi, static_cast<int32_t>((live[c] >> j) & 1u));
      __stcs(evals + oi, past0 ? static_cast<int32_t>(ev[i][t]) : 1);
    }
  }
}

// Any division width: a thread per row walks each word of its tile through
// the divisions, reading the packed operands from global memory.
__global__ void __launch_bounds__(kRows)
match_bits_any(const uint32_t* __restrict__ xw,
               const uint32_t* __restrict__ planes,
               const int32_t* __restrict__ kt, int32_t* __restrict__ survive,
               int32_t* __restrict__ evals, int B, int Bp, int R, int D,
               int SW) {
  const int r = blockIdx.x * kRows + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * kWords;
  const int nb = min(kWords, B - b0);
  const size_t g = blockIdx.z;
  for (int i = 0; i < nb; ++i) {
    const int b = b0 + i;
    int ev = 0;
    bool alive = true;
    for (int d = 0; alive && d < D; ++d) {
      const size_t gd = g * D + d;
      const uint32_t* x = xw + (gd * Bp + b) * SW;
      const uint32_t* p = planes + (gd * R + r) * 2 * SW;
      int m = 0;
      for (int k = 0; k < SW; ++k)
        m += __popc((__ldg(x + k) & __ldg(p + k)) |
                    (~__ldg(x + k) & __ldg(p + SW + k)));
      ++ev;
      alive = m <= __ldg(kt + gd * R + r);
    }
    const size_t o = (g * B + b) * static_cast<size_t>(R) + r;
    __stcs(survive + o, alive ? 1 : 0);
    __stcs(evals + o, ev);
  }
}

// Packs rows of {0,1} bytes at one bit per cell, division by division: one
// warp per (row, division, bank) = (blockIdx.x·8 + warp, blockIdx.y,
// blockIdx.z), one __ballot_sync per 32 cells (lane l holds cell 32k+l of
// the division, which lands at bit l of word k).  Reads G banks of `rows`
// rows of W bytes from a (and b, when not null); writes out (G, D,
// rows_pad, np·SW) with np = 2 when b is given, a's words before b's.
// Rows from `rows` to rows_pad are zero.
constexpr int kPackWarps = 8;   // warps (rows) per block of the pack kernel

__global__ void __launch_bounds__(32 * kPackWarps)
pack_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
            uint32_t* __restrict__ out, int rows, int rows_pad, int W, int S,
            int SW) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPackWarps + (threadIdx.x >> 5);
  if (row >= rows_pad) return;   // whole warps leave together
  const int d = blockIdx.y;
  const size_t g = blockIdx.z;
  const bool real = row < rows;
  const size_t src = (g * rows + row) * static_cast<size_t>(W) +
                     static_cast<size_t>(d) * S;
  const int np = b ? 2 : 1;
  const int nq = np * SW;
  // Word q = p·SW + k lands in lane q % 32; every 32 words (or the last
  // few) are stored together, coalesced.
  uint32_t* dst = out + ((g * gridDim.y + d) * rows_pad + row) * nq;
  uint32_t mine = 0;
  for (int p = 0, q = 0; p < np; ++p) {
    const uint8_t* cells = (p ? b : a) + src;
#pragma unroll 4
    for (int k = 0; k < SW; ++k, ++q) {
      const int c = 32 * k + lane;
      const uint32_t word =
          __ballot_sync(0xffffffffu, real && c < S && cells[c] != 0);
      if (lane == (q & 31)) mine = word;
      if ((q & 31) == 31 || q == nq - 1) {
        if (lane <= (q & 31)) dst[(q & ~31) + lane] = mine;
      }
    }
  }
}

// Four {0,1} bytes -> four bits, byte i to bit i: the multiplier moves
// byte i's bit to bit 24 + i, and no two partial products meet below bit 28.
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  return ((v & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t half_word(const uint4& v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

// The same packing where S % 32 == 0 and rows are 16-byte aligned: a thread
// per 16 cells of a row (one 16-byte load), two neighbouring threads per
// word.  blockIdx.z is the bank; threads past rows_pad·W/16 load and store
// nothing but take part in the shuffle.
__global__ void __launch_bounds__(256)
pack_kernel_wide(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                 uint32_t* __restrict__ out, int rows, int rows_pad, int W,
                 int S, int D) {
  const unsigned per_row = W / 16;
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < static_cast<unsigned>(rows_pad) * per_row;
  const int row = in ? i / per_row : 0;
  const int h = i - row * per_row;   // 16-cell group within the row
  const size_t g = blockIdx.z;
  const int SW = S / 32;
  const int np = b ? 2 : 1;
  const size_t at = (g * rows + row) * static_cast<size_t>(W) + 16 * h;
  const int j = h / 2;               // word within the row
  const int d = j / SW;
  uint32_t* dst = out + ((g * D + d) * rows_pad + row) * (np * SW) + (j - d * SW);
  for (int p = 0; p < np; ++p) {
    uint32_t half = 0;
    if (in && row < rows)
      half = half_word(__ldg(reinterpret_cast<const uint4*>((p ? b : a) + at)));
    // W/16 is even, so the two halves of a word sit in lanes 2m, 2m+1.
    const uint32_t high = __shfl_down_sync(0xffffffffu, half, 1);
    if (in && (h & 1) == 0) dst[p * SW] = half | high << 16;
  }
}

template <int SW>
void launch_tiled(dim3 grid, cudaStream_t stream, const uint32_t* xw,
                  const uint32_t* planes, const int32_t* kt, int32_t* sv,
                  int32_t* ev, int B, int Bp, int R, int D) {
  match_bits_kernel<SW><<<grid, kRows, 0, stream>>>(xw, planes, kt, sv, ev, B,
                                                    Bp, R, D);
}

int launch_pack(const void* a, const void* b, void* out, int G, int rows,
                int rows_pad, int W, int S, void* stream) {
  if (G <= 0 || rows_pad <= 0 || W <= 0) return 0;
  if (S <= 0 || W % S != 0 || rows > rows_pad) return cudaErrorInvalidValue;
  const int D = W / S;
  const int SW = (S + 31) / 32;
  if (G > 65535 || D > 65535) return cudaErrorInvalidConfiguration;
  const size_t groups = static_cast<size_t>(rows_pad) * (W / 16);
  if (S % 32 == 0 && aligned16(a) && (b == nullptr || aligned16(b)) &&
      groups < (1u << 31)) {
    const dim3 grid(static_cast<unsigned>((groups + 255) / 256), 1, G);
    pack_kernel_wide<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
        static_cast<uint32_t*>(out), rows, rows_pad, W, S, D);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((rows_pad + kPackWarps - 1) / kPackWarps, D, G);
  pack_kernel<<<grid, 32 * kPackWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<uint32_t*>(out), rows, rows_pad, W, S, SW);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Search words x (G, B, W) uint8 {0,1} -> xw (G, W/S, Bp, SW) uint32;
// rows B..Bp-1 are zero.
extern "C" int dt2cam_pack_words(const void* x, void* xw, int G, int B,
                                 int Bp, int W, int S, void* stream) {
  return launch_pack(x, nullptr, xw, G, B, Bp, W, S, stream);
}

// Planes is0, is1 (G, R, W) uint8 {0,1} -> (G, W/S, R, 2·SW) uint32.
extern "C" int dt2cam_pack_planes(const void* is0, const void* is1,
                                  void* planes, int G, int R, int W, int S,
                                  void* stream) {
  return launch_pack(is0, is1, planes, G, R, R, W, S, stream);
}

// The match over G banks (grid axis z) on packed operands: xw (G, D, Bp,
// SW), planes (G, D, R, 2·SW) uint32, kmax_t (G, D, R) int32; survive and
// evals (G, B, R) int32 outputs.  All contiguous.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int dt2cam_tcam_match_bits(const void* xw, const void* planes,
                                      const void* kmax_t, void* survive,
                                      void* evals, int G, int B, int Bp,
                                      int R, int D, int S, void* stream) {
  if (G <= 0 || B <= 0 || R <= 0) return 0;
  if (S <= 0 || D <= 0 || D > 65535 || Bp < B || Bp % 4 != 0)
    return cudaErrorInvalidValue;
  if (!aligned16(xw) || !aligned16(planes)) return cudaErrorMisalignedAddress;
  const dim3 grid((R + kRows - 1) / kRows, (B + kWords - 1) / kWords, G);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const uint32_t*>(xw);
  auto* p = static_cast<const uint32_t*>(planes);
  auto* k = static_cast<const int32_t*>(kmax_t);
  auto* sv = static_cast<int32_t*>(survive);
  auto* ev = static_cast<int32_t*>(evals);
  const int SW = (S + 31) / 32;
  switch (SW) {
    case 1: launch_tiled<1>(grid, s, x, p, k, sv, ev, B, Bp, R, D); break;
    case 2: launch_tiled<2>(grid, s, x, p, k, sv, ev, B, Bp, R, D); break;
    case 3: launch_tiled<3>(grid, s, x, p, k, sv, ev, B, Bp, R, D); break;
    case 4: launch_tiled<4>(grid, s, x, p, k, sv, ev, B, Bp, R, D); break;
    default:
      match_bits_any<<<grid, kRows, 0, s>>>(x, p, k, sv, ev, B, Bp, R, D, SW);
  }
  return static_cast<int>(cudaGetLastError());
}

// Which kernel dt2cam_tcam_match_bits launches for division width S:
// 1 for the tiled kernel, 0 for match_bits_any.
extern "C" int dt2cam_match_bits_tiled(int S) {
  return (S + 31) / 32 <= kMaxTiledSW ? 1 : 0;
}

extern "C" const char* dt2cam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
