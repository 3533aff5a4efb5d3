// Bit-packed ternary CAM match with selective precharge, for sm_90a, on
// division-major operands packed on the card.
//
// Replaces: src/repro/kernels/tcam_packed.py:30, `_kernel` launched by
// `tcam_match_packed_pallas` (the Pallas TPU kernel behind engine
// "packed", which select_engine("auto") picks on every ideal layout with
// S % 32 == 0).
//
// Computes, for every search word b and TCAM row r, walking the column
// divisions d = 0..D-1 of width S = 32·SW bits in order:
//     mism  = sum over the division's SW words of popc((x ^ val) & care)
//     match = mism <= kmax[r, d]
// with val = pack(is1) and care = pack(is0 | is1), the TPU kernel's
// formulation (the engine needs S % 32 == 0 and no CELL_MM cell).  A row
// is evaluated in division d iff it matched every earlier division.
// Outputs survive[b, r] (matched all D divisions) and evals[b, r]
// (divisions evaluated), int32, row-major (B, R).
//
// Operands:
//   vc     (D, R, 2·SW) uint32: for each (division, row) val's SW words
//          then care's, packed once per layout by dt2cam_pack_planes
//          (tcam_match.cu) from is1 and is0 | is1;
//   kmax_t (D, R) int32, kmax transposed;
//   xw     (D, Bp, SW) uint32, the search words, packed per call on the
//          card by dt2cam_pack_words (tcam_match.cu); Bp = B rounded up to
//          4, so that each division's slab of words starts 16-byte aligned;
//   same   (D, ceil(B/64), 64) uint64 scratch, made per call by
//          word_classes below: for each word of a tile, the tile's words
//          equal to it in that division.
//
// What bounds it on this card: the bytes of the two int32 outputs (8 per
// (b, r) pair, 825 MB at the Give Me Some Credit tree: 0.25 ms at
// 3.35 TB/s); the logic work is one LOP3 per word and evaluated (word,
// row, division) triple, 0.15 ms for the 625 M triples of the credit tree
// on ideal hardware.  What the kernel it replaces lost its time to was
// neither: it refetched each row's division words for every search word,
// with warp loads 32 sectors wide, and popcounted every word.  On the
// credit tree a (word, row) pair lives 6.06 divisions on ideal hardware
// and 4.53 under SA offsets (sigma 0.08), so the later divisions carry
// most of the work and cannot be treated as rare.  In this kernel the time
// beyond the output stores goes to the serial walk over each division's
// words and to recording where pairs die.
//
// What the design does about it (figures of the credit tree counted on the
// host by tools/packed_walk_stats.py; times on the card by chip_smoke.py
// and tools/packed_bench.py, in PERF.md):
//  * Divisions in the outer loop over a tile of 128 rows (one thread
//    each) x 64 search words, as tcam_match.cu.  The precharge carry is a
//    64-bit live mask over the tile's words.  A row's 2·SW words (one
//    32-byte sector at S = 128) and kmax are loaded once per division and
//    tile, one division ahead, so a warp's 32 rows read one contiguous
//    1 KB.  Each division's search words of the tile are staged in shared
//    memory by cp.async, double buffered.  The block leaves the loop when
//    __syncthreads_or finds no live pair in it.  (Warps walking on alone,
//    with no barrier and the words read through L1, were no faster.)
//  * Equal words are tested once.  A tile's 64 words take 15.4 distinct
//    values per division on average (a division covers a few encoded
//    features, and queries share their intervals), so word_classes, a
//    small kernel launched first, records for each (division, tile, word)
//    the mask of the tile's words equal to it.  The walk tests one word of
//    a class and applies the result to the whole class.  That cut the
//    later divisions' walk 4x (1.58 M against 6.08 M warp steps over 48
//    tiles, ideal) and the main-path call from 1.8 to 1.3 ms.
//  * The test of a row in a division is chosen from its kmax and its care
//    words, once per division and tile:
//      kmax < 0         never matches: every live pair dies, no word loads;
//      kmax >= S, or kmax >= 0 on a division without a cared cell
//                       always matches: no word loads;
//      kmax = 0         OR over the words of (x ^ val) & care == 0: no
//                       popcount;
//      otherwise        sum of __popc(...) <= kmax.
//    The last two are chosen per warp and division: the popcount sum is
//    exact for every row, so a warp takes it when one of its testing rows
//    with a live pair has kmax > 0, else the OR test.  No result changes.
//    On the credit tree (SA kmax as chip_smoke.py phase 4 draws it):
//    27.4 % of (row, division) cells are all don't-care; kmax is -1 in
//    7.4 %, 0 in 85.2 % and > 0 in 7.4 %; 25.4 % of cells always match and
//    5.4 % need the popcount sum, which still puts 73.7 % of (warp,
//    division) pairs on it before liveness is counted.  On ideal hardware
//    (the main path) kmax is 0 everywhere and no popcount is issued.
//  * The walk over a later division: each thread tests the classes of its
//    own live words, the slowest lane setting the warp's count (1.58 /
//    1.43 M warp steps, ideal / SA).  Two other walks were timed on the
//    card and dropped: in step over the classes of the union of the warp's
//    live words (1.69 / 1.51 M steps, broadcast loads, no divergence) was
//    a few per cent slower, and in step over every class of the tile
//    (4.82 / 3.76 M) about 1.5x slower.  Division 0 tests every class of
//    the tile in step.
//  * Masks are walked 32 bits at a time: 64-bit find-first-set costs
//    several times the 32-bit one, and walking the halves took the
//    main-path call from 1.3 to 0.9 ms, most of it in the loop that
//    records deaths.
//  * Evals: a pair that dies after division 0 records d + 1 in shared
//    memory (uint16) where it dies; one alive at the end walked every
//    division (the block leaves early only when no pair is alive); one
//    dead in division 0 was evaluated once.
//  * Outputs: for each word of the tile, the 128 threads write 128
//    consecutive int32 of survive and of evals: coalesced and streaming
//    (__stcs), so they do not evict the operands from L2.
//  * Offsets are size_t.  Ragged B and R edges are masked here, so the
//    caller pads nothing beyond Bp.
//  * S > 128 (SW > 4) takes packed_bits_any, a thread per row walking each
//    word of its tile through the divisions from global memory, on the
//    same operands.  Every shape of the repo's configurations (S in
//    32..128 on this engine) takes the tiled kernel.
//  * The cp.async staging and row loads are shared with tcam_match.cu
//    (tcam_tile.cuh).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tcam_tile.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kRows = 128;            // threads per block, one TCAM row each
constexpr int kWords = 64;            // search words per block (one u64 mask)
constexpr int kMinBlocks = 8;         // blocks an SM: at most 64 registers
constexpr int kMaxTiledSW = 4;        // S <= 128 takes the tiled kernel
constexpr unsigned kAll = 0xffffffffu;

// Whether one search word's division matches one row: the popcount sum
// against kmax (kPopc), or no mismatching cell at all (kmax = 0).
template <int SW, bool kPopc>
__device__ __forceinline__ bool matches(const uint32_t (&x)[SW],
                                        const uint32_t (&vc)[2 * SW],
                                        int kmax) {
  if constexpr (kPopc) {
    int m = 0;
#pragma unroll
    for (int k = 0; k < SW; ++k) m += __popc((x[k] ^ vc[k]) & vc[SW + k]);
    return m <= kmax;
  } else {
    uint32_t o = 0;
#pragma unroll
    for (int k = 0; k < SW; ++k) o |= (x[k] ^ vc[k]) & vc[SW + k];
    return o == 0;
  }
}

// Whether a row with this kmax matches every word in a division whatever
// the words: kmax >= S, or kmax >= 0 on a division without a cared cell.
template <int SW>
__device__ __forceinline__ bool always_matches(const uint32_t (&vc)[2 * SW],
                                               int kmax) {
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < SW; ++k) c |= vc[SW + k];
  return kmax >= 32 * SW || (kmax >= 0 && c == 0);
}

__device__ __forceinline__ u64 tile_mask(int nb) {
  return nb >= kWords ? ~0ull : (1ull << nb) - 1;
}

// Equal search words: for each division and tile of kWords words,
// same[w] = the words of the tile equal to word w in that division (w
// itself included; 0 past the tile's last word).  One thread per word.
template <int SW>
__global__ void __launch_bounds__(kWords)
word_classes(const uint32_t* __restrict__ xw, u64* __restrict__ same, int B,
             int Bp) {
  __shared__ uint32_t xs[kWords * SW];
  const int w = threadIdx.x;
  const int b0 = blockIdx.x * kWords;
  const int nb = min(kWords, B - b0);
  const uint32_t* xd =
      xw + (static_cast<size_t>(blockIdx.y) * Bp + b0) * SW;
  uint32_t mine[SW];
#pragma unroll
  for (int k = 0; k < SW; ++k) {
    mine[k] = w < nb ? __ldg(xd + w * SW + k) : 0u;
    xs[w * SW + k] = mine[k];
  }
  __syncthreads();
  u64 m = 0;
  if (w < nb) {
    for (int v = 0; v < nb; ++v) {
      uint32_t diff = 0;
#pragma unroll
      for (int k = 0; k < SW; ++k) diff |= xs[v * SW + k] ^ mine[k];
      m |= static_cast<u64>(diff == 0) << v;
    }
  }
  same[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kWords +
       w] = m;
}

// Test the classes of equal words that cover `todo`, one word each; returns
// the words of the classes that mismatch this row.  The walk runs over the
// two 32-bit halves of the mask: 64-bit find-first-set costs several times
// the 32-bit one on this card.
template <int SW, bool kPopc>
__device__ __forceinline__ u64 failing(u64 todo, const uint32_t* xd,
                                       const u64* same,
                                       const uint32_t (&vc)[2 * SW],
                                       int kmax) {
  u64 fail = 0;
  uint32_t lo = static_cast<uint32_t>(todo);
  uint32_t hi = static_cast<uint32_t>(todo >> 32);
  while (lo | hi) {
    const int w = lo ? __ffs(lo) - 1 : 31 + __ffs(hi);
    const u64 cls = same[w];
    lo &= ~static_cast<uint32_t>(cls);
    hi &= ~static_cast<uint32_t>(cls >> 32);
    uint32_t x[SW];
    load_words<SW>(x, xd + w * SW);
    if (!matches<SW, kPopc>(x, vc, kmax)) fail |= cls;
  }
  return fail;
}

template <int SW>
__device__ __forceinline__ u64 failing(bool popc, u64 todo, const uint32_t* xd,
                                       const u64* same,
                                       const uint32_t (&vc)[2 * SW],
                                       int kmax) {
  return popc ? failing<SW, true>(todo, xd, same, vc, kmax)
              : failing<SW, false>(todo, xd, same, vc, kmax);
}

template <int SW>
__global__ void __launch_bounds__(kRows, kMinBlocks)
packed_bits_kernel(const uint32_t* __restrict__ xw,   // (D, Bp, SW)
                   const uint32_t* __restrict__ vc,   // (D, R, 2SW)
                   const int32_t* __restrict__ kt,    // (D, R)
                   const u64* __restrict__ same,      // (D, tiles, kWords)
                   int32_t* __restrict__ survive,     // (B, R)
                   int32_t* __restrict__ evals,       // (B, R)
                   int B, int Bp, int R, int D) {
  __shared__ __align__(16) uint32_t xs[2][kWords * SW];
  __shared__ __align__(16) u64 cs[2][kWords];
  __shared__ uint16_t ev[kWords][kRows];

  const int t = threadIdx.x;
  const int r = blockIdx.x * kRows + t;
  const bool row_ok = r < R;
  const int b0 = blockIdx.y * kWords;
  const int nb = min(kWords, B - b0);
  const u64 all = tile_mask(nb);
  const int chunks = min(kWords, Bp - b0) * SW / 4;   // 16-byte copies
  const size_t x_div = static_cast<size_t>(Bp) * SW;  // words per division
  const size_t c_div = static_cast<size_t>(gridDim.y) * kWords;
  const size_t p_div = static_cast<size_t>(R) * 2 * SW;
  const uint32_t* xg = xw + static_cast<size_t>(b0) * SW;
  const u64* cg = same + static_cast<size_t>(blockIdx.y) * kWords;
  const uint32_t* pg = vc + static_cast<size_t>(r) * 2 * SW;
  const int32_t* kg = kt + r;

  // One division's words and classes of the tile, as one commit group.
  auto stage_division = [&](int buf, int d) {
    if (d < D) {
      for (int c = t; c < chunks; c += kRows)
        cp_async16(xs[buf] + 4 * c, xg + d * x_div + 4 * c);
      if (t < kWords / 2)
        cp_async16(cs[buf] + 2 * t, cg + d * c_div + 2 * t);
    }
    cp_async_commit();
  };

  stage_division(0, 0);
  stage_division(1, 1);
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

  // Division 0: every pair is evaluated.  Rows that never or always match
  // take their masks whole; the others test every class of the tile.
  u64 live, live0;
  {
    const bool always = always_matches<SW>(cur, kmax);
    const bool testing = kmax >= 0 && !always;
    u64 m = always ? all : 0;
    if (__any_sync(kAll, testing)) {
      const bool popc = __any_sync(kAll, testing && kmax > 0);
      const u64 fail = failing<SW>(popc, all, xs[0], cs[0], cur, kmax);
      if (testing) m = all & ~fail;
    }
    live = live0 = m;
  }

  for (int d = 1; d < D; ++d) {
    // Every thread is done with division d-1, so buffer (d+1) & 1 is free.
    if (!__syncthreads_or(live != 0)) break;
    stage_division((d + 1) & 1, d + 1);
#pragma unroll
    for (int w = 0; w < 2 * SW; ++w) cur[w] = nxt[w];
    kmax = knxt;
    if (row_ok && d + 1 < D) {
      load_row<SW>(nxt, pg + static_cast<size_t>(d + 1) * p_div);
      knxt = __ldg(kg + static_cast<size_t>(d + 1) * R);
    }
    cp_async_wait<1>();
    __syncthreads();

    const bool testing =
        live != 0 && kmax >= 0 && !always_matches<SW>(cur, kmax);
    u64 dead = kmax < 0 ? live : 0;   // never matches: every live pair dies
    const u64 todo = testing ? live : 0;
    if (__any_sync(kAll, todo != 0)) {
      const bool popc = __any_sync(kAll, testing && kmax > 0);
      const u64 fail =
          failing<SW>(popc, todo, xs[d & 1], cs[d & 1], cur, kmax);
      if (testing) dead = live & fail;
    }
    for (uint32_t m = static_cast<uint32_t>(dead); m; m &= m - 1)
      ev[__ffs(m) - 1][t] = static_cast<uint16_t>(d + 1);
    for (uint32_t m = static_cast<uint32_t>(dead >> 32); m; m &= m - 1)
      ev[31 + __ffs(m)][t] = static_cast<uint16_t>(d + 1);
    live &= ~dead;
  }
  cp_async_wait<0>();   // no copy may land after the block has left
  if (!row_ok) return;

  // Alive at the end: every division; dead after division 0: the division
  // recorded in ev; dead in division 0: one.
  const size_t o = static_cast<size_t>(b0) * R + r;
#pragma unroll
  for (int c = 0; c < kWords / 32; ++c) {
    const uint32_t alive = static_cast<uint32_t>(live >> (32 * c));
    const uint32_t past0 = static_cast<uint32_t>(live0 >> (32 * c));
    for (int j = 0; j < 32; ++j) {
      const int i = 32 * c + j;
      if (i >= nb) break;
      const size_t oi = o + static_cast<size_t>(i) * R;
      const bool a = (alive >> j) & 1u;
      __stcs(survive + oi, a ? 1 : 0);
      __stcs(evals + oi, a ? D : ((past0 >> j) & 1u
                                      ? static_cast<int32_t>(ev[i][t])
                                      : 1));
    }
  }
}

// Any division width: a thread per row walks each word of its tile through
// the divisions, reading the packed operands from global memory.
__global__ void __launch_bounds__(kRows)
packed_bits_any(const uint32_t* __restrict__ xw,
                const uint32_t* __restrict__ vc,
                const int32_t* __restrict__ kt, int32_t* __restrict__ survive,
                int32_t* __restrict__ evals, int B, int Bp, int R, int D,
                int SW) {
  const int r = blockIdx.x * kRows + threadIdx.x;
  if (r >= R) return;
  const int b0 = blockIdx.y * kWords;
  const int nb = min(kWords, B - b0);
  for (int i = 0; i < nb; ++i) {
    const int b = b0 + i;
    int ev = 0;
    bool alive = true;
    for (int d = 0; alive && d < D; ++d) {
      const uint32_t* x = xw + (static_cast<size_t>(d) * Bp + b) * SW;
      const uint32_t* p = vc + (static_cast<size_t>(d) * R + r) * 2 * SW;
      int m = 0;
      for (int k = 0; k < SW; ++k)
        m += __popc((__ldg(x + k) ^ __ldg(p + k)) & __ldg(p + SW + k));
      ++ev;
      alive = m <= __ldg(kt + static_cast<size_t>(d) * R + r);
    }
    const size_t o = static_cast<size_t>(b) * R + r;
    __stcs(survive + o, alive ? 1 : 0);
    __stcs(evals + o, ev);
  }
}

template <int SW>
int launch_tiled(dim3 grid, cudaStream_t stream, const uint32_t* xw,
                 const uint32_t* vc, const int32_t* kt, u64* same,
                 int32_t* sv, int32_t* ev, int B, int Bp, int R, int D) {
  word_classes<SW><<<dim3(grid.y, D), kWords, 0, stream>>>(xw, same, B, Bp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_bits_kernel<SW><<<grid, kRows, 0, stream>>>(xw, vc, kt, same, sv, ev,
                                                     B, Bp, R, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The packed match: xw (D, Bp, SW), vc (D, R, 2·SW) uint32, kmax_t (D, R)
// int32; `classes` is scratch of D·ceil(B/64)·64 uint64 (the equal-word
// classes, made here by word_classes); survive and evals (B, R) int32
// outputs.  All contiguous, S % 32 == 0.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int dt2cam_tcam_packed_bits(const void* xw, const void* vc,
                                       const void* kmax_t, void* classes,
                                       void* survive, void* evals, int B,
                                       int Bp, int R, int D, int S,
                                       void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (S <= 0 || S % 32 != 0 || D <= 0 || D > 65535 || Bp < B || Bp % 4 != 0)
    return cudaErrorInvalidValue;
  if (!aligned16(xw) || !aligned16(vc) || !aligned16(classes))
    return cudaErrorMisalignedAddress;
  const dim3 grid((R + kRows - 1) / kRows, (B + kWords - 1) / kWords);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  auto* s = static_cast<cudaStream_t>(stream);
  auto* x = static_cast<const uint32_t*>(xw);
  auto* p = static_cast<const uint32_t*>(vc);
  auto* k = static_cast<const int32_t*>(kmax_t);
  auto* c = static_cast<u64*>(classes);
  auto* sv = static_cast<int32_t*>(survive);
  auto* ev = static_cast<int32_t*>(evals);
  switch (S / 32) {
    case 1: return launch_tiled<1>(grid, s, x, p, k, c, sv, ev, B, Bp, R, D);
    case 2: return launch_tiled<2>(grid, s, x, p, k, c, sv, ev, B, Bp, R, D);
    case 3: return launch_tiled<3>(grid, s, x, p, k, c, sv, ev, B, Bp, R, D);
    case 4: return launch_tiled<4>(grid, s, x, p, k, c, sv, ev, B, Bp, R, D);
    default:
      packed_bits_any<<<grid, kRows, 0, s>>>(x, p, k, sv, ev, B, Bp, R, D,
                                             S / 32);
      return static_cast<int>(cudaGetLastError());
  }
}

// Which kernel dt2cam_tcam_packed_bits launches for division width S:
// 1 for the tiled kernel, 0 for packed_bits_any.
extern "C" int dt2cam_packed_bits_tiled(int S) {
  return S / 32 <= kMaxTiledSW ? 1 : 0;
}

extern "C" const char* dt2cam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
