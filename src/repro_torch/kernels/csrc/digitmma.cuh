// Digit products on the int8 tensor cores, with an instance spread over
// a thread-block cluster: the shared routines of mul.cu, step.cu,
// correct.cu and barrett.cu.
//
// Staging, two bytes per limb in shared memory.  The operands arrive as
// int32 limbs (< 2^16) and are packed to 16-bit limbs, which read as
// little-endian 8-bit digits:
//   A layout  digit i of a at byte kAPad + i, zero bytes around it;
//   B layout  digit d of b at byte P - d with P = nb8 + 13 (b reversed),
//             zero bytes around it.
//
// The product as a sliding-window x Toeplitz GEMM (kN = 8 columns):
//   C[r, n] = sum_k a8[r*kN + k] * b8[n - k],  k in [-(nb8 - 1), kN - 1]
// and digit column r*kN + n of the product is C[r, n].  A[r, k] is a
// 4-byte aligned run of the A layout; B[k, n] = b8[n - k] is an
// ascending run of the B layout, read as two aligned words and a funnel
// shift.  One mma.sync.m16n8k32.s32.u8.u8.s32 covers 16 rows x 8
// columns x 32 digits of k (1,024 limb products).  Each row tile's k
// range is clipped to where its window of a is nonzero.  A warp sweeps
// a group of row tiles per B fragment; the heaviest groups start first.
// The s32 sums are exact over 33,025 terms and are flushed into 64-bit
// sums every kKChunk digits of k.
//
// The main loop, in two forms; digit_product picks one for each block
// from its share of the product:
//   pair (sweep_group): kGroup tiles share a B fragment (one tile where a
//     block has no more tiles than warps), and every A word is loaded
//     where it is used: 6 shared loads an mma.
//   deep (sweep_deep): kDeep tiles share a B fragment, and each lane
//     keeps A's Toeplitz repeats in a ring of kRing registers, so that a
//     steady step loads 2 A words and the 4-word B fragment for kDeep
//     mma (1.5 shared loads an mma, kDeep accumulator chains); the tiles'
//     ragged k ends run one step at a time.
// A block takes deep where it holds a group of kDeep tiles for every
// warp and, under a cluster, the product holds two such groups a warp
// for each block (the split by k steps hands the middle blocks fewer
// tiles than the average, and the cluster waits for its slowest block);
// else pairs.  So the long products take deep: the step kernels'
// clustered windows from 2^16 bits, correct_kernel from 2^16 bits, and
// mul_batch_kernel and barrett_kernel from 2^15 bits at cluster 1; at
// 2^15 bits the step and correct products, clipped to the lanes'
// lengths, leave most blocks fewer than kDeep * kWarps tiles.  A block
// that takes deep counts itself in deep_blocks, which the host reads
// with digit_deep_blocks (kernels/digitmma.py deep_blocks); the pair
// loop's blocks, ~10^6 a call at 2^15 bits, count nothing.  Both forms
// fit the kernels' 64 registers a thread at two 512-thread blocks an SM
// (deep spills nothing; one block an SM with 128 registers ran it
// 1.2-1.3x slower).  What bounds them, on an H100 (clock64 in a scratch copy):
// mma.sync.m16n8k32 u8 reaches 0.59 mma a cycle an SM with its operands
// in registers (64% of the int8 peak) and 16% of the peak with 6
// dependent shared loads an mma; the pair loop ran a full-window 2^18
// step block at 0.074 mma a cycle, bound by its shared loads, and the
// deep loop runs it at 0.20, about 69% of a block's half of mma.sync's
// rate.  Past that, the products need wgmma.
// Thread (g, t) of a warp holds C[g, 2t], C[g, 2t + 1] (and row g + 8):
// digit columns 2j and 2j + 1 of limb column j, so it folds them into
// col16[j] = c0 + c1 * 2^8 itself.
//
// The cluster.  Block `rank` of a cluster of cs takes a contiguous range
// of row tiles, balanced by their k steps (split_tiles, the same rule as
// kernels/digitmma.py).  Column sums go to the instance's global
// scratch; after cluster.sync() every block resolves an even share of
// the columns, and the carry chain crosses blocks through each block's
// (generate, propagate) pair, read over distributed shared memory.
// Comparisons and reductions run over the cluster the same way.
//
// A team.  Where an instance is small, a team of warps of one block runs
// it instead (step.cu's packed geometry): team_product deals the same
// tile groups to the team's warps, and one warp resolves the carries
// (warp_resolve) and runs the chains (warp_chain) with ballots, all in
// the team's shared memory.
#pragma once

#include <climits>
#include <map>
#include <mutex>
#include <tuple>
#include <cooperative_groups.h>

#include "limbs.cuh"

namespace digitmma {

namespace cg = cooperative_groups;
using limbs::Digit;
using limbs::kMask;
using limbs::kThreads;
using limbs::kWarps;
using limbs::Shared;

constexpr int kN = 8;            // columns of C per row (n of the mma)
constexpr int kTileRows = 16;    // rows of a tile (m)
constexpr int kKStep = 32;       // digits of k per mma (k)
constexpr int kKChunk = 8192;    // digits of k between s32 flushes
constexpr int kGroup = 2;        // row tiles per B fragment
constexpr int kDeep = 4;         // row tiles per B fragment, deep loop
constexpr int kRing = 4 * kDeep; // A words a lane holds, deep loop
constexpr int kAPad = 160;       // zero bytes on each side of an A operand
constexpr int kBExtra = 80;      // zero bytes around a B operand
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kKChunk <= 33025, "s32 sums of u8 products must stay exact");

__host__ __device__ inline size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t a_bytes(int limbs) {
  return round16(2 * (size_t)limbs + 2 * kAPad);
}
__host__ __device__ inline size_t b_bytes(int limbs) {
  return round16(2 * (size_t)limbs + kBExtra);
}

// Static block state of the routines below.
struct Block {
  Shared sh;
  uint32_t pub[4];     // this block's values read by the cluster
  int sched[3];        // first tile, end tile, next tile group
};

// ---------------------------------------------------------------------------
// staging
// ---------------------------------------------------------------------------

// A layout of the n limbs limb(0), ..., limb(n - 1) (a buffer of
// a_bytes(cap), cap >= n).  `limb` may read at a per-lane offset (the
// step kernels' shifted operand), so one layout serves every caller.
// Every thread of the block stages by default; `tid` and `nthreads` give
// a team of a block its own share instead.
template <class F>
__device__ inline void stage_a_fn(unsigned char* buf, int cap, F limb,
                                  int n, int tid = threadIdx.x,
                                  int nthreads = kThreads) {
  uint16_t* w = reinterpret_cast<uint16_t*>(buf);
  const int words = (int)(a_bytes(cap) / 2);
  for (int i = tid; i < words; i += nthreads) {
    const int j = i - kAPad / 2;
    w[i] = (j >= 0 && j < n) ? (uint16_t)limb(j) : (uint16_t)0;
  }
}

// B layout of the n limbs limb(0), ..., limb(n - 1) (a buffer of
// b_bytes(cap), cap >= n): limb j holds digits 2j (low) and 2j + 1, at
// bytes P - 2j and P - 2j - 1, i.e. the byte-swapped limb at 16-bit
// word (P - 1) / 2 - j = n + 6 - j.
template <class F>
__device__ inline void stage_b_fn(unsigned char* buf, int cap, F limb,
                                  int n, int tid = threadIdx.x,
                                  int nthreads = kThreads) {
  uint16_t* w = reinterpret_cast<uint16_t*>(buf);
  const int words = (int)(b_bytes(cap) / 2);
  for (int i = tid; i < words; i += nthreads) {
    const int j = n + 6 - i;
    uint32_t x = (j >= 0 && j < n) ? (uint32_t)limb(j) : 0u;
    w[i] = (uint16_t)(((x >> 8) | (x << 8)) & kMask);
  }
}

// The two layouts of n limbs of src.
__device__ inline void stage_a(unsigned char* buf, int cap,
                               const int32_t* src, int n) {
  stage_a_fn(buf, cap, [=](int j) { return (uint32_t)src[j]; }, n);
}

__device__ inline void stage_b(unsigned char* buf, int cap,
                               const int32_t* src, int n) {
  stage_b_fn(buf, cap, [=](int j) { return (uint32_t)src[j]; }, n);
}

__device__ inline void zero_bytes(unsigned char* buf, size_t bytes) {
  uint4* w = reinterpret_cast<uint4*>(buf);
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads)
    w[i] = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// the schedule
// ---------------------------------------------------------------------------

__device__ inline void tile_range(int t, int na8, int nb8, int& lo,
                                  int& hi) {
  lo = max(-(nb8 - 1), -(kTileRows * t + kTileRows - 1) * kN);
  hi = min(kN - 1, na8 - 1 - kTileRows * t * kN);
}

__device__ inline int tile_weight(int t, int na8, int nb8) {
  int lo, hi;
  tile_range(t, na8, nb8, lo, hi);
  return 1 + (hi >= lo ? ((hi - (lo & ~3)) >> 5) + 1 : 0);
}

// Called by one whole warp: the first s in [0, tiles] with
// cs * P(s) >= target (P the exclusive prefix sum of the tile weights),
// or the total weight when target < 0.
__device__ inline long long tile_scan(int tiles, int na8, int nb8, int cs,
                                      long long target) {
  const int lane = threadIdx.x & 31;
  long long carry = 0;
  for (int base = 0; base <= tiles; base += 32) {
    const int s = base + lane;
    const int w = s < tiles ? tile_weight(s, na8, nb8) : 0;
    int x = w;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (target >= 0) {
      const bool ok = s <= tiles && (long long)cs * (carry + x - w) >= target;
      const unsigned m = __ballot_sync(kFull, ok);
      if (m) return base + __ffs(m) - 1;
    }
    carry += __shfl_sync(kFull, x, 31);
  }
  return target >= 0 ? tiles : carry;
}

__device__ inline void mma_u8(int (&c)[4], const uint32_t (&a)[4],
                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Limb column sums of a * b (A and B layouts of na8 and nb8 digits) for
// the ng <= kGroup row tiles from tg, one warp sharing each B fragment
// among them; columns at or past n_cols are not written.
__device__ __forceinline__ void sweep_group(const unsigned char* A, int na8,
                                            const unsigned char* Bv, int nb8,
                                            int n_cols, uint64_t* col,
                                            int tg, int ng) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int P = nb8 + 13;
  int lo[kGroup], hi[kGroup];
  int lo_g = INT_MAX, hi_g = INT_MIN;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    lo[j] = 1;
    hi[j] = 0;
    if (j < ng) tile_range(tg + j, na8, nb8, lo[j], hi[j]);
    if (hi[j] >= lo[j]) {
      lo_g = min(lo_g, lo[j]);
      hi_g = max(hi_g, hi[j]);
    }
  }
  int acc[kGroup][4];
  unsigned long long wide[kGroup][4];
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[j][i] = 0;
      wide[j][i] = 0;
    }
  int step = 0;
  for (int k0 = lo_g & ~3; lo_g <= hi_g && k0 <= hi_g; k0 += kKStep) {
    uint32_t b[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int idx = P - g + k0 + 4 * t + 16 * j;
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(Bv + (idx & ~3));
      b[j] = __funnelshift_r(w[0], w[1], 8 * (idx & 3));
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (j < ng && k0 <= hi[j] && k0 + kKStep - 1 >= lo[j]) {
        const int r0 = (kTileRows * (tg + j) + g) * kN + k0 + 4 * t + kAPad;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(A + r0);
        a[1] = *reinterpret_cast<const uint32_t*>(A + r0 + 8 * kN);
        a[2] = *reinterpret_cast<const uint32_t*>(A + r0 + 16);
        a[3] = *reinterpret_cast<const uint32_t*>(A + r0 + 8 * kN + 16);
        mma_u8(acc[j], a, b);
      }
    }
    if (++step == kKChunk / kKStep) {
      step = 0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wide[j][i] += (uint32_t)acc[j][i];
          acc[j][i] = 0;
        }
    }
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    if (j >= ng) continue;
    unsigned long long s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] = wide[j][i] + (uint32_t)acc[j][i];
    const int k = (kTileRows * (tg + j) + g) * (kN / 2) + t;
    if (k < n_cols) col[k] = s[0] + (s[1] << 8);
    if (k + 8 * (kN / 2) < n_cols) col[k + 8 * (kN / 2)] = s[2] + (s[3] << 8);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The B fragment of a k step: w is the shared address of the aligned
// word holding the lane's first digit, sh its offset in bits.
__device__ __forceinline__ void load_b(uint32_t w, int sh, uint32_t (&b)[2]) {
  b[0] = __funnelshift_r(lds32(w), lds32(w + 4), sh);
  b[1] = __funnelshift_r(lds32(w + 16), lds32(w + 20), sh);
}

// sweep_group's column sums for kDeep row tiles per B fragment, with the
// Toeplitz repeats of A held in registers.  Lane (g, t) reads its A
// words 16 bytes apart: word x at A's byte (16 tg + g) * 8 + k_start +
// 4t + 16x, and tile j at k step s takes x = 8j + 2s + {0, 4, 1, 5} as
// its fragment (a[0..3]).  So a word serves tile j at step s and tile
// j - 1 at step s + 4 (the next tile is 128 bytes on), and a[0], a[2]
// at step s + 2 are a[1], a[3] at step s.  Steps of one parity share
// their words: a pass over the even steps, then one over the odd ones,
// holds the kRing words x = 2s + 4m + e (m < 2 kDeep, e < 2) in a ring
// of registers and loads the two new ones a step, with the step's B
// fragment (4 words): 6 shared loads for kDeep mma.  The passes cover
// the steps where every tile of the group is busy, with no per-tile
// test; the ends of the tiles' k ranges (where the group's tiles start
// and stop apart) and groups of fewer than kDeep tiles run one step at
// a time, each tile where its range meets the step.  The s32 sums are
// flushed into col itself (each column has one writer) at least every
// kKChunk digits of k.
__device__ __forceinline__ void sweep_deep(const unsigned char* A, int na8,
                                           const unsigned char* Bv, int nb8,
                                           int n_cols, uint64_t* col,
                                           int tg, int ng) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int lo[kDeep], hi[kDeep];
  int lo_g = INT_MAX, hi_g = INT_MIN;
#pragma unroll
  for (int j = 0; j < kDeep; ++j) {
    lo[j] = 1;
    hi[j] = 0;
    if (j < ng) tile_range(tg + j, na8, nb8, lo[j], hi[j]);
    if (hi[j] >= lo[j]) {
      lo_g = min(lo_g, lo[j]);
      hi_g = max(hi_g, hi[j]);
    }
  }
  int acc[kDeep][4];
#pragma unroll
  for (int j = 0; j < kDeep; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;
  const int c0 = (kTileRows * tg + g) * (kN / 2) + t;   // tile 0's column
  bool flushed = false;
  auto put = [&](bool add) {     // col (+)= the s32 sums; acc = 0
#pragma unroll
    for (int j = 0; j < kDeep; ++j) {
      if (j >= ng) continue;
      const int k = c0 + j * kTileRows * (kN / 2);
      const uint64_t lo_c = (uint32_t)acc[j][0]
          + ((uint64_t)(uint32_t)acc[j][1] << 8);
      const uint64_t hi_c = (uint32_t)acc[j][2]
          + ((uint64_t)(uint32_t)acc[j][3] << 8);
      if (k < n_cols) col[k] = add ? col[k] + lo_c : lo_c;
      if (k + 8 * (kN / 2) < n_cols)
        col[k + 8 * (kN / 2)] = add ? col[k + 8 * (kN / 2)] + hi_c : hi_c;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0;
    }
  };
  int cnt = 0;                   // k steps in acc since the last flush
  auto flush = [&] {
    put(flushed);
    flushed = true;
    cnt = 0;
  };
  if (lo_g <= hi_g) {
    const int k_start = lo_g & ~3;
    const int steps = ((hi_g - k_start) >> 5) + 1;
    int first[kDeep], last[kDeep];
    int s0 = 0, s1 = steps - 1;        // where every tile is busy
#pragma unroll
    for (int j = 0; j < kDeep; ++j) {
      first[j] = hi[j] >= lo[j] ? (lo[j] - k_start) >> 5 : INT_MAX;
      last[j] = hi[j] >= lo[j] ? (hi[j] - k_start) >> 5 : -1;
      s0 = max(s0, first[j]);
      s1 = min(s1, last[j]);
    }
    if (s0 > s1) s0 = steps;           // no such step
    const int bidx = nb8 + 13 - g + k_start + 4 * t;
    const uint32_t bw = smem_addr(Bv) + (bidx & ~3);
    const int sh = 8 * (bidx & 3);
    const uint32_t aw = smem_addr(A) + (kTileRows * tg + g) * kN + k_start
        + 4 * t + kAPad;
    auto edge = [&](int s) {
      uint32_t b[2];
      load_b(bw + kKStep * s, sh, b);
#pragma unroll
      for (int j = 0; j < kDeep; ++j) {
        if (s >= first[j] && s <= last[j]) {
          const uint32_t x = aw + 16 * (8 * j + 2 * s);
          const uint32_t a[4] = {lds32(x), lds32(x + 64), lds32(x + 16),
                                 lds32(x + 80)};
          mma_u8(acc[j], a, b);
        }
      }
      if (++cnt == kKChunk / kKStep) flush();
    };
    for (int s = 0; s < s0; ++s) edge(s);
    for (int s = s0 > s1 ? steps : s1 + 1; s < steps; ++s) edge(s);
#pragma unroll 1
    for (int par = 0; par < 2; ++par) {
      const int sp = s0 + par;         // the pass's first step
      if (sp > s1) break;
      const int n = (s1 - sp) / 2 + 1;
      // ring slot (2m + e) % kRing holds word x = 2 sp + 4m + e, m taken
      // from the start of the current round of kRing / 2 steps
      uint32_t R[kRing];
      uint32_t as = aw + 32 * sp, bs = bw + kKStep * sp;
#pragma unroll
      for (int m = 0; m < kRing / 2 - 1; ++m) {
        R[2 * m] = lds32(as + 64 * m);
        R[2 * m + 1] = lds32(as + 64 * m + 16);
      }
      // step i of a round of kRing / 2: its two new A words, its B
      // fragment, kDeep mma from the ring
      auto step = [&](int i) {
        const int m = i + kRing / 2 - 1;            // tile kDeep-1's a[1]
        R[(2 * m) % kRing] = lds32(as + 64 * m);
        R[(2 * m + 1) % kRing] = lds32(as + 64 * m + 16);
        uint32_t b[2];
        load_b(bs + 2 * kKStep * i, sh, b);
#pragma unroll
        for (int j = 0; j < kDeep; ++j) {
          const int r = 2 * (2 * j + i);
          const uint32_t a[4] = {R[r % kRing], R[(r + 2) % kRing],
                                 R[(r + 1) % kRing], R[(r + 3) % kRing]};
          mma_u8(acc[j], a, b);
        }
      };
      // whole rounds have no branch inside, so that the compiler can
      // issue a step's loads under the previous step's mma
      for (int q = 0; q < n; q += kRing / 2) {
        if (cnt > kKChunk / kKStep - kRing / 2) flush();
        cnt += kRing / 2;
        if (n - q >= kRing / 2) {
#pragma unroll
          for (int i = 0; i < kRing / 2; ++i) step(i);
        } else {
#pragma unroll
          for (int i = 0; i < kRing / 2; ++i)
            if (i < n - q) step(i);
        }
        as += 64 * (kRing / 2);
        bs += 2 * kKStep * (kRing / 2);
      }
    }
  }
  put(flushed);
}

// Block products that ran the deep loop on this card since the host
// last read them (digit_deep_blocks); one count a library.
__device__ unsigned long long deep_blocks;

// Limb column sums col[0, n_cols) of a * b (A and B layouts of na8 and
// nb8 digits) over this block's share of the row tiles; every thread of
// the block calls it.  Column j < n_cols is written by exactly one
// block of the cluster.  The block picks its main loop (the head of
// this file) and counts deep in deep_blocks.  Not inlined: the mma loop
// then gets its own register allocation (measured faster on the card
// than inlined).
__device__ __noinline__ void digit_product(const unsigned char* A, int na8,
                                     const unsigned char* Bv, int nb8,
                                     int n_cols, uint64_t* col, Block& st,
                                     int rank, int cs) {
  const int tiles = (n_cols + 63) / 64;          // 64 limb columns a tile
  if (threadIdx.x < 32) {
    const long long total = tile_scan(tiles, na8, nb8, cs, -1);
    const int t0 = (int)tile_scan(tiles, na8, nb8, cs, rank * total);
    const int t1 = rank + 1 == cs
        ? tiles : (int)tile_scan(tiles, na8, nb8, cs, (rank + 1) * total);
    if (threadIdx.x == 0) {
      st.sched[0] = t0;
      st.sched[1] = t1;
      st.sched[2] = 0;
    }
  }
  __syncthreads();
  const int t0 = st.sched[0], t1 = st.sched[1];
  // kDeep tiles per B fragment for a long product, else kGroup, or
  // single tiles where a block has no more tiles than warps, so that
  // every warp has one
  const bool deep = t1 - t0 >= kDeep * kWarps
      && (cs == 1 || tiles >= 2 * kDeep * kWarps * cs);
  const int gsz = deep ? kDeep : t1 - t0 > kWarps ? kGroup : 1;
  if (deep && threadIdx.x == 0) atomicAdd(&deep_blocks, 1ull);
  const int groups = (t1 - t0 + gsz - 1) / gsz;
  const int lane = threadIdx.x & 31;
  for (;;) {
    int gi = 0;
    if (lane == 0) gi = atomicAdd(&st.sched[2], 1);
    gi = __shfl_sync(kFull, gi, 0);
    if (gi >= groups) break;
    gi = groups - 1 - gi;          // the heavier high tiles of a truncated
                                   // product start first
    const int tg = t0 + gi * gsz;
    if (gsz == kDeep)
      sweep_deep(A, na8, Bv, nb8, n_cols, col, tg, min(gsz, t1 - tg));
    else
      sweep_group(A, na8, Bv, nb8, n_cols, col, tg, min(gsz, t1 - tg));
  }
  __syncthreads();
}

// The same column sums by `warps` warps of a team alone (warp `warp` of
// them calls it), the groups dealt out in turn, heaviest first, with no
// barrier: the caller synchronises the team before reading col.
__device__ __noinline__ void team_product(const unsigned char* A, int na8,
                                          const unsigned char* Bv, int nb8,
                                          int n_cols, uint64_t* col,
                                          int warp, int warps) {
  const int tiles = (n_cols + 63) / 64;
  const int gsz = tiles > warps ? kGroup : 1;
  const int groups = (tiles + gsz - 1) / gsz;
  for (int gi = warp; gi < groups; gi += warps) {
    const int tg = (groups - 1 - gi) * gsz;
    sweep_group(A, na8, Bv, nb8, n_cols, col, tg, min(gsz, tiles - tg));
  }
}

// ---------------------------------------------------------------------------
// cluster-wide carry chains and comparisons
// ---------------------------------------------------------------------------

// Block `rank`'s even share [lo, hi) of n positions.
__device__ inline void share(int n, int rank, int cs, int& lo, int& hi) {
  lo = (int)((long long)n * rank / cs);
  hi = (int)((long long)n * (rank + 1) / cs);
}

// Carry chain over positions [0, n), each block of the cluster over its
// share: digit(i) gives position i's raw value, generate and propagate
// bits; store(i, (s_i +/- c_i) & kMask) receives every output, with
// c_0 = cin.  The carry into a block composes the (generate, propagate)
// pairs of the blocks below it on cin.  Ends with cluster.sync(), so
// the outputs are visible to the whole cluster.  digit(i) may read only
// position i of an array that store overwrites.
template <class F, class S>
__device__ void cluster_chain(int n, F digit, bool subtract, S store,
                              Block& st, cg::cluster_group& cl,
                              uint32_t cin = 0) {
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  int lo_b, hi_b;
  share(n, rank, cs, lo_b, hi_b);
  const int m = hi_b - lo_b;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = lo_b + min(m, (int)threadIdx.x * per);
  const int hi = lo_b + min(m, (int)threadIdx.x * per + per);
  Shared& sh = st.sh;
  uint32_t G = 0, Pp = 1;
  for (int i = lo; i < hi; ++i) {
    const Digit d = digit(i);
    G = d.g | (d.p & G);
    Pp &= d.p;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t gs = __shfl_up_sync(kFull, G, off);
    const uint32_t ps = __shfl_up_sync(kFull, Pp, off);
    if (lane >= off) {
      G = G | (Pp & gs);
      Pp = Pp & ps;
    }
  }
  if (lane == 31) {
    sh.g[wid] = G;
    sh.p[wid] = Pp;
  }
  __syncthreads();
  if (wid == 0) {
    uint32_t wg = lane < kWarps ? sh.g[lane] : 0u;
    uint32_t wp = lane < kWarps ? sh.p[lane] : 1u;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t gs = __shfl_up_sync(kFull, wg, off);
      const uint32_t ps = __shfl_up_sync(kFull, wp, off);
      if (lane >= off) {
        wg = wg | (wp & gs);
        wp = wp & ps;
      }
    }
    if (lane < kWarps) {
      sh.g[lane] = wg;
      sh.p[lane] = wp;
    }
    if (lane == kWarps - 1) {
      st.pub[0] = wg;
      st.pub[1] = wp;
    }
  }
  uint32_t eg = __shfl_up_sync(kFull, G, 1);
  uint32_t ep = __shfl_up_sync(kFull, Pp, 1);
  if (lane == 0) {
    eg = 0;
    ep = 1;
  }
  cl.sync();                      // every block's pair is published
  const uint32_t bg = wid > 0 ? sh.g[wid - 1] : 0u;
  const uint32_t bp = wid > 0 ? sh.p[wid - 1] : 1u;
  uint32_t c_in = cin;
  for (int r = 0; r < rank; ++r) {
    const uint32_t* rp = cl.map_shared_rank(st.pub, r);
    c_in = rp[0] | (rp[1] & c_in);
  }
  const uint32_t xg = eg | (ep & bg), xp = ep & bp;
  uint32_t c = xg | (xp & c_in);
  for (int i = lo; i < hi; ++i) {
    const Digit d = digit(i);
    store(i, (subtract ? d.s - c : d.s + c) & kMask);
    c = d.g | (d.p & c);
  }
  cl.sync();                      // outputs visible; pub free again
}

// a < b over n limbs across the cluster: the block owning the most
// significant differing limb decides (key = 2 * (index + 1) + bit, the
// cluster's maximum key wins).
template <class FA, class FB>
__device__ bool cluster_lt(int n, FA a, FB b, Block& st,
                           cg::cluster_group& cl) {
  const int rank = (int)cl.block_rank(), cs = (int)cl.num_blocks();
  int lo, hi;
  share(n, rank, cs, lo, hi);
  int top = 0;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads)
    if (a(i) != b(i)) top = i + 1;
  top = limbs::block_reduce(top, limbs::MaxOp(), 0, st.sh);
  if (threadIdx.x == 0)
    st.pub[2] = top > 0 ? 2u * top + (a(top - 1) < b(top - 1) ? 1u : 0u) : 0u;
  cl.sync();
  uint32_t best = 0;
  for (int r = 0; r < cs; ++r) best = max(best, *cl.map_shared_rank(&st.pub[2], r));
  cl.sync();
  return (best & 1u) != 0;
}

// op over one int per thread of the whole cluster (each block's
// block_reduce, then over the blocks); every thread gets the result.
template <class Op>
__device__ int cluster_reduce(int x, Op op, int ident, Block& st,
                              cg::cluster_group& cl) {
  x = limbs::block_reduce(x, op, ident, st.sh);
  if (threadIdx.x == 0) st.pub[3] = (uint32_t)x;
  cl.sync();
  int r = ident;
  for (int q = 0; q < (int)cl.num_blocks(); ++q)
    r = op(r, (int)*cl.map_shared_rank(&st.pub[3], q));
  cl.sync();
  return r;
}

// Column sums col[0, n_cols) (zero above; each < 2^48) -> canonical limbs
// of positions [0, n), mod B^n, through store(i, limb): each sum splits
// into three 16-bit pieces added at limb offsets 0, 1 and 2 (a piece sum
// < 3 * 2^16), one local pass leaves digits <= 2^16 + 1 whose carries
// are 0 or 1, and one cluster-wide carry chain finishes.  The caller
// makes col visible to the cluster (cluster.sync()) first.  e is global
// scratch of n words.
template <class S>
__device__ void cluster_resolve(const uint64_t* col, int n_cols,
                                uint32_t* e, int n, S store, Block& st,
                                cg::cluster_group& cl) {
  int lo, hi;
  share(n, (int)cl.block_rank(), (int)cl.num_blocks(), lo, hi);
  auto at = [&](int k) -> uint64_t {
    return k >= 0 && k < n_cols ? col[k] : 0ull;
  };
  auto piece = [&](int k) -> uint32_t {
    return (uint32_t)(at(k) & kMask) + (uint32_t)((at(k - 1) >> 16) & kMask)
        + (uint32_t)(at(k - 2) >> 32);
  };
  for (int k = lo + threadIdx.x; k < hi; k += kThreads) e[k] = piece(k);
  const uint32_t below = lo >= 1 ? piece(lo - 1) : 0u;
  __syncthreads();
  cluster_chain(
      n,
      [&](int k) {
        const uint32_t s = (e[k] & kMask) + ((k > lo ? e[k - 1] : below) >> 16);
        return Digit{s, s >> 16, s == kMask ? 1u : 0u};
      },
      false, store, st, cl);
}

// ---------------------------------------------------------------------------
// one warp's carry chains
// ---------------------------------------------------------------------------

// The carry chain of cluster_chain run by one warp alone, 32 positions a
// round, lane j at position base + j (coalesced).  A round's carries come
// from its generate and propagate ballots G and P (disjoint for every
// Digit) by one addition: (G | P) + G + c sets bit j of its sum xor P
// exactly where position j receives a carry, and its bit 32 is the carry
// into the next round.  Every lane of the warp calls it.  digit(i) is
// called by every lane once a round, in order, also at i >= n, where its
// value is ignored (it may shuffle; it must not read out of bounds
// there); store(i, limb) receives each output i < n in the same round.
template <class F, class S>
__device__ void warp_chain(int n, F digit, bool subtract, S store,
                           uint32_t cin = 0) {
  const int lane = threadIdx.x & 31;
  uint32_t c = cin;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const Digit d = digit(i);
    const uint32_t G = __ballot_sync(kFull, i < n && d.g != 0);
    const uint32_t P = __ballot_sync(kFull, i < n && d.p != 0);
    const unsigned long long sum = (unsigned long long)(G | P) + G + c;
    const uint32_t ci = (((uint32_t)sum ^ P) >> lane) & 1u;
    if (i < n) store(i, (subtract ? d.s - ci : d.s + ci) & kMask);
    c = (uint32_t)(sum >> 32);
  }
}

// cluster_resolve by one warp: column sums col[0, n_cols) (zero above;
// each < 2^48) -> limbs of positions [0, n), mod B^n, through store(i,
// limb).  Lane j makes position base + j's piece; the piece below comes
// from the neighbouring lane, or from lane 31 of the round before.
template <class S>
__device__ void warp_resolve(const uint64_t* col, int n_cols, int n,
                             S store) {
  const int lane = threadIdx.x & 31;
  auto at = [&](int k) -> uint64_t {
    return k >= 0 && k < n_cols ? col[k] : 0ull;
  };
  uint32_t last = 0;                 // the piece of position base - 1
  warp_chain(
      n,
      [&](int k) {
        const uint32_t e = (uint32_t)(at(k) & kMask)
            + (uint32_t)((at(k - 1) >> 16) & kMask)
            + (uint32_t)(at(k - 2) >> 32);
        uint32_t below = __shfl_up_sync(kFull, e, 1);
        if (lane == 0) below = last;
        last = __shfl_sync(kFull, e, 31);
        const uint32_t s = (e & kMask) + (below >> 16);
        return Digit{s, s >> 16, s == kMask ? 1u : 0u};
      },
      false, store);
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// Launches `kernel` on batch * cluster blocks in clusters of `*cluster`
// (halved until such a cluster can be resident; the size used is written
// back), with `bytes` of dynamic shared memory: one launch.
template <auto kernel, class... Args>
cudaError_t launch(int batch, int* cluster, size_t bytes,
                   cudaStream_t stream, Args... args) {
  if (batch <= 0) return cudaSuccess;
  int cs = *cluster;
  if (cs < 1 || cs > kMaxCluster || (cs & (cs - 1)))
    return cudaErrorInvalidValue;
  static std::mutex mu;
  static size_t allowed[limbs::kMaxDevices] = {};
  static std::map<std::tuple<int, int, size_t>, int> fits;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= limbs::kMaxDevices) return cudaErrorInvalidDevice;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (bytes > allowed[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      allowed[dev] = bytes;
    }
    const auto key = std::make_tuple(dev, cs, bytes);
    auto it = fits.find(key);
    if (it == fits.end()) {
      int c = cs;
      for (;;) {
        attr[0].val.clusterDim.x = c;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.gridDim = dim3(c, 1, 1);
        int n = 0;
        err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
        if (err != cudaSuccess) return err;
        if (n >= 1 || c == 1) break;
        c /= 2;
      }
      it = fits.emplace(key, c).first;
    }
    cs = it->second;
  }
  *cluster = cs;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)batch * cs, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches `kernel` on ceil(batch / lanes) blocks of `threads` threads,
// `lanes` instances a block, with `bytes` of dynamic shared memory and
// no cluster: one launch.
template <auto kernel, class... Args>
cudaError_t launch_packed(int batch, int lanes, int threads, size_t bytes,
                          cudaStream_t stream, Args... args) {
  if (batch <= 0) return cudaSuccess;
  static std::mutex mu;
  static size_t allowed[limbs::kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= limbs::kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (bytes > allowed[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      allowed[dev] = bytes;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((batch + lanes - 1) / lanes), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace digitmma

// The current card's deep_blocks into *out, zeroed after the read, in
// order on `stream`; returns once the read has landed.
extern "C" int digit_deep_blocks(unsigned long long* out, void* stream) {
  static const unsigned long long zero = 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemcpyFromSymbolAsync(
      out, digitmma::deep_blocks, sizeof zero, 0, cudaMemcpyDeviceToHost, s);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbolAsync(digitmma::deep_blocks, &zero, sizeof zero,
                                  0, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) err = cudaStreamSynchronize(s);
  return (int)err;
}
