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
// kGroup row tiles per B fragment (one where a block has no more tiles
// than warps); the heaviest groups start first.  The s32 sums are exact over 33,025
// terms and are flushed into 64-bit sums every kKChunk digits of k.
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

// Limb column sums col[0, n_cols) of a * b (A and B layouts of na8 and
// nb8 digits) over this block's share of the row tiles; every thread of
// the block calls it.  Column j < n_cols is written by exactly one
// block of the cluster.  Not inlined: the mma loop then gets its own
// register allocation (measured faster on the card than inlined).
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
  // kGroup tiles per B fragment, or single tiles where a block has no
  // more tiles than warps, so that every warp has one
  const int gsz = t1 - t0 > kWarps ? kGroup : 1;
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
