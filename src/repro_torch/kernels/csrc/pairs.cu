// The pair product of the cuda_pairs rung: exact (u * v) mod B^n per
// instance, written as canonical limbs and zero from limb n up to
// out_width, in one launch.
//
// Replaces repro/kernels/bigmul.py:_mul_kernel (launched by
// _call_pair_kernel for mul_pallas and mulmod_pallas).  The TPU kernel
// walked diagonal-sorted (i, j) tile pairs on a sequential grid and
// accumulated each pair's product into the VMEM tile of its output
// diagonal; the overlap-add of the diagonals and the carries were left
// to XLA.  Here one block owns one output column tile: the kTc limb
// columns [c * kTc, (c + 1) * kTc) of one instance.
//
// The product.  For each v tile j (kTv limbs) whose products reach the
// block's columns, the block stages v_j in digitmma.cuh's B layout and
// the window of u that meets it in its A layout (u limbs
// [c*kTc - j*kTv - kTv, c*kTc - j*kTv + kTc), zero outside u), and runs
// digitmma.cuh's sliding-window x Toeplitz digit GEMM on the int8
// tensor cores (mma_u8): C[r, n] = sum_k A[r, k] B[k, n] is digit column
// r*8 + n of the tile.  Warp w owns row tiles kG*w .. kG*w + kG - 1 (64
// limb columns each) and shares each B fragment between them; each row
// tile's k range is clipped to where u and v_j are nonzero, and row
// tiles at or past n are skipped.  The s32 sums of one v tile (at most
// 2*kTv digits of k, inside kKChunk) are flushed into 64-bit sums that
// stay in registers across the v tiles.  Only the tiles below
// ceil(n / kTc) run, n = min(l_max, out_width, wu + wv): the pruning of
// mulmod_pallas.
//
// The carries, in the same launch.  Tile c's value with its full column
// sums is V_c (each sum < 2^48); the block resolves it to
// L_c = V_c mod B^kTc and H_c = floor(V_c / B^kTc) < 2^34.  With the
// carry-in X_c from the tiles below (X_0 = 0, X_c < 2^35 < B^4),
//   X_{c+1} = H_c + [L_c + X_c >= B^kTc],
// and the bracket can be 1 only where every limb of L_c from limb 4 up
// is 0xFFFF.  So a tile publishes X_{c+1} as soon as it has L_c, unless
// those limbs are all 0xFFFF: only such a tile waits for X_c before it
// publishes.  Every tile then reads X_c, adds it, and writes its limbs.
// Blocks take their (instance, tile) from an atomic ticket, tile-major
// (every instance's tile 0, then every tile 1, ...), so a block only
// waits on a tile whose block has already started: no deadlock,
// whatever order the blocks are scheduled in; and the light low tiles
// of a truncated product spread over the SMs beside the heavy ones.
// (A decoupled look-back whose look-back is one tile.)  mul_pairs_launch
// zeroes the ticket and the publish words (a memset) before the kernel.
//
// Shared memory holds one v tile and one u window in the two layouts
// (6 KB), and the next ones as read from global memory (12 KB), which
// cp.async fetches while the tensor cores work on the current ones.
// That is fixed whatever the widths: no width cap below the column-sum
// contract (operands up to 2^16 limbs, bigmul.PAIRS_MAX_LIMBS).
//
// Bound: the limb products (operations), 8 int8 operations each at
// 1,979 TOP/s.  The CUDA-core kernel this one follows lost against it
// by two shared-memory loads per limb product and by the uneven pair
// counts of the output diagonals, and its per-diagonal sums were
// overlap-added and resolved in torch after the launch.  Here one
// mma covers 1,024 limb products for six 32-bit shared loads per
// lane (the B fragment shared by kG row tiles), a block's work is a
// whole column tile of the truncated product, and nothing runs after
// the launch.
#include "digitmma.cuh"

using namespace digitmma;

namespace {

constexpr int kPThreads = 256;                 // threads of a block
constexpr int kPWarps = kPThreads / 32;
constexpr int kG = 2;                          // row tiles of a warp
constexpr int kRowTiles = kPWarps * kG;
constexpr int kTc = kRowTiles * 64;            // limb columns of a block
constexpr int kTv = 1024;                      // limbs of a v tile
constexpr int kAWords = kTc + kTv + 32;        // 16-bit words of a u window
constexpr int kABase = kTv + 8;                // word of local limb 0
constexpr int kA0 = 2 * kABase;                // byte of local digit 0
constexpr int kBBytes = (2 * kTv + kBExtra + 15) & ~15;
constexpr int kPB = 2 * kTv + 13;              // B: digit d at byte kPB - d
constexpr int kPer = kTc / kPThreads;          // chain positions a thread
constexpr unsigned long long kReady = 1ull << 63;

static_assert(2 * kTv + 2 * kKStep <= kKChunk,
              "the s32 sums of one v tile must stay exact");
static_assert(kTc % kPThreads == 0, "chain positions split evenly");

struct Smem {
  int32_t raw_a[kAWords];                      // the next u window, as read
  int32_t raw_b[kTv];                          // the next v tile, as read
  __align__(16) unsigned char a[2 * kAWords];  // u window, A layout
  __align__(16) unsigned char b[kBBytes];      // v tile, B layout
  uint64_t col[kTc];                           // limb column sums
  uint32_t e[kTc + 4];                         // 16-bit pieces, summed
  uint32_t lo[kTc];                            // L_c
  uint32_t g[kPWarps], p[kPWarps];             // the chain's warp pairs
  unsigned long long x;                        // X_c
  int ticket;
};

__device__ inline void publish(unsigned long long* p, unsigned long long x) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(x | kReady) : "memory");
}

__device__ inline unsigned long long peek(const unsigned long long* p) {
  unsigned long long x;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(x) : "l"(p) : "memory");
  return x;
}

// 4-byte cp.async of src into shared memory, zero-filled when !ok (src
// must then still be a valid address).
__device__ inline void copy4(int32_t* dst, const int32_t* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Reads the u window and the v tile of v tile j into raw_a / raw_b with
// cp.async (one commit group); the caller waits for it.
__device__ inline void fetch(Smem& sm, const int32_t* ub, const int32_t* vb,
                             int wu, int wv, int c0, int j) {
  const int j0 = j * kTv, off = c0 - j0;
  for (int i = threadIdx.x; i < kAWords; i += kPThreads) {
    const int x = off + i - kABase;
    const bool ok = x >= 0 && x < wu;
    copy4(&sm.raw_a[i], ok ? ub + x : ub, ok);
  }
  for (int i = threadIdx.x; i < kTv; i += kPThreads) {
    const bool ok = j0 + i < wv;
    copy4(&sm.raw_b[i], ok ? vb + j0 + i : vb, ok);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Carry chain over the tile's kTc positions: digit(i) gives position i's
// raw value with its generate and propagate bits, store(i, limb)
// receives (s_i + c_i) & kMask with c_0 = 0.  Returns the carry out of
// the top.  Thread t takes positions [t * kPer, (t + 1) * kPer); warps
// compose their (generate, propagate) pairs through shared memory.
// digit may read only what store does not write.
template <class F, class S>
__device__ uint32_t tile_chain(F digit, S store, Smem& sm) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int lo = threadIdx.x * kPer;
  uint32_t G = 0, Pp = 1;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const Digit d = digit(lo + i);
    G = d.g | (d.p & G);
    Pp &= d.p;
  }
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t gs = __shfl_up_sync(kFull, G, off);
    const uint32_t ps = __shfl_up_sync(kFull, Pp, off);
    if (lane >= off) {
      G |= Pp & gs;
      Pp &= ps;
    }
  }
  if (lane == 31) {
    sm.g[wid] = G;
    sm.p[wid] = Pp;
  }
  uint32_t eg = __shfl_up_sync(kFull, G, 1);
  uint32_t ep = __shfl_up_sync(kFull, Pp, 1);
  if (lane == 0) {
    eg = 0;
    ep = 1;
  }
  __syncthreads();
  uint32_t c = 0;                      // carry into this warp
  for (int w = 0; w < wid; ++w) c = sm.g[w] | (sm.p[w] & c);
  c = eg | (ep & c);                   // ... and into this thread
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const Digit d = digit(lo + i);
    store(lo + i, (d.s + c) & kMask);
    c = d.g | (d.p & c);
  }
  uint32_t out = 0;
  for (int w = 0; w < kPWarps; ++w) out = sm.g[w] | (sm.p[w] & out);
  __syncthreads();                     // stores visible, sm.g/p free
  return out;
}

}  // namespace

// Two blocks per SM leave a thread up to 128 registers, so the unrolled
// mma loop keeps more shared loads in flight.
__global__ void __launch_bounds__(kPThreads, 2)
mul_pairs_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                 int32_t* __restrict__ out, unsigned long long* pub, int ldu,
                 int ldv, int wu, int wv, int n, int out_width, int nc) {
  __shared__ Smem sm;
  if (threadIdx.x == 0) sm.ticket = (int)atomicAdd(pub, 1ull);
  __syncthreads();
  const int batch = (int)gridDim.x / nc;
  const int b = sm.ticket % batch, c = sm.ticket / batch;   // tile-major
  const int c0 = c * kTc, need = min(kTc, n - c0);
  const int32_t* ub = u + (size_t)b * ldu;
  const int32_t* vb = v + (size_t)b * ldv;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  // -- the column sums of the tile ---------------------------------------
  unsigned long long wide[kG][4];
#pragma unroll
  for (int i = 0; i < kG; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) wide[i][r] = 0;
  // v tiles with a product in columns [c0, c0 + need): j0 <= c0 + need - 1
  // and j0 + kTv - 1 + wu - 1 >= c0
  const int j_lo = (max(0, c0 - wu - kTv + 2) + kTv - 1) / kTv;
  const int j_hi = min((wv - 1) / kTv, (c0 + need - 1) / kTv);
  uint16_t* aw = reinterpret_cast<uint16_t*>(sm.a);
  uint16_t* bw = reinterpret_cast<uint16_t*>(sm.b);
  if (j_lo <= j_hi) fetch(sm, ub, vb, wu, wv, c0, j_lo);
  for (int j = j_lo; j <= j_hi; ++j) {
    const int j0 = j * kTv, nbj = min(kTv, wv - j0), off = c0 - j0;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();                   // tile j read; the previous one used
    for (int i = threadIdx.x; i < kAWords; i += kPThreads)
      aw[i] = (uint16_t)sm.raw_a[i];
    for (int i = threadIdx.x; i < kBBytes / 2; i += kPThreads) {
      const int y = kTv + 6 - i;
      const uint32_t x = (y >= 0 && y < kTv) ? (uint32_t)sm.raw_b[y] : 0u;
      bw[i] = (uint16_t)(((x >> 8) | (x << 8)) & kMask);
    }
    __syncthreads();
    // the next tile's reads run under this tile's products
    if (j < j_hi) fetch(sm, ub, vb, wu, wv, c0, j + 1);
    // A[r, k] = u digit 2*off + r*8 + k; B[k, n] = v_j digit n - k
    int lo[kG], hi[kG];
    int lo_g = INT_MAX, hi_g = INT_MIN;
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int t = kG * wid + i;
      lo[i] = max(-(2 * nbj - 1), -2 * off - (kTileRows * t + 15) * kN);
      hi[i] = min(kN - 1, 2 * wu - 1 - 2 * off - kTileRows * t * kN);
      if (64 * t >= need) hi[i] = lo[i] - 1;   // columns at or past n
      if (hi[i] >= lo[i]) {
        lo_g = min(lo_g, lo[i]);
        hi_g = max(hi_g, hi[i]);
      }
    }
    int acc[kG][4];
#pragma unroll
    for (int i = 0; i < kG; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][r] = 0;
#pragma unroll 2
    for (int k0 = lo_g & ~3; lo_g <= hi_g && k0 <= hi_g; k0 += kKStep) {
      uint32_t bf[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = kPB - g + k0 + 4 * t4 + 16 * h;
        const uint32_t* w =
            reinterpret_cast<const uint32_t*>(sm.b + (idx & ~3));
        bf[h] = __funnelshift_r(w[0], w[1], 8 * (idx & 3));
      }
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        if (k0 <= hi[i] && k0 + kKStep - 1 >= lo[i]) {
          const int r0 = (kTileRows * (kG * wid + i) + g) * kN + k0 + 4 * t4
              + kA0;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(sm.a + r0);
          a[1] = *reinterpret_cast<const uint32_t*>(sm.a + r0 + 8 * kN);
          a[2] = *reinterpret_cast<const uint32_t*>(sm.a + r0 + 16);
          a[3] = *reinterpret_cast<const uint32_t*>(sm.a + r0 + 8 * kN + 16);
          mma_u8(acc[i], a, bf);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kG; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) wide[i][r] += (uint32_t)acc[i][r];
  }
  // thread (g, t4) holds digit columns 2*t4, 2*t4 + 1 of rows g and g + 8:
  // limb columns k and k + 32
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    const int k = (kTileRows * (kG * wid + i) + g) * (kN / 2) + t4;
    sm.col[k] = wide[i][0] + (wide[i][1] << 8);
    sm.col[k + 32] = wide[i][2] + (wide[i][3] << 8);
  }
  __syncthreads();

  // -- L_c and H_c ---------------------------------------------------------
  // each sum splits into 16-bit pieces added at limb offsets 0, 1, 2
  // (a piece sum < 3 * 2^16); one local pass leaves digits <= 2^16 + 1
  for (int k = threadIdx.x; k < kTc + 4; k += kPThreads) {
    auto at = [&](int i) -> uint64_t {
      return i >= 0 && i < kTc ? sm.col[i] : 0ull;
    };
    sm.e[k] = (uint32_t)(at(k) & kMask) + (uint32_t)((at(k - 1) >> 16) & kMask)
        + (uint32_t)(at(k - 2) >> 32);
  }
  __syncthreads();
  auto f = [&](int k) -> uint32_t {
    return (sm.e[k] & kMask) + (k > 0 ? sm.e[k - 1] >> 16 : 0u);
  };
  const uint32_t kappa = tile_chain(
      [&](int k) {
        const uint32_t s = f(k);
        return Digit{s, s >> 16, s == kMask ? 1u : 0u};
      },
      [&](int k, uint32_t x) { sm.lo[k] = x; }, sm);
  const unsigned long long H = kappa + (unsigned long long)f(kTc)
      + ((unsigned long long)f(kTc + 1) << 16)
      + ((unsigned long long)f(kTc + 2) << 32);
  bool ones = true;
  for (int k = threadIdx.x * kPer; k < (threadIdx.x + 1) * kPer; ++k)
    if (k >= 4) ones &= sm.lo[k] == kMask;
  const bool waits = __syncthreads_and(ones);

  // -- the chained carry ---------------------------------------------------
  unsigned long long* slot = pub + 1 + sm.ticket;   // tile (b, c - 1) at
  const bool last = c + 1 == nc;                    // slot - batch
  if (!waits && !last && threadIdx.x == 0) publish(slot, H);
  if (threadIdx.x == 0) {
    unsigned long long x = kReady;
    if (c > 0)
      while (!((x = peek(slot - batch)) & kReady)) __nanosleep(64);
    sm.x = x & ~kReady;
  }
  __syncthreads();
  const unsigned long long X = sm.x;
  int32_t* ob = out + (size_t)b * out_width + c0;
  const uint32_t carry = tile_chain(
      [&](int k) {
        const uint32_t s = sm.lo[k]
            + (k < 4 ? (uint32_t)(X >> (16 * k)) & kMask : 0u);
        return Digit{s, s >> 16, s == kMask ? 1u : 0u};
      },
      [&](int k, uint32_t x) {
        if (k < need) ob[k] = (int32_t)x;
      },
      sm);
  if (waits && !last && threadIdx.x == 0) publish(slot, H + carry);
  // limbs [n, out_width) are zero
  int32_t* zb = out + (size_t)b * out_width;
  for (int k = n + c * kPThreads + threadIdx.x; k < out_width;
       k += nc * kPThreads)
    zb[k] = 0;
}

extern "C" int mul_pairs_tile() { return kTc; }

// u (batch, ldu) and v (batch, ldv) int32 limbs, of which the first wu
// and wv count; out (batch, out_width) int32; pub 1 + batch * ceil(n /
// kTc) 64-bit words (the ticket, then one publish word per tile), zeroed
// here with cudaMemsetAsync before the launch.  n <= min(out_width,
// wu + wv) limbs are computed.
extern "C" int mul_pairs_launch(const void* u, const void* v, void* out,
                                void* pub, int batch, int ldu, int ldv,
                                int wu, int wv, int n, int out_width,
                                void* stream) {
  if (batch <= 0 || out_width <= 0) return (int)cudaSuccess;
  if (wu <= 0 || wv <= 0 || n <= 0 || wu > ldu || wv > ldv ||
      n > out_width || (long long)n > (long long)wu + wv)
    return (int)cudaErrorInvalidValue;
  const int nc = (n + kTc - 1) / kTc;
  const long long blocks = (long long)batch * nc;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(pub, 0, 8 * (size_t)(1 + blocks), s);
  if (err != cudaSuccess) return (int)err;
  mul_pairs_kernel<<<(unsigned)blocks, kPThreads, 0, s>>>(
      (const int32_t*)u, (const int32_t*)v, (int32_t*)out,
      (unsigned long long*)pub, ldu, ldv, wu, wv, n, out_width, nc);
  return (int)cudaGetLastError();
}
