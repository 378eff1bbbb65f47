// A division's set-up in one kernel: the inverse's constructor
// (core/shinv.py:_Inverse.__init__) and, for divmod_batch, the pads of
// u and v and h = prec(u), one block a lane.
//
// Replaces no TPU kernel: the JAX package does this set-up in jnp glue
// (repro/core/shinv.py), which XLA fuses into a few passes.  In PyTorch
// the same glue (kept in core/shinv.py as the plain version) is ~150
// ATen launches a call: the two pads, three full-width prec, the
// Kogge-Stone carry scan of add(v, v), gt_pow and is_pow, the gathers
// of shift and take_limb, _initial_w0's and ceil_log2's loops on (batch,)
// tensors.
//
// Per lane, bit for bit with that glue:
//   uw, vw   u and v (in_w limbs) zero-padded to W = full_w limbs
//            (divmod_batch; with no u, h is given and v is already W wide)
//   vl       the lifted v: shift(v, 1) where prec(v) <= 1, else v
//   w        the first iterate: zero but limbs GUARD .. GUARD + 2, the
//            three limbs of floor(B^3 / V), V the two top limbs of vl
//   scal     rows h (prec(u), or the given h), k = prec(vl) - 1,
//            hk = h + lift - k, need, l = 2 (int32, each (batch,))
//   flags    rows case_zero (vl > B^h'), case_one (2 vl > B^h' and not
//            case_zero), case_pow (vl == B^k), h' = h + lift (bool bytes)
// 2 vl > B^h' needs no carry scan: doubling is a one-bit shift, so limb
// i of (2v mod B^W) is ((v[i] << 1) & MASK) | (v[i-1] >> 15), and its
// prec, its nonzero count and whether a limb is 1 come from the same
// pass that finds prec(v).  A lifted (single-limb) v is v0 * B, whose
// statistics follow from v0 alone.
//
// Bound: bytes.  It reads u and v once and writes uw, vw, vl and w once:
// (2 in_w + 4 W) x 4 bytes a lane, 6.4 GB and ~1.9 ms at 3.35 TB/s both
// for 2^18 bits x 16,384 lanes (W = 16,392) and 2^15 bits x 131,072
// (W = 2,056).  Design: each thread moves VEC limbs at a time (16-byte
// accesses where the widths and addresses allow, else 8 or 4), keeps its
// statistics in registers, and the block reduces them once; the block
// size follows W (about four chunks a thread, 32 to 1,024 threads), so a
// lane is one pass with every load in flight.  Thread 0 then does the
// lane's scalar work and patches the few limbs that depend on it (vl's
// limbs 0 and 1, w's limbs GUARD .. GUARD + 2), after the barrier that
// orders them behind the pass's stores.
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kMask = 0xFFFFu;
constexpr int kMaxThreads = 1024;
constexpr int kGuard = 2;           // core/shinv.py:GUARD

template <int VEC>
struct alignas(4 * VEC) Chunk {
  uint32_t x[VEC];
};

// What a lane's pass gathers; each thread sees its limbs in increasing
// order, so the tops are plain assignments.
struct Stats {
  int pu;                     // prec(u)
  unsigned long long vtop;    // (i + 1) << 32 | v[i] << 16 | v[i - 1], i
                              // the top nonzero limb of v
  int nv;                     // nonzero limbs of v, saturated at 2
  int onev;                   // some limb of v is 1
  int pt;                     // prec(t), t = 2v mod B^W
  int nt;                     // nonzero limbs of t, saturated at 2
  int onet;                   // some limb of t is 1
};

__device__ inline void see_v(Stats& s, int i, uint32_t x, uint32_t prev) {
  if (x) {
    s.nv = min(s.nv + 1, 2);
    s.onev |= x == 1;
    s.vtop = (unsigned long long)(i + 1) << 32 | x << 16 | prev;
  }
}

__device__ inline void see_t(Stats& s, int i, uint32_t t) {
  if (t) {
    s.pt = i + 1;
    s.nt = min(s.nt + 1, 2);
    s.onet |= t == 1;
  }
}

__device__ inline void combine(Stats& a, const Stats& b) {
  a.pu = max(a.pu, b.pu);
  a.vtop = a.vtop > b.vtop ? a.vtop : b.vtop;
  a.nv = min(a.nv + b.nv, 2);
  a.onev |= b.onev;
  a.pt = max(a.pt, b.pt);
  a.nt = min(a.nt + b.nt, 2);
  a.onet |= b.onet;
}

__device__ inline Stats shfl_xor(const Stats& s, int off) {
  const unsigned all = 0xffffffffu;
  return {__shfl_xor_sync(all, s.pu, off),
          __shfl_xor_sync(all, s.vtop, off),
          __shfl_xor_sync(all, s.nv, off),
          __shfl_xor_sync(all, s.onev, off),
          __shfl_xor_sync(all, s.pt, off),
          __shfl_xor_sync(all, s.nt, off),
          __shfl_xor_sync(all, s.onet, off)};
}

// int32 arithmetic that wraps as torch's does
__device__ inline int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// u == B^p from u's prec, nonzero count and whether a limb is 1
// (arith.eq_pow: a p outside [0, W) asks for u == 0)
__device__ inline bool eq_pow(int prec, int nnz, int one, int p, int W) {
  return 0 <= p && p < W ? nnz == 1 && one && prec - 1 == p : prec == 0;
}

}  // namespace

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
prologue_kernel(const uint32_t* __restrict__ u, const uint32_t* __restrict__ v,
                const int32_t* __restrict__ h_in, uint32_t* __restrict__ uw,
                uint32_t* __restrict__ vw, uint32_t* __restrict__ vl,
                uint32_t* __restrict__ w, int32_t* __restrict__ scal,
                uint8_t* __restrict__ flags, int batch, int in_w,
                int full_w) {
  using C = Chunk<VEC>;
  __shared__ Stats part[kMaxThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int nin = in_w / VEC, nall = full_w / VEC;
  const C* ub = u ? reinterpret_cast<const C*>(u + (size_t)b * in_w) : nullptr;
  const C* vb = reinterpret_cast<const C*>(v + (size_t)b * in_w);
  C* uo = uw ? reinterpret_cast<C*>(uw + (size_t)b * full_w) : nullptr;
  C* vo = vw ? reinterpret_cast<C*>(vw + (size_t)b * full_w) : nullptr;
  C* lo = reinterpret_cast<C*>(vl + (size_t)b * full_w);
  C* wo = reinterpret_cast<C*>(w + (size_t)b * full_w);
  C zero;
#pragma unroll
  for (int j = 0; j < VEC; ++j) zero.x[j] = 0;

  Stats st = {0, 0ull, 0, 0, 0, 0, 0};
  uint32_t v0 = 0;
  // the pass over the inputs; the trip count is uniform over the block,
  // so every lane of a warp reaches the shuffle
  for (int base = 0; base < nin; base += blockDim.x) {
    const int c = base + tid;
    const bool on = c < nin;
    C cv = zero, cu = zero;
    if (on) {
      cv = vb[c];
      if (ub) cu = ub[c];
    }
    // v's limb below this chunk: the neighbour's top limb, or a load
    // (one limb a warp, from cache) for the first lane
    uint32_t prev = __shfl_up_sync(0xffffffffu, cv.x[VEC - 1], 1);
    if (lane == 0) prev = on && c > 0 ? v[(size_t)b * in_w + c * VEC - 1] : 0;
    if (on) {
      if (c == 0) v0 = cv.x[0];
      const int i0 = c * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const uint32_t x = cv.x[j], p = j ? cv.x[j - 1] : prev;
        see_v(st, i0 + j, x, p);
        see_t(st, i0 + j, ((x << 1) & kMask) | (p >> 15));
        if (ub && cu.x[j]) st.pu = i0 + j + 1;
      }
      if (c == nin - 1 && in_w < full_w)        // t's limb in_w
        see_t(st, in_w, cv.x[VEC - 1] >> 15);
      if (uo) uo[c] = cu;
      if (vo) vo[c] = cv;
      lo[c] = cv;
      wo[c] = zero;
    }
  }
  for (int c = nin + tid; c < nall; c += blockDim.x) {   // the pad
    if (uo) uo[c] = zero;
    if (vo) vo[c] = zero;
    lo[c] = zero;
    wo[c] = zero;
  }

  for (int off = 16; off > 0; off >>= 1) combine(st, shfl_xor(st, off));
  if (lane == 0) part[tid >> 5] = st;
  __syncthreads();            // also orders the pass's stores before
  if (tid != 0) return;       // thread 0's patches below
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) combine(st, part[i]);

  const int W = full_w;
  const int h = ub ? st.pu : h_in[b];
  const int pv = (int)(st.vtop >> 32);
  const bool lift = pv <= 1;                  // single-limb v -> v0 * B
  const int hl = wrap_add(h, lift);
  int pvl, pt, nt, onet;
  uint32_t V;                                 // vl's limbs k - 1 and k
  if (lift) {
    const uint32_t t1 = (v0 << 1) & kMask, t2 = v0 >> 15;   // 2 v0 B
    pvl = v0 ? 2 : 0;
    V = v0 << 16;
    pt = t2 ? 3 : t1 ? 2 : 0;
    nt = (t1 != 0) + (t2 != 0);
    onet = t2 == 1;                           // t1 is even
  } else {
    pvl = pv;
    V = (uint32_t)(st.vtop & 0xFFFFFFFFull);
    pt = st.pt;
    nt = st.nt;
    onet = st.onet;
  }
  const int k = pvl - 1;
  const bool is_pow = st.nv == 1 && st.onev;  // lifting moves the limb
  const bool zero_case = pvl > hl && !eq_pow(pvl, st.nv, st.onev, hl, W);
  const bool one_case = pt > hl && !eq_pow(pt, nt, onet, hl, W) && !zero_case;

  // _initial_w0: floor(B^3 / V) with the uint32 wrap of q1 at V = 1 and
  // V = 0 raised to 1
  const unsigned long long two32 = 1ull << 32, Vc = V ? V : 1;
  const unsigned long long q1 = ((two32 - Vc) / Vc + 1) & 0xFFFFFFFFull;
  unsigned long long t = (two32 - q1 * Vc) & 0xFFFFFFFFull, q2 = 0;
  for (int i = 0; i < 16; ++i) {
    t <<= 1;
    const bool geq = t >= Vc;
    if (geq) t -= Vc;
    q2 = q2 << 1 | geq;
  }

  // need = ceil_log2(hk - 1) + 2 where hk - 1 >= 2, else 2
  const int hk = wrap_add(hl, -k), n = wrap_add(hk, -1);
  int need = 2;
  if (n >= 2)
    for (int j = 0; j < 31; ++j) need += (1 << j) < n;

  scal[b] = h;
  scal[batch + b] = k;
  scal[2 * batch + b] = hk;
  scal[3 * batch + b] = need;
  scal[4 * batch + b] = 2;                    // l
  flags[b] = zero_case;
  flags[batch + b] = one_case;
  flags[2 * batch + b] = is_pow;
  uint32_t* vlb = vl + (size_t)b * W;
  uint32_t* wb = w + (size_t)b * W;
  if (lift) {
    vlb[0] = 0;
    vlb[1] = v0;
  }
  wb[kGuard] = (uint32_t)(q2 & kMask);
  wb[kGuard + 1] = (uint32_t)(q1 & kMask);
  wb[kGuard + 2] = (uint32_t)(q1 >> 16);
}

namespace {

template <int VEC>
cudaError_t launch(const void* u, const void* v, const void* h, void* uw,
                   void* vw, void* vl, void* w, void* scal, void* flags,
                   int batch, int in_w, int full_w, cudaStream_t stream) {
  const int chunks = full_w / VEC;
  int threads = 32;
  while (threads < kMaxThreads && 4 * threads < chunks) threads *= 2;
  prologue_kernel<VEC><<<batch, threads, 0, stream>>>(
      (const uint32_t*)u, (const uint32_t*)v, (const int32_t*)h,
      (uint32_t*)uw, (uint32_t*)vw, (uint32_t*)vl, (uint32_t*)w,
      (int32_t*)scal, (uint8_t*)flags, batch, in_w, full_w);
  return cudaGetLastError();
}

bool aligned(int vec, int in_w, int full_w,
             std::initializer_list<const void*> ptrs) {
  if (in_w % vec || full_w % vec) return false;
  for (const void* p : ptrs)
    if ((uintptr_t)p % (4 * vec)) return false;
  return true;
}

}  // namespace

// u and uw may be null (then h is read, and nothing of u is written), vw
// may be null; in_w <= full_w, full_w >= GUARD + 3.
extern "C" int prologue_launch(const void* u, const void* v, const void* h,
                               void* uw, void* vw, void* vl, void* w,
                               void* scal, void* flags, int batch, int in_w,
                               int full_w, void* stream) {
  if (batch <= 0 || in_w < 1 || in_w > full_w || full_w < kGuard + 3 ||
      (u == nullptr) == (h == nullptr) || (u == nullptr) != (uw == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto ptrs = {u, v, (const void*)uw, (const void*)vw, (const void*)vl,
                     (const void*)w};
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned(4, in_w, full_w, ptrs))
    return (int)launch<4>(u, v, h, uw, vw, vl, w, scal, flags, batch, in_w,
                          full_w, s);
  if (aligned(2, in_w, full_w, ptrs))
    return (int)launch<2>(u, v, h, uw, vw, vl, w, scal, flags, batch, in_w,
                          full_w, s);
  return (int)launch<1>(u, v, h, uw, vw, vl, w, scal, flags, batch, in_w,
                        full_w, s);
}
