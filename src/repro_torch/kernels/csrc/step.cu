// One Refine iteration of the shifted-inverse Newton loop: two kernels.
//
//   powdiff  replaces repro/kernels/fused.py:_powdiff_kernel and
//            _powdiff_grid_kernel: vp = shift(v, -s) to the window, the
//            product p = vp * wq to 2*win limbs, and Algorithm 2's
//            sign/magnitude select (fused.py:_powdiff_glue).
//   update   replaces fused.py:_update_kernel and _update_grid_kernel:
//            tmp = wq * x, shift by 2m - h, add to or subtract from
//            shift(wq, m), floor correction, the -1 normalization shift
//            and the active-lane select (fused.py:_update_glue).
//
// The TPU needed two generations of each (unrolled and grid-scheduled)
// because of its VMEM budget; here one kernel per stage covers every
// window from 32 to 32778 limbs (a 2^18-bit modulus's precompute).
//
// Both products are digit GEMMs on the int8 tensor cores (digitmma.cuh)
// over the operands' significant limbs only, the longer operand as the
// window A and the shorter as the Toeplitz band B, both staged at two
// bytes per limb: 4 win + 400 bytes of shared memory, 131 KB at
// W = 32778.  An instance spreads over a thread-block cluster below 132
// lanes (8 blocks for the precompute's single lane): each block sums a
// balanced range of product columns into the instance's global scratch,
// and the cluster resolves the carries together.  Every select of the
// JAX glue is on a per-instance condition, and the cluster is one
// instance, so every block of a cluster takes the same branch; the
// glue's reductions and carry chains run cluster-wide, each block over
// its share of the positions.  update needs tmp only below limb
// max(h - 2m, 0) + win, so its product stops there.  Bound: the limb
// products of the clipped (and for update, cut) product (operations).
#include "digitmma.cuh"

using namespace digitmma;
using limbs::add_digit;
using limbs::MaxOp;
using limbs::MinOp;
using limbs::sub_digit;

namespace {

// Per-instance global scratch, shared by the instance's cluster: column
// sums (2*win x 8 bytes), resolve pieces (2*win x 4) and the product
// (2*win x 4).
__host__ __device__ size_t step_bytes(int win) {
  return limbs::align16(32 * (size_t)win);
}

__host__ __device__ size_t smem_bytes(int win) {
  return a_bytes(win) + b_bytes(win);
}

struct Scratch {
  uint64_t* col;
  uint32_t* e;
  uint32_t* p;
};

__device__ Scratch scratch_of(unsigned char* scratch, int b, int win) {
  unsigned char* base = scratch + (size_t)b * step_bytes(win);
  Scratch s;
  s.col = reinterpret_cast<uint64_t*>(base);
  s.e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)win);
  s.p = reinterpret_cast<uint32_t*>(base + 24 * (size_t)win);
  return s;
}

// Significant limbs of limb(0), ..., limb(n - 1) (arith.prec).
template <class F>
__device__ int prec_of(int n, F limb, limbs::Shared& sh) {
  int top = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (limb(i) != 0) top = i + 1;
  return limbs::block_reduce(top, MaxOp(), 0, sh);
}

// Limbs [0, n) of fa * fb (significant widths na, nb >= 1) into t.p,
// visible to the whole cluster on return.
template <class FA, class FB>
__device__ void product(FA fa, int na, FB fb, int nb, int n, int win,
                        unsigned char* smem, const Scratch& t, Block& st,
                        cg::cluster_group& cl) {
  unsigned char* A = smem;
  unsigned char* Bv = smem + a_bytes(win);
  if (na >= nb) {                      // B is the shorter operand
    stage_a_fn(A, win, fa, na);
    stage_b_fn(Bv, win, fb, nb);
  } else {
    stage_a_fn(A, win, fb, nb);
    stage_b_fn(Bv, win, fa, na);
  }
  __syncthreads();
  digit_product(A, 2 * max(na, nb), Bv, 2 * min(na, nb), n, t.col, st,
                (int)cl.block_rank(), (int)cl.num_blocks());
  cl.sync();                           // column sums visible to the cluster
  uint32_t* p = t.p;
  cluster_resolve(t.col, n, t.e, n,
                  [&](int i, uint32_t limb) { p[i] = limb; }, st, cl);
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
powdiff_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ w,
               const int32_t* __restrict__ hpd_, const int32_t* __restrict__ lpd_,
               const int32_t* __restrict__ s_, int32_t* __restrict__ sign_out,
               int32_t* __restrict__ x_out, unsigned char* scratch,
               int full_w, int win) {
  __shared__ Block st;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / cs;
  const int hpd = hpd_[b], lpd = lpd_[b], sft = s_[b];
  const int32_t* vb = v + (size_t)b * full_w;
  const int32_t* wb = w + (size_t)b * full_w;
  uint32_t* x = reinterpret_cast<uint32_t*>(x_out + (size_t)b * full_w);
  const Scratch t = scratch_of(scratch, b, win);
  auto vp = [&](int i) -> uint32_t {   // shift(v, -s) within the window
    const long src = (long)i + sft;
    return (src >= 0 && src < full_w) ? (uint32_t)vb[src] : 0u;
  };
  auto wq = [&](int i) -> uint32_t { return (uint32_t)wb[i]; };
  const int pv = prec_of(win, vp, st.sh), pw = prec_of(win, wq, st.sh);
  const int L = pv + pw - lpd + 1;
  const bool vwz = pv == 0 || pw == 0;
  const bool full = vwz || L >= hpd;
  const int np = vwz ? 0 : pv + pw;    // p < B^np, so its limbs [0, np)
  if (np > 0) product(vp, pv, wq, pw, np, win, smem, t, st, cl);
  const uint32_t* p = t.p;
  auto pat = [&](int i) -> uint32_t { return i < np ? p[i] : 0u; };
  auto put = [&](int i, uint32_t d) { x[i] = d; };
  int lo, hi;
  share(win, rank, cs, lo, hi);
  bool sign;
  if (vwz) {                                     // |B^h - 0| = B^h
    sign = hpd >= 0;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) x[i] = i == hpd;
  } else if (full) {
    // sign from prec(p) <= hpd; sub_pow's first nonzero limb >= hpd
    int plo, phi;
    share(np, rank, cs, plo, phi);
    int top = 0, first = np;
    for (int i = plo + threadIdx.x; i < phi; i += kThreads)
      if (p[i] != 0) {
        top = i + 1;
        if (i >= hpd) first = min(first, i);
      }
    sign = cluster_reduce(top, MaxOp(), 0, st, cl) <= hpd;
    if (sign) {                                  // B^h - p, low win limbs
      cluster_chain(
          win,
          [&](int i) {
            return add_digit(i < hpd ? kMask - pat(i) : 0u, i == 0);
          },
          false, put, st, cl);
    } else {                                     // p - B^h (sub_pow)
      const int n = cluster_reduce(first, MinOp(), np, st, cl);
      for (int i = lo + threadIdx.x; i < hi; i += kThreads)
        x[i] = (i >= hpd && i <= n) ? (pat(i) - 1u) & kMask : pat(i);
    }
  } else {
    // close branch: P = p mod B^L within the window, sign from its top
    int zlo, zhi;
    share(max(0, min(min(L, win), np)), rank, cs, zlo, zhi);
    int nz = 0;
    for (int i = zlo + threadIdx.x; i < zhi; i += kThreads) nz |= p[i] != 0;
    const bool pz = cluster_reduce(nz, MaxOp(), 0, st, cl) == 0;
    const uint32_t ptop = (L - 1 >= 0 && L - 1 < win) ? pat(L - 1) : 0u;
    sign = pz || ptop != 0;
    if (pz) {
      for (int i = lo + threadIdx.x; i < hi; i += kThreads) x[i] = 0;
    } else if (ptop == 0) {
      for (int i = lo + threadIdx.x; i < hi; i += kThreads)
        x[i] = i < L ? pat(i) : 0u;
    } else {                                     // B^L - P
      cluster_chain(
          win,
          [&](int i) {
            return add_digit(i < L ? kMask - pat(i) : 0u, i == 0);
          },
          false, put, st, cl);
    }
  }
  share(full_w - win, rank, cs, lo, hi);         // zero above the window
  for (int i = win + lo + threadIdx.x; i < win + hi; i += kThreads) x[i] = 0;
  if (rank == 0 && threadIdx.x == 0) sign_out[b] = sign;
}

__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
update_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ x,
              const int32_t* __restrict__ sign_, const int32_t* __restrict__ h_,
              const int32_t* __restrict__ m_, const int32_t* __restrict__ act_,
              int32_t* __restrict__ out, unsigned char* scratch, int full_w,
              int win) {
  __shared__ Block st;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / cs;
  const int32_t* wb = w + (size_t)b * full_w;
  const int32_t* xb = x + (size_t)b * full_w;
  uint32_t* ob = reinterpret_cast<uint32_t*>(out + (size_t)b * full_w);
  int lo, hi;
  if (!act_[b]) {             // inactive lane, the whole cluster: w as it is
    share(full_w, rank, cs, lo, hi);
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) ob[i] = wb[i];
    return;
  }
  const int h = h_[b], m = m_[b];
  const bool sign = sign_[b] != 0;
  const Scratch t = scratch_of(scratch, b, win);
  auto wq = [&](int i) -> uint32_t { return (uint32_t)wb[i]; };
  auto xq = [&](int i) -> uint32_t { return (uint32_t)xb[i]; };
  const int pw = prec_of(win, wq, st.sh), px = prec_of(win, xq, st.sh);
  // tmp = wq * x is read below limb max(h - 2m, 0) + win only
  const int off = h - 2 * m;
  const int n = (pw == 0 || px == 0)
      ? 0 : min(min(2 * win, pw + px), max(off, 0) + win);
  if (n > 0) product(wq, pw, xq, px, n, win, smem, t, st, cl);
  const uint32_t* tmp = t.p;

  // floor correction: a nonzero limb among the h - 2m dropped ones
  bool dropped = false;
  if (!sign) {
    share(max(0, min(off, n)), rank, cs, lo, hi);
    int nz = 0;
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) nz |= tmp[i] != 0;
    dropped = cluster_reduce(nz, MaxOp(), 0, st, cl) != 0;
  }

  // res = shift(wq, m) +/- shift(tmp, 2m - h), both within the window;
  // the floor correction is the subtraction's borrow-in; the -1
  // normalization shift stores res[i] at out[i - 1]
  auto sh_at = [&](int i) -> uint32_t {
    const long src = (long)i + off;
    return (src >= 0 && src < n) ? tmp[src] : 0u;
  };
  auto wm_at = [&](int i) -> uint32_t {
    const int src = i - m;
    return (src >= 0 && src < win) ? (uint32_t)wb[src] : 0u;
  };
  cluster_chain(
      win,
      [&](int i) {
        return sign ? add_digit(wm_at(i), sh_at(i))
                    : sub_digit(wm_at(i), sh_at(i));
      },
      !sign,
      [&](int i, uint32_t d) {
        if (i >= 1) ob[i - 1] = d;
      },
      st, cl, dropped ? 1u : 0u);
  // the chain's closing cluster.sync() keeps every block resident until
  // no block reads another's shared memory
  share(full_w - win + 1, rank, cs, lo, hi);
  for (int i = win - 1 + lo + threadIdx.x; i < win - 1 + hi; i += kThreads)
    ob[i] = 0;
}

extern "C" size_t step_scratch_bytes(int win) { return step_bytes(win); }

extern "C" size_t step_smem_bytes(int win) { return smem_bytes(win); }

extern "C" int powdiff_launch(const void* v, const void* w, const void* hpd,
                              const void* lpd, const void* s, void* sign,
                              void* x, void* scratch, int batch, int full_w,
                              int win, int* cluster, void* stream) {
  return (int)launch<powdiff_kernel>(
      batch, cluster, smem_bytes(win), (cudaStream_t)stream,
      (const int32_t*)v, (const int32_t*)w, (const int32_t*)hpd,
      (const int32_t*)lpd, (const int32_t*)s, (int32_t*)sign, (int32_t*)x,
      (unsigned char*)scratch, full_w, win);
}

extern "C" int update_launch(const void* w, const void* x, const void* sign,
                             const void* h, const void* m, const void* act,
                             void* out, void* scratch, int batch, int full_w,
                             int win, int* cluster, void* stream) {
  return (int)launch<update_kernel>(
      batch, cluster, smem_bytes(win), (cudaStream_t)stream,
      (const int32_t*)w, (const int32_t*)x, (const int32_t*)sign,
      (const int32_t*)h, (const int32_t*)m, (const int32_t*)act,
      (int32_t*)out, (unsigned char*)scratch, full_w, win);
}
