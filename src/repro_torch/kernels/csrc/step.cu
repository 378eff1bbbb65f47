// One Refine iteration of the shifted-inverse Newton loop: two kernels.
//
//   powdiff  replaces repro/kernels/fused.py:_powdiff_kernel and
//            _powdiff_grid_kernel: vp = shift(v, -s) to the window, the
//            product p = vp * wq to 2*win limbs, and Algorithm 2's
//            sign/magnitude select (fused.py:_powdiff_glue).
//   update   replaces fused.py:_update_kernel and _update_grid_kernel:
//            tmp = wq * x to 2*win limbs, shift by 2m - h, add to or
//            subtract from shift(wq, m), floor correction, the -1
//            normalization shift and the active-lane select
//            (fused.py:_update_glue).
//
// The TPU needed two generations of each (unrolled and grid-scheduled)
// because of its VMEM budget; one block per instance with the operands
// in shared memory and the product in global scratch covers every window
// from 32 to 16392 limbs.  Every select of the JAX glue is on a
// per-instance condition, so each block computes the scalars first and
// then only the branch its instance takes.  Bound: the limb products of
// the window product (operations).
#include "limbs.cuh"

using namespace limbs;

namespace {

// Per-instance scratch: column sums (2*win x 8 bytes), resolve scratch
// (2*win x 4) and the product (2*win x 4).
__host__ __device__ size_t step_bytes(int win) {
  return align16(mul_scratch_bytes(2 * win) + 4 * (size_t)(2 * win));
}

struct Scratch {
  uint64_t* col;
  uint32_t* e;
  uint32_t* p;
};

__device__ Scratch scratch_of(unsigned char* scratch, int win) {
  unsigned char* base = scratch + (size_t)blockIdx.x * step_bytes(win);
  Scratch s;
  s.col = reinterpret_cast<uint64_t*>(base);
  s.e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)win);
  s.p = reinterpret_cast<uint32_t*>(base + 24 * (size_t)win);
  return s;
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
powdiff_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ w,
               const int32_t* __restrict__ hpd_, const int32_t* __restrict__ lpd_,
               const int32_t* __restrict__ s_, int32_t* __restrict__ sign_out,
               int32_t* __restrict__ x_out, unsigned char* scratch,
               int full_w, int win) {
  __shared__ Shared sh;
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int hpd = hpd_[b], lpd = lpd_[b], sft = s_[b];
  const int32_t* vb = v + (size_t)b * full_w;
  const int32_t* wb = w + (size_t)b * full_w;
  int32_t* xb = x_out + (size_t)b * full_w;
  uint32_t* vp = smem;            // shift(v, -s) masked to the window
  uint32_t* wq = smem + win;      // w masked to the window
  for (int i = threadIdx.x; i < win; i += kThreads) {
    const long src = (long)i + sft;
    vp[i] = (src >= 0 && src < full_w) ? (uint32_t)vb[src] : 0u;
    wq[i] = (uint32_t)wb[i];
  }
  __syncthreads();
  const Scratch t = scratch_of(scratch, win);
  const int w2 = 2 * win;
  mul(vp, win, wq, win, w2, t.col, t.e, t.p, sh);
  const uint32_t* p = t.p;

  const int pv = prec(vp, win, sh), pw = prec(wq, win, sh);
  const int L = pv + pw - lpd + 1;
  const bool vwz = pv == 0 || pw == 0;
  const bool full = vwz || L >= hpd;
  const bool sign_full = prec(p, w2, sh) <= hpd;
  bool sign;
  uint32_t* x = reinterpret_cast<uint32_t*>(xb);
  if (full) {
    sign = sign_full;
    if (vwz) {                                   // |B^h - 0| = B^h
      for (int i = threadIdx.x; i < win; i += kThreads) x[i] = i == hpd;
    } else if (sign_full) {                      // B^h - p, low win limbs
      scan_apply(
          win,
          [&](int i) {
            return add_digit(i < hpd ? kMask - p[i] : 0u, i == 0);
          },
          false, 0u, x, sh);
    } else {                                     // p - B^h (sub_pow)
      int n = w2;
      for (int i = threadIdx.x; i < w2; i += kThreads)
        if (i >= hpd && p[i] != 0) n = min(n, i);
      n = block_reduce(n, MinOp(), w2, sh);
      for (int i = threadIdx.x; i < win; i += kThreads)
        x[i] = (i >= hpd && i <= n) ? (p[i] - 1u) & kMask : p[i];
    }
  } else {
    // close branch: P = p mod B^L within the window, sign from its top
    int nz = 0;
    for (int i = threadIdx.x; i < win; i += kThreads)
      nz |= (i < L && p[i] != 0);
    const bool pz = block_reduce(nz, MaxOp(), 0, sh) == 0;
    const uint32_t ptop = (L - 1 >= 0 && L - 1 < win) ? p[L - 1] : 0u;
    sign = pz || ptop != 0;
    if (pz) {
      for (int i = threadIdx.x; i < win; i += kThreads) x[i] = 0;
    } else if (ptop == 0) {
      for (int i = threadIdx.x; i < win; i += kThreads)
        x[i] = i < L ? p[i] : 0u;
    } else {                                     // B^L - P
      scan_apply(
          win,
          [&](int i) {
            return add_digit(i < L ? kMask - p[i] : 0u, i == 0);
          },
          false, 0u, x, sh);
    }
  }
  for (int i = win + threadIdx.x; i < full_w; i += kThreads) x[i] = 0;
  if (threadIdx.x == 0) sign_out[b] = sign;
}

__global__ void __launch_bounds__(kThreads)
update_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ x,
              const int32_t* __restrict__ sign_, const int32_t* __restrict__ h_,
              const int32_t* __restrict__ m_, const int32_t* __restrict__ act_,
              int32_t* __restrict__ out, unsigned char* scratch, int full_w,
              int win) {
  __shared__ Shared sh;
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int32_t* wb = w + (size_t)b * full_w;
  const int32_t* xb = x + (size_t)b * full_w;
  int32_t* ob = out + (size_t)b * full_w;
  if (!act_[b]) {                                // inactive lane: w as it is
    for (int i = threadIdx.x; i < full_w; i += kThreads) ob[i] = wb[i];
    return;
  }
  const int h = h_[b], m = m_[b];
  const bool sign = sign_[b] != 0;
  uint32_t* wq = smem;
  uint32_t* xq = smem + win;
  for (int i = threadIdx.x; i < win; i += kThreads) {
    wq[i] = (uint32_t)wb[i];
    xq[i] = (uint32_t)xb[i];
  }
  __syncthreads();
  const Scratch t = scratch_of(scratch, win);
  const int w2 = 2 * win;
  mul(wq, win, xq, win, w2, t.col, t.e, t.p, sh);
  const uint32_t* tmp = t.p;

  // floor correction: a nonzero limb among the h - 2m dropped ones
  const int drop = min(h - 2 * m, w2);
  int nz = 0;
  for (int i = threadIdx.x; i < drop; i += kThreads) nz |= tmp[i] != 0;
  const bool dropped = block_reduce(nz, MaxOp(), 0, sh) != 0;

  // res = shift(wq, m) +/- shift(tmp, 2m - h), both within the window;
  // the floor correction is the subtraction's borrow-in
  const int off = h - 2 * m;
  auto sh_at = [&](int i) -> uint32_t {
    const long src = (long)i + off;
    return (src >= 0 && src < w2) ? tmp[src] : 0u;
  };
  auto wm_at = [&](int i) -> uint32_t {
    const int src = i - m;
    return (src >= 0 && src < win) ? wq[src] : 0u;
  };
  uint32_t* res = t.e;                           // free after the product
  if (sign) {
    scan_apply(win, [&](int i) { return add_digit(wm_at(i), sh_at(i)); },
               false, 0u, res, sh);
  } else {
    scan_apply(win, [&](int i) { return sub_digit(wm_at(i), sh_at(i)); },
               true, dropped ? 1u : 0u, res, sh);
  }
  // the -1 normalization shift, back into the full-width iterate
  for (int i = threadIdx.x; i < full_w; i += kThreads)
    ob[i] = i + 1 < win ? (int32_t)res[i + 1] : 0;
}

extern "C" size_t step_scratch_bytes(int win) { return step_bytes(win); }

extern "C" int powdiff_launch(const void* v, const void* w, const void* hpd,
                              const void* lpd, const void* s, void* sign,
                              void* x, void* scratch, int batch, int full_w,
                              int win, void* stream) {
  return (int)launch<powdiff_kernel>(batch, 8 * (size_t)win,
                     (cudaStream_t)stream, (const int32_t*)v,
                     (const int32_t*)w, (const int32_t*)hpd,
                     (const int32_t*)lpd, (const int32_t*)s, (int32_t*)sign,
                     (int32_t*)x, (unsigned char*)scratch, full_w, win);
}

extern "C" int update_launch(const void* w, const void* x, const void* sign,
                             const void* h, const void* m, const void* act,
                             void* out, void* scratch, int batch, int full_w,
                             int win, void* stream) {
  return (int)launch<update_kernel>(batch, 8 * (size_t)win,
                     (cudaStream_t)stream, (const int32_t*)w,
                     (const int32_t*)x, (const int32_t*)sign,
                     (const int32_t*)h, (const int32_t*)m,
                     (const int32_t*)act, (int32_t*)out,
                     (unsigned char*)scratch, full_w, win);
}
