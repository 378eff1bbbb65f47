// Barrett reduction core in one kernel: the cached-inverse hot path of
// modular multiplication and modexp.
//
// Replaces repro/kernels/fused.py:_barrett_kernel and
// _barrett_grid_kernel: p = x * mu to 2W limbs, q = floor(p / B^h)
// truncated to W at a static h (fused.py:_quotient_glue), qv = (q * v)
// mod B^W, then the two conditional subtracts of fused.py:_barrett_glue
// (over: x < qv, so qhat = q + 1; under: r >= v after x - qv, so
// qhat = q - 1).  The context requires v >= 1, so there is no v = 0
// branch.
//
// One block per instance, as correct.cu.  x and mu, then v and q, are
// staged in shared memory (2W words: 131 KB for the 2^17-bit modulus,
// W = 16394); the products resolve into the per-instance global
// scratch.  A shared context (one mu and v for the whole batch) is read
// through a row stride of 0.  Each product runs over its operands'
// significant limbs only (x: its width; mu: prec(mu), about m + 3 for
// an m-limb modulus; q: prec(q); v: its width), which is the work the
// bound counts.  Bound: the limb products (operations).
#include "limbs.cuh"

using namespace limbs;

namespace {

// Per-instance scratch: column sums and resolve scratch of the 2W-limb
// product, the product itself (2W words), qv and x zero-padded to W
// (W words each).
__host__ __device__ size_t barrett_bytes(int full_w) {
  return align16(mul_scratch_bytes(2 * full_w) + 4 * (size_t)(4 * full_w));
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
barrett_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ mu,
               const int32_t* __restrict__ v, int32_t* __restrict__ r_out,
               unsigned char* scratch, int nx, int mu_stride, int nv,
               int v_stride, int full_w, int h) {
  __shared__ Shared sh;
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x, W = full_w;
  const int32_t* xb = x + (size_t)b * nx;
  const int32_t* mb = mu + (size_t)b * mu_stride;
  const int32_t* vb = v + (size_t)b * v_stride;
  uint32_t* ro = reinterpret_cast<uint32_t*>(r_out + (size_t)b * W);
  unsigned char* base = scratch + (size_t)b * barrett_bytes(W);
  uint64_t* col = reinterpret_cast<uint64_t*>(base);
  uint32_t* e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)W);
  uint32_t* p = reinterpret_cast<uint32_t*>(base + 24 * (size_t)W);
  uint32_t* qv = p + 2 * W;
  uint32_t* xs = qv + W;
  uint32_t* a = smem;
  uint32_t* c = smem + W;

  // p = x * mu to 2W limbs
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const uint32_t xi = i < nx ? (uint32_t)xb[i] : 0u;
    a[i] = xi;
    xs[i] = xi;
    c[i] = (uint32_t)mb[i];
  }
  __syncthreads();
  const int nmu = prec(c, W, sh);
  mul(a, min(nx, W), c, nmu, 2 * W, col, e, p, sh);

  // q = floor(p / B^h) truncated to W; stage v and q
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const long src = (long)i + h;
    c[i] = src < 2 * (long)W ? p[src] : 0u;
    a[i] = i < nv ? (uint32_t)vb[i] : 0u;
  }
  __syncthreads();
  const int nq = prec(c, W, sh);
  // qv = (v * q) mod B^W
  mul(a, min(nv, W), c, nq, W, col, e, qv, sh);

  if (lt(xs, qv, W, sh))                         // over: qhat = q + 1
    scan_apply(W, [&](int i) { return sub_digit(qv[i], a[i]); }, true, 0u,
               qv, sh);
  scan_apply(W, [&](int i) { return sub_digit(xs[i], qv[i]); }, true, 0u, ro,
             sh);
  if (!lt(ro, a, W, sh))                         // under: qhat = q - 1
    scan_apply(W, [&](int i) { return sub_digit(ro[i], a[i]); }, true, 0u,
               ro, sh);
}

extern "C" size_t barrett_scratch_bytes(int full_w) {
  return barrett_bytes(full_w);
}

extern "C" int barrett_launch(const void* x, const void* mu, const void* v,
                              void* r, void* scratch, int batch, int nx,
                              int mu_stride, int nv, int v_stride,
                              int full_w, int h, void* stream) {
  return (int)launch<barrett_kernel>(batch, 8 * (size_t)full_w,
                     (cudaStream_t)stream, (const int32_t*)x,
                     (const int32_t*)mu, (const int32_t*)v, (int32_t*)r,
                     (unsigned char*)scratch, nx, mu_stride, nv, v_stride,
                     full_w, h);
}
