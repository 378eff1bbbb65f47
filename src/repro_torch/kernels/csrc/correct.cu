// divmod finalization in one kernel.
//
// Replaces repro/kernels/fused.py:_correct_kernel and
// _correct_grid_kernel: q = floor(u * si / B^h) from the 2W-limb product
// (fused.py:_quotient_glue), mm = (v * q) mod B^W, then Algorithm 3's
// delta in {-1, 0, +1} compare-and-correct and the total extension
// divmod(u, 0) = (0, u) (fused.py:_correct_glue).  One block per
// instance; both products stage their operands in shared memory and
// resolve into the per-instance global scratch.  Bound: the limb
// products of u * si (W^2) and of the truncated v * q (~W^2 / 2)
// (operations).
#include "limbs.cuh"

using namespace limbs;

namespace {

// Per-instance scratch: column sums and resolve scratch of the 2W-limb
// product, the product itself (2W words), q and mm (W words each).
__host__ __device__ size_t correct_bytes(int full_w) {
  return align16(mul_scratch_bytes(2 * full_w) + 4 * (size_t)(4 * full_w));
}

}  // namespace

__global__ void __launch_bounds__(kThreads)
correct_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
               const int32_t* __restrict__ si, const int32_t* __restrict__ h_,
               int32_t* __restrict__ q_out, int32_t* __restrict__ r_out,
               unsigned char* scratch, int full_w) {
  __shared__ Shared sh;
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x, W = full_w, h = h_[b];
  const uint32_t* ub = reinterpret_cast<const uint32_t*>(u + (size_t)b * W);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(v + (size_t)b * W);
  const uint32_t* sb = reinterpret_cast<const uint32_t*>(si + (size_t)b * W);
  uint32_t* qo = reinterpret_cast<uint32_t*>(q_out + (size_t)b * W);
  uint32_t* ro = reinterpret_cast<uint32_t*>(r_out + (size_t)b * W);
  unsigned char* base = scratch + (size_t)b * correct_bytes(W);
  uint64_t* col = reinterpret_cast<uint64_t*>(base);
  uint32_t* e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)W);
  uint32_t* p = reinterpret_cast<uint32_t*>(base + 24 * (size_t)W);
  uint32_t* q = p + 2 * W;
  uint32_t* mm = q + W;
  uint32_t* a = smem;
  uint32_t* c = smem + W;

  // p = u * si to 2W limbs; q = floor(p / B^h) truncated to W
  for (int i = threadIdx.x; i < W; i += kThreads) {
    a[i] = ub[i];
    c[i] = sb[i];
  }
  __syncthreads();
  mul(a, W, c, W, 2 * W, col, e, p, sh);
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const long src = (long)i + h;
    const uint32_t qi = (src >= 0 && src < 2 * W) ? p[src] : 0u;
    q[i] = qi;
    a[i] = vb[i];
    c[i] = qi;
  }
  __syncthreads();
  // mm = (v * q) mod B^W
  mul(a, W, c, W, W, col, e, mm, sh);

  const bool vz = !any_nonzero(vb, W, sh);
  if (vz) {                                      // divmod(u, 0) = (0, u)
    for (int i = threadIdx.x; i < W; i += kThreads) {
      qo[i] = 0;
      ro[i] = ub[i];
    }
    return;
  }
  if (lt(ub, mm, W, sh)) {                       // delta = -1
    scan_apply(W, [&](int i) { return sub_digit(q[i], i == 0); }, true, 0u,
               q, sh);
    scan_apply(W, [&](int i) { return sub_digit(mm[i], vb[i]); }, true, 0u,
               mm, sh);
  }
  scan_apply(W, [&](int i) { return sub_digit(ub[i], mm[i]); }, true, 0u, ro,
             sh);
  if (!lt(ro, vb, W, sh)) {                      // delta = +1
    scan_apply(W, [&](int i) { return add_digit(q[i], i == 0); }, false, 0u,
               q, sh);
    scan_apply(W, [&](int i) { return sub_digit(ro[i], vb[i]); }, true, 0u,
               ro, sh);
  }
  for (int i = threadIdx.x; i < W; i += kThreads) qo[i] = q[i];
}

extern "C" size_t correct_scratch_bytes(int full_w) {
  return correct_bytes(full_w);
}

extern "C" int correct_launch(const void* u, const void* v, const void* si,
                              const void* h, void* q, void* r, void* scratch,
                              int batch, int full_w, void* stream) {
  return (int)launch<correct_kernel>(batch, 8 * (size_t)full_w,
                     (cudaStream_t)stream, (const int32_t*)u,
                     (const int32_t*)v, (const int32_t*)si, (const int32_t*)h,
                     (int32_t*)q, (int32_t*)r, (unsigned char*)scratch,
                     full_w);
}
