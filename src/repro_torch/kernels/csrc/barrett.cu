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
// Both products are digit GEMMs on the int8 tensor cores
// (digitmma.cuh), over the operands' significant limbs only (x: prec(x);
// mu: prec(mu), about m + 3 for an m-limb modulus; q: prec(q); v:
// prec(v)), which is the work the bound counts.  Shared memory holds x
// (A layout), mu (B layout, later q in A layout) and v (B layout) at two
// bytes per limb: 161 KB at a 2^18-bit modulus (W = 32778).  An
// instance spreads over a thread-block cluster below 132 lanes: each
// block sums a balanced range of product columns into the instance's
// global scratch; the cluster resolves the carries of p together, and
// each block writes its limbs of q into every block's shared memory
// over distributed shared memory; then q * v the same way, and the
// comparisons and subtract chains run cluster-wide.  A shared context
// (one mu and v for the whole batch) is read through a row stride of 0
// and never copied per lane.  Bound: the limb products (operations).
#include "digitmma.cuh"

using namespace digitmma;
using limbs::sub_digit;

namespace {

// Per-instance global scratch: 64-bit column sums and resolve pieces of
// a 2W-limb product, and qv (W words).
__host__ __device__ size_t barrett_bytes(int full_w) {
  return limbs::align16(28 * (size_t)full_w);
}

__host__ __device__ size_t mq_bytes(int full_w) {
  return a_bytes(full_w) > b_bytes(full_w) ? a_bytes(full_w)
                                           : b_bytes(full_w);
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
barrett_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ mu,
               const int32_t* __restrict__ v, int32_t* __restrict__ r_out,
               unsigned char* scratch, int nx, int mu_stride, int nv,
               int v_stride, int full_w, int h) {
  __shared__ Block st;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / cs, W = full_w;
  const int32_t* xb = x + (size_t)b * nx;
  const int32_t* mb = mu + (size_t)b * mu_stride;
  const int32_t* vb = v + (size_t)b * v_stride;
  uint32_t* ro = reinterpret_cast<uint32_t*>(r_out + (size_t)b * W);
  unsigned char* base = scratch + (size_t)b * barrett_bytes(W);
  uint64_t* col = reinterpret_cast<uint64_t*>(base);
  uint32_t* e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)W);
  uint32_t* qv = reinterpret_cast<uint32_t*>(base + 24 * (size_t)W);
  unsigned char* X = smem;
  unsigned char* MQ = X + a_bytes(nx);
  unsigned char* V = MQ + mq_bytes(W);
  uint16_t* q16 = reinterpret_cast<uint16_t*>(MQ) + kAPad / 2;

  // significant widths, then staging
  auto gp = [](const int32_t* a) { return reinterpret_cast<const uint32_t*>(a); };
  const int px = limbs::prec(gp(xb), min(nx, W), st.sh);
  const int pmu = limbs::prec(gp(mb), W, st.sh);
  const int pv = limbs::prec(gp(vb), min(nv, W), st.sh);
  stage_a(X, nx, xb, px);
  stage_b(MQ, W, mb, pmu);
  stage_b(V, nv, vb, pv);
  __syncthreads();

  // p = x * mu; nonzero below px + pmu limbs
  const int np = min(2 * W, px + pmu);
  digit_product(X, 2 * px, MQ, 2 * pmu, np, col, st, rank, cs);
  cl.sync();               // column sums visible; x and mu read everywhere

  // q = floor(p / B^h) cut to W, into every block's MQ (A layout)
  zero_bytes(MQ, a_bytes(W));
  const int nq = max(0, min(W, np - h));
  cluster_resolve(col, np, e, np, [&](int i, uint32_t limb) {
    if (i >= h && i - h < nq)
      for (int r = 0; r < cs; ++r)
        cl.map_shared_rank(q16, r)[i - h] = (uint16_t)limb;
  }, st, cl);
  int top = 0;
  for (int i = threadIdx.x; i < nq; i += kThreads)
    if (q16[i] != 0) top = i + 1;
  const int pq = limbs::block_reduce(top, limbs::MaxOp(), 0, st.sh);

  // qv = (q * v) mod B^W
  digit_product(MQ, 2 * pq, V, 2 * pv, min(W, pq + pv), col, st, rank, cs);
  cl.sync();
  cluster_resolve(col, min(W, pq + pv), e, W,
                  [&](int i, uint32_t limb) { qv[i] = limb; }, st, cl);

  auto xat = [&](int i) { return i < nx ? (uint32_t)xb[i] : 0u; };
  auto vat = [&](int i) { return i < nv ? (uint32_t)vb[i] : 0u; };
  auto qat = [&](int i) { return qv[i]; };
  auto rat = [&](int i) { return ro[i]; };
  if (cluster_lt(W, xat, qat, st, cl))             // over: qhat = q + 1
    cluster_chain(W, [&](int i) { return sub_digit(qv[i], vat(i)); }, true,
                  [&](int i, uint32_t d) { qv[i] = d; }, st, cl);
  cluster_chain(W, [&](int i) { return sub_digit(xat(i), qv[i]); }, true,
                [&](int i, uint32_t d) { ro[i] = d; }, st, cl);
  if (!cluster_lt(W, rat, vat, st, cl))            // under: qhat = q - 1
    cluster_chain(W, [&](int i) { return sub_digit(ro[i], vat(i)); }, true,
                  [&](int i, uint32_t d) { ro[i] = d; }, st, cl);
}

extern "C" size_t barrett_scratch_bytes(int full_w) {
  return barrett_bytes(full_w);
}

extern "C" size_t barrett_smem_bytes(int nx, int nv, int full_w) {
  return a_bytes(nx) + mq_bytes(full_w) + b_bytes(nv);
}

extern "C" int barrett_launch(const void* x, const void* mu, const void* v,
                              void* r, void* scratch, int batch, int nx,
                              int mu_stride, int nv, int v_stride,
                              int full_w, int h, int* cluster, void* stream) {
  return (int)launch<barrett_kernel>(
      batch, cluster, barrett_smem_bytes(nx, nv, full_w),
      (cudaStream_t)stream, (const int32_t*)x, (const int32_t*)mu,
      (const int32_t*)v, (int32_t*)r, (unsigned char*)scratch, nx,
      mu_stride, nv, v_stride, full_w, h);
}
