// divmod finalization in one kernel.
//
// Replaces repro/kernels/fused.py:_correct_kernel and
// _correct_grid_kernel: q = floor(u * si / B^h) cut to W limbs
// (fused.py:_quotient_glue), mm = (v * q) mod B^W, then Algorithm 3's
// delta in {-1, 0, +1} compare-and-correct and the total extension
// divmod(u, 0) = (0, u) (fused.py:_correct_glue), for any u, v, si and
// h in [0, 2W], a valid inverse or not.
//
// Bound: the limb products of the two products over the operands'
// significant limbs, prec(u) * prec(si) and the q * v products below
// limb W (operations).  On a division's operands prec(si) and prec(q)
// are about prec(u) - prec(v) + 1, so these are a fraction of the full
// W x W windows.  Both products are digit GEMMs on the int8 tensor
// cores (digitmma.cuh) over those limbs only: u (A layout) and si (B
// layout) clipped to their precs, then q (A layout, in si's buffer)
// and v (B layout) clipped to theirs; p = u * si keeps every column
// below h + W (the columns below h carry into q, so they are summed
// exactly).  Shared memory holds the three buffers at two bytes per
// limb, about 6 W bytes: 99 KB at W = 16392, two blocks per SM.  An
// instance spreads over a thread-block cluster below 132 lanes, as in
// barrett.cu: each block sums a balanced range of product columns into
// the instance's global scratch, the cluster resolves the carries of p
// together, and each block writes its limbs of q into every block's
// shared memory over distributed shared memory; then q * v the same
// way.  Both products run digit_product's main loop, deep where a
// block's share of the product is long enough (digitmma.cuh): at 2^18
// bits x 16,384 on an H100 they were 89% of a block under the pair
// loop and are 75% under the deep one (3.55M -> 1.32M cycles a block;
// 139 -> 59 ms a launch), the rest the resolves, comparisons and
// chains.  At 2^15 most blocks' shares of the products, clipped to the
// lanes' lengths, hold fewer than kDeep * kWarps row tiles, so they
// keep pairs and the fixed cost of one block a lane rules (33 ms).
// Every select is per instance and a cluster is one instance, so every
// block takes the same branch and meets the same barriers: the
// comparisons run as cluster_lt, and mm - v, u - mm, r - v and q +/- 1
// as cluster_chain, each block over its share of the limbs.  q is kept
// as read from p, and delta = (r >= v) - (u < mm) is applied once, as q
// goes out of shared memory.
#include "digitmma.cuh"

using namespace digitmma;
using limbs::add_digit;
using limbs::sub_digit;

namespace {

// Per-instance global scratch: 64-bit column sums and resolve pieces of
// a product of up to 2W limbs, and mm (W words).
__host__ __device__ size_t correct_bytes(int full_w) {
  return limbs::align16(28 * (size_t)full_w);
}

// si's buffer: si in the B layout, then q in the A layout
__host__ __device__ size_t sq_bytes(int full_w) {
  return a_bytes(full_w) > b_bytes(full_w) ? a_bytes(full_w)
                                           : b_bytes(full_w);
}

__host__ __device__ size_t smem_bytes(int full_w) {
  return a_bytes(full_w) + sq_bytes(full_w) + b_bytes(full_w);
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
correct_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
               const int32_t* __restrict__ si, const int32_t* __restrict__ h_,
               int32_t* __restrict__ q_out, int32_t* __restrict__ r_out,
               unsigned char* scratch, int full_w) {
  __shared__ Block st;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / cs, W = full_w, h = h_[b];
  const int32_t* ub = u + (size_t)b * W;
  const int32_t* vb = v + (size_t)b * W;
  const int32_t* sb = si + (size_t)b * W;
  uint32_t* qo = reinterpret_cast<uint32_t*>(q_out + (size_t)b * W);
  uint32_t* ro = reinterpret_cast<uint32_t*>(r_out + (size_t)b * W);
  auto gp = [](const int32_t* a) { return reinterpret_cast<const uint32_t*>(a); };
  int lo, hi;
  share(W, rank, cs, lo, hi);

  // divmod(u, 0) = (0, u): every block of the cluster sees v = 0 and
  // returns here, before any cluster barrier, so none is left waiting
  const int pv = limbs::prec(gp(vb), W, st.sh);
  if (pv == 0) {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
      qo[i] = 0;
      ro[i] = (uint32_t)ub[i];
    }
    return;
  }

  unsigned char* base = scratch + (size_t)b * correct_bytes(W);
  uint64_t* col = reinterpret_cast<uint64_t*>(base);
  uint32_t* e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)W);
  uint32_t* mm = reinterpret_cast<uint32_t*>(base + 24 * (size_t)W);
  unsigned char* U = smem;
  unsigned char* SQ = U + a_bytes(W);
  unsigned char* V = SQ + sq_bytes(W);
  uint16_t* q16 = reinterpret_cast<uint16_t*>(SQ) + kAPad / 2;

  // significant widths, then staging
  const int pu = limbs::prec(gp(ub), W, st.sh);
  const int psi = limbs::prec(gp(sb), W, st.sh);
  stage_a(U, W, ub, pu);
  stage_b(SQ, W, sb, psi);
  stage_b(V, W, vb, pv);
  __syncthreads();

  // p = u * si: nonzero below pu + psi limbs, read below h + W only
  const int np = pu && psi ? max(0, min(min(2 * W, pu + psi), h + W)) : 0;
  digit_product(U, 2 * pu, SQ, 2 * psi, np, col, st, rank, cs);
  cl.sync();               // column sums visible; si read everywhere

  // q = floor(p / B^h) cut to W, into every block's SQ (A layout)
  zero_bytes(SQ, a_bytes(W));
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

  // mm = (q * v) mod B^W
  const int nm = pq ? min(W, pq + pv) : 0;
  digit_product(SQ, 2 * pq, V, 2 * pv, nm, col, st, rank, cs);
  cl.sync();
  cluster_resolve(col, nm, e, W,
                  [&](int i, uint32_t limb) { mm[i] = limb; }, st, cl);

  auto uat = [&](int i) { return (uint32_t)ub[i]; };
  auto vat = [&](int i) { return (uint32_t)vb[i]; };
  auto mat = [&](int i) { return mm[i]; };
  auto rat = [&](int i) { return ro[i]; };
  const bool neg = cluster_lt(W, uat, mat, st, cl);     // delta = -1
  if (neg)
    cluster_chain(W, [&](int i) { return sub_digit(mm[i], vat(i)); }, true,
                  [&](int i, uint32_t d) { mm[i] = d; }, st, cl);
  cluster_chain(W, [&](int i) { return sub_digit(uat(i), mm[i]); }, true,
                [&](int i, uint32_t d) { ro[i] = d; }, st, cl);
  const bool pos = !cluster_lt(W, rat, vat, st, cl);    // delta = +1
  if (pos)
    cluster_chain(W, [&](int i) { return sub_digit(ro[i], vat(i)); }, true,
                  [&](int i, uint32_t d) { ro[i] = d; }, st, cl);

  // q + pos - neg (mod B^W) from this block's copy of q; the last
  // cluster barrier above is behind every read of another block's
  // shared memory, so a block may leave after its share
  auto put = [&](int i, uint32_t d) { qo[i] = d; };
  if (pos == neg) {
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) qo[i] = q16[i];
  } else if (pos) {
    cluster_chain(W, [&](int i) { return add_digit(q16[i], 0u); }, false,
                  put, st, cl, 1u);
  } else {
    cluster_chain(W, [&](int i) { return sub_digit(q16[i], 0u); }, true,
                  put, st, cl, 1u);
  }
}

extern "C" size_t correct_scratch_bytes(int full_w) {
  return correct_bytes(full_w);
}

extern "C" size_t correct_smem_bytes(int full_w) {
  return smem_bytes(full_w);
}

extern "C" int correct_launch(const void* u, const void* v, const void* si,
                              const void* h, void* q, void* r, void* scratch,
                              int batch, int full_w, int* cluster,
                              void* stream) {
  return (int)launch<correct_kernel>(
      batch, cluster, smem_bytes(full_w), (cudaStream_t)stream,
      (const int32_t*)u, (const int32_t*)v, (const int32_t*)si,
      (const int32_t*)h, (int32_t*)q, (int32_t*)r, (unsigned char*)scratch,
      full_w);
}
