// Batched exact product (u * v) mod B^out_width on base-2^16 limbs.
//
// Replaces repro/kernels/bigmul.py:_mul_batched_kernel (launched by
// mul_pallas_batched), whose 8-bit sub-digit Toeplitz tiles fed the
// TPU's matrix unit.  Here the 8-bit digits feed Hopper's int8 tensor
// cores: the product is a sliding-window x Toeplitz digit GEMM of
// mma.sync.m16n8k32.s32.u8.u8.s32 (digitmma.cuh), the longer operand as
// the window A and the shorter as the Toeplitz band B, both staged in
// shared memory at two bytes per limb.  An instance spreads over a
// thread-block cluster when the batch leaves SMs idle (the wrapper's
// cluster size); each block sums a balanced range of output columns
// into the instance's global scratch, and the cluster resolves the
// carries together.  Bound: the limb products (operations, 8 int8
// operations each).
#include "digitmma.cuh"

using namespace digitmma;

__global__ void __launch_bounds__(kThreads, 2)   // two blocks per SM
mul_batch_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                 int32_t* __restrict__ out, unsigned char* scratch, int wu,
                 int wv, int out_width) {
  __shared__ Block st;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int b = blockIdx.x / cs;
  const int32_t* pa = u + (size_t)b * wu;
  const int32_t* pb = v + (size_t)b * wv;
  int na = min(wu, out_width), nb = min(wv, out_width);
  if (nb > na) {                       // B is the shorter operand
    const int32_t* t = pa;
    pa = pb;
    pb = t;
    const int n = na;
    na = nb;
    nb = n;
  }
  unsigned char* A = smem;
  unsigned char* Bv = smem + a_bytes(na);
  stage_a(A, na, pa, na);
  stage_b(Bv, nb, pb, nb);
  __syncthreads();
  unsigned char* base =
      scratch + (size_t)b * limbs::align16(limbs::mul_scratch_bytes(out_width));
  uint64_t* col = reinterpret_cast<uint64_t*>(base);
  uint32_t* e = reinterpret_cast<uint32_t*>(base + 8 * (size_t)out_width);
  uint32_t* o = reinterpret_cast<uint32_t*>(out + (size_t)b * out_width);
  const int n_cols = min(out_width, na + nb);
  digit_product(A, 2 * na, Bv, 2 * nb, n_cols, col, st, rank, cs);
  cl.sync();                           // column sums visible to the cluster
  cluster_resolve(col, n_cols, e, out_width,
                  [&](int i, uint32_t x) { o[i] = x; }, st, cl);
}

extern "C" size_t mul_batch_scratch_bytes(int out_width) {
  return limbs::align16(limbs::mul_scratch_bytes(out_width));
}

extern "C" size_t mul_batch_smem_bytes(int wu, int wv, int out_width) {
  const int na = min(wu, out_width), nb = min(wv, out_width);
  return a_bytes(max(na, nb)) + b_bytes(min(na, nb));
}

extern "C" int mul_batch_launch(const void* u, const void* v, void* out,
                                void* scratch, int batch, int wu, int wv,
                                int out_width, int* cluster, void* stream) {
  return (int)launch<mul_batch_kernel>(
      batch, cluster, mul_batch_smem_bytes(wu, wv, out_width),
      (cudaStream_t)stream, (const int32_t*)u, (const int32_t*)v,
      (int32_t*)out, (unsigned char*)scratch, wu, wv, out_width);
}
