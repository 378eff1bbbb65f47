// Batched exact product (u * v) mod B^out_width on base-2^16 limbs.
//
// Replaces repro/kernels/bigmul.py:_mul_batched_kernel (launched by
// mul_pallas_batched), whose 8-bit sub-digit Toeplitz tiles were shaped
// for the TPU's int8 matrix unit.  Here: one block per instance, both
// operands staged in shared memory, 64-bit column sums (limbs::mul).
// Bound: the limb products (operations), with the card's integer units
// doing one 16x16-bit product per multiply-add; the design does nothing
// yet about the idle SMs below batch 132 or the triangular column work.
#include "limbs.cuh"

using namespace limbs;

__global__ void __launch_bounds__(kThreads)
mul_batch_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                 int32_t* __restrict__ out, unsigned char* scratch, int wu,
                 int wv, int out_width) {
  __shared__ Shared sh;
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int na = min(wu, out_width), nb = min(wv, out_width);
  uint32_t* a = smem;
  uint32_t* bb = smem + na;
  for (int i = threadIdx.x; i < na; i += kThreads)
    a[i] = (uint32_t)u[(size_t)b * wu + i];
  for (int i = threadIdx.x; i < nb; i += kThreads)
    bb[i] = (uint32_t)v[(size_t)b * wv + i];
  __syncthreads();
  unsigned char* base = scratch + (size_t)b * align16(mul_scratch_bytes(out_width));
  uint64_t* col = reinterpret_cast<uint64_t*>(base);
  uint32_t* e = reinterpret_cast<uint32_t*>(base + 8 * (size_t)out_width);
  uint32_t* o = reinterpret_cast<uint32_t*>(out + (size_t)b * out_width);
  mul(a, na, bb, nb, out_width, col, e, o, sh);
}

extern "C" size_t mul_batch_scratch_bytes(int out_width) {
  return align16(mul_scratch_bytes(out_width));
}

extern "C" int mul_batch_launch(const void* u, const void* v, void* out,
                                void* scratch, int batch, int wu, int wv,
                                int out_width, void* stream) {
  const size_t smem =
      sizeof(uint32_t) * (size_t)(min(wu, out_width) + min(wv, out_width));
  return (int)launch<mul_batch_kernel>(batch, smem, (cudaStream_t)stream,
                     (const int32_t*)u, (const int32_t*)v, (int32_t*)out,
                     (unsigned char*)scratch, wu, wv, out_width);
}
