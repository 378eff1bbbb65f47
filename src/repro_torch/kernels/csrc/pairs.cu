// Raw per-diagonal sums of a tiled multi-precision product.
//
// Replaces repro/kernels/bigmul.py:_mul_kernel (launched by
// _call_pair_kernel for mul_pallas and mulmod_pallas).  The TPU kernel
// walked diagonal-sorted (i, j) tile pairs on a sequential grid and
// accumulated u_i @ Toeplitz(v_j) of 8-bit sub-digits into the output
// tile of diagonal i + j, resident in VMEM across the pairs of that
// diagonal.  Each output diagonal is independent, so here one block
// owns one (output diagonal d, instance) and walks the pairs i + j = d
// itself: the two T-limb tiles u_i and v_j are staged in shared memory
// and the 2T column sums of their product accumulate in 64-bit
// registers.  No sub-digit split and no host-built Toeplitz tensor:
// a 16x16-bit limb product fits 32 bits.
//
// Output: raw[b, d, s] = sum_{i + j = d} sum_c u_i[c] * v_j[s - c] for
// s in [0, 2T), as int64.  The caller overlap-adds diagonal d at limb
// offset d * T and resolves carries (kernels/ops.py:columns_from_pairs).
// A column of the product is < min(wu, wv) * (2^16 - 1)^2 < 2^48 for
// operands up to 2^16 limbs, so neither the sums nor their overlap-add
// overflow.
//
// Shared memory holds two tiles (1 KB) whatever the widths, so there is
// no width cap, and one instance spreads over up to nu + nv - 1 blocks.
// Bound: the limb products (operations).  The design does nothing yet
// about the two shared-memory loads per product or the uneven pair
// counts of the diagonals.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kT = 128;          // limbs per tile; one thread per column pair

__global__ void __launch_bounds__(kT)
mul_pairs_kernel(const int32_t* __restrict__ u, const int32_t* __restrict__ v,
                 long long* __restrict__ raw, int wu, int wv, int ndiag) {
  __shared__ uint32_t su[kT];
  __shared__ uint32_t sv[kT];
  const int d = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int nu = (wu + kT - 1) / kT, nv = (wv + kT - 1) / kT;
  const int32_t* ub = u + (size_t)b * wu;
  const int32_t* vb = v + (size_t)b * wv;
  // thread t owns columns t and kT + t of the 2T-column tile; for each c
  // exactly one of them takes u_i[c] * v_j[(t - c) mod kT]: column t when
  // c <= t, column kT + t when c > t
  uint64_t acc0 = 0, acc1 = 0;
  const int lo = max(0, d - (nv - 1)), hi = min(d, nu - 1);
  for (int i = lo; i <= hi; ++i) {
    const int j = d - i;
    const int ui = i * kT + t, vj = j * kT + t;
    __syncthreads();             // the previous pair's tiles are read
    su[t] = ui < wu ? (uint32_t)ub[ui] : 0u;
    sv[t] = vj < wv ? (uint32_t)vb[vj] : 0u;
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < kT; ++c) {
      const uint32_t p = su[c] * sv[(t - c) & (kT - 1)];
      if (c <= t)
        acc0 += p;
      else
        acc1 += p;
    }
  }
  long long* out = raw + ((size_t)b * ndiag + d) * (2 * kT);
  out[t] = (long long)acc0;
  out[kT + t] = (long long)acc1;
}

extern "C" int mul_pairs_tile() { return kT; }

// u (batch, wu) and v (batch, wv) int32 limbs, raw (batch, ndiag, 2T)
// int64; ndiag <= nu + nv - 1 diagonals are computed (the caller prunes
// the ones the result cannot see).
extern "C" int mul_pairs_launch(const void* u, const void* v, void* raw,
                                int batch, int wu, int wv, int ndiag,
                                void* stream) {
  if (batch <= 0 || ndiag <= 0) return (int)cudaSuccess;
  if (wu <= 0 || wv <= 0 || batch > 65535 ||
      ndiag > (wu + kT - 1) / kT + (wv + kT - 1) / kT - 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(ndiag, batch);
  mul_pairs_kernel<<<grid, kT, 0, (cudaStream_t)stream>>>(
      (const int32_t*)u, (const int32_t*)v, (long long*)raw, wu, wv, ndiag);
  return (int)cudaGetLastError();
}
