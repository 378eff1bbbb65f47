// Block-cooperative multi-precision limb routines shared by the port's
// digit-GEMM kernels (digitmma.cuh and mul.cu, step.cu, correct.cu,
// barrett.cu).
//
// A big integer is a little-endian array of base-2^16 limbs held in
// 32-bit words (values < 2^16).  block_reduce and prec are called by
// all threads of a block, with block-uniform arguments, and every thread
// gets the result.
//
// They replace the in-kernel primitives of repro/kernels/fused.py
// (_k_scan, _k_prec, ...): the Kogge-Stone roll ladders become
// warp-shuffle reductions and scans plus one level through shared
// memory (the scans are digitmma.cuh's cluster_chain).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace limbs {

constexpr uint32_t kMask = 0xFFFFu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Shared {               // static shared scratch of the block routines
  int red[kWarps];
  uint32_t g[kWarps];
  uint32_t p[kWarps];
  int bcast;
};

struct Digit {                // one position of a carry chain
  uint32_t s;                 // raw value before the carry-in
  uint32_t g;                 // carry out generated here
  uint32_t p;                 // carry in propagated here
};

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct MinOp {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// Block-wide reduction of one int per thread; every thread gets the result.
template <class Op>
__device__ int block_reduce(int x, Op op, int ident, Shared& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    x = op(x, __shfl_down_sync(0xffffffffu, x, off));
  if (lane == 0) sh.red[wid] = x;
  __syncthreads();
  if (wid == 0) {
    x = lane < kWarps ? sh.red[lane] : ident;
    for (int off = 16; off > 0; off >>= 1)
      x = op(x, __shfl_down_sync(0xffffffffu, x, off));
    if (lane == 0) sh.bcast = x;
  }
  __syncthreads();
  const int r = sh.bcast;
  __syncthreads();            // sh is free for the next call
  return r;
}

// Number of significant limbs of a[0, n) (0 for zero): arith.prec.
__device__ inline int prec(const uint32_t* a, int n, Shared& sh) {
  int top = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (a[i] != 0) top = i + 1;
  return block_reduce(top, MaxOp(), 0, sh);
}

// Digit of a + b (+ carry).
__device__ inline Digit add_digit(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return {s, s >> 16, s == kMask ? 1u : 0u};
}

// Digit of a - b (- borrow).
__device__ inline Digit sub_digit(uint32_t a, uint32_t b) {
  return {a - b, a < b ? 1u : 0u, a == b ? 1u : 0u};
}

// Per-instance scratch of a product with n_out output limbs: the column
// sums (8 bytes each) and the resolve scratch (4 bytes each).
__host__ __device__ inline size_t mul_scratch_bytes(int n_out) {
  return 12 * (size_t)n_out;
}

// Round a byte count up to 16 so per-instance scratch stays aligned.
__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

constexpr int kMaxDevices = 64;

}  // namespace limbs
