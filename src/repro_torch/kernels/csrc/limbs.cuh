// Block-cooperative multi-precision limb routines shared by the port's
// kernels (mul.cu, step.cu, correct.cu, barrett.cu).
//
// Layout: one thread block per instance, kThreads threads.  A big
// integer is a little-endian array of base-2^16 limbs held in 32-bit
// words (values < 2^16), in shared memory for product operands and in
// a per-instance global scratch for products and glue temporaries (the
// 2^18-bit working set does not fit the 227 KB of shared memory).
//
// Every routine here is called by all threads of the block, with
// block-uniform arguments, and ends with __syncthreads(), so its result
// is visible to the whole block when it returns.
//
// They replace the in-kernel primitives of repro/kernels/fused.py
// (_k_scan, _k_add, _k_sub, _k_lt, _k_prec, _k_mul, ...): the Kogge-Stone
// roll ladders become a warp-shuffle scan plus one level through shared
// memory, the rotate-ladder shifts become index arithmetic, and the
// 8-bit sub-digit Toeplitz product becomes 64-bit column sums.
#pragma once

#include <cstddef>
#include <cstdint>
#include <mutex>
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

// Any a[i] != 0 for i in [0, n).
__device__ inline bool any_nonzero(const uint32_t* a, int n, Shared& sh) {
  int nz = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) nz |= a[i] != 0;
  return block_reduce(nz, MaxOp(), 0, sh) != 0;
}

// a < b over n limbs: decided by the most significant differing limb
// (the borrow out of a - b, arith.lt).
__device__ inline bool lt(const uint32_t* a, const uint32_t* b, int n,
                          Shared& sh) {
  int top = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (a[i] != b[i]) top = i + 1;
  top = block_reduce(top, MaxOp(), 0, sh);
  return top > 0 && a[top - 1] < b[top - 1];
}

// Carry chain over n positions: digit(i) gives position i's raw value,
// generate and propagate bits; writes out[i] = (s_i + c_i) & kMask, or
// (s_i - c_i) & kMask when `subtract` (c_i is then a borrow), where c_i
// is the carry into position i and c_0 = cin.  Returns the carry out of
// the top position.
//
// Each thread walks one contiguous chunk twice: once to compose its
// chunk's (generate, propagate) pair, once to apply its carry-in after
// a block-wide exclusive scan of those pairs (warp shuffles, then one
// level through shared memory).  digit(i) may read only position i of
// an array that `out` overwrites.
template <class F>
__device__ uint32_t scan_apply(int n, F digit, bool subtract, uint32_t cin,
                               uint32_t* out, Shared& sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  uint32_t G = 0, P = 1;
  for (int i = lo; i < hi; ++i) {
    const Digit d = digit(i);
    G = d.g | (d.p & G);
    P &= d.p;
  }
  // inclusive warp scan of (G, P); the lower lane is the less significant
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t gs = __shfl_up_sync(0xffffffffu, G, off);
    const uint32_t ps = __shfl_up_sync(0xffffffffu, P, off);
    if (lane >= off) {
      G = G | (P & gs);
      P = P & ps;
    }
  }
  if (lane == 31) {
    sh.g[wid] = G;
    sh.p[wid] = P;
  }
  __syncthreads();
  if (wid == 0) {
    uint32_t wg = lane < kWarps ? sh.g[lane] : 0u;
    uint32_t wp = lane < kWarps ? sh.p[lane] : 1u;
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t gs = __shfl_up_sync(0xffffffffu, wg, off);
      const uint32_t ps = __shfl_up_sync(0xffffffffu, wp, off);
      if (lane >= off) {
        wg = wg | (wp & gs);
        wp = wp & ps;
      }
    }
    if (lane < kWarps) {
      sh.g[lane] = wg;
      sh.p[lane] = wp;
    }
  }
  __syncthreads();
  // exclusive prefix of this thread = (warps below) then (lanes below)
  uint32_t eg = __shfl_up_sync(0xffffffffu, G, 1);
  uint32_t ep = __shfl_up_sync(0xffffffffu, P, 1);
  if (lane == 0) {
    eg = 0;
    ep = 1;
  }
  const uint32_t bg = wid > 0 ? sh.g[wid - 1] : 0u;
  const uint32_t bp = wid > 0 ? sh.p[wid - 1] : 1u;
  const uint32_t xg = eg | (ep & bg), xp = ep & bp;
  const uint32_t cout = sh.g[kWarps - 1] | (sh.p[kWarps - 1] & cin);
  uint32_t c = xg | (xp & cin);
  for (int i = lo; i < hi; ++i) {
    const Digit d = digit(i);
    out[i] = (subtract ? d.s - c : d.s + c) & kMask;
    c = d.g | (d.p & c);
  }
  __syncthreads();
  return cout;
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

// Column sums col[k] = sum_{i+j=k} a[i] * b[j] for k < n_out, in 64 bits.
// a (na limbs) and b (nb limbs) lie in shared memory.  Each sum is
// < min(na, nb) * (2^16 - 1)^2 < 2^46 for operands up to 16392 limbs.
// Columns are strided over the threads; the work per column is
// triangular in k.
__device__ inline void mul_columns(const uint32_t* a, int na,
                                   const uint32_t* b, int nb, int n_out,
                                   uint64_t* col) {
  for (int k = threadIdx.x; k < n_out; k += kThreads) {
    const int lo = max(0, k - nb + 1), hi = min(k, na - 1);
    uint64_t acc = 0;
    for (int i = lo; i <= hi; ++i) acc += (uint64_t)a[i] * b[k - i];
    col[k] = acc;
  }
  __syncthreads();
}

// Column sums (each < 2^48) -> canonical limbs out[0, n), mod B^n.
// Each sum splits into three 16-bit pieces added at limb offsets 0, 1
// and 2 (e < 3 * 2^16); one local pass leaves digits <= 2^16 + 1, whose
// carries are 0 or 1; one carry chain finishes.  `e` is scratch of n
// words; `out` must not alias `e` or `col`.
__device__ inline void resolve(const uint64_t* col, uint32_t* e, int n,
                               uint32_t* out, Shared& sh) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    uint32_t x = (uint32_t)(col[k] & kMask);
    if (k >= 1) x += (uint32_t)((col[k - 1] >> 16) & kMask);
    if (k >= 2) x += (uint32_t)(col[k - 2] >> 32);
    e[k] = x;
  }
  __syncthreads();
  scan_apply(
      n,
      [&](int k) {
        const uint32_t s = (e[k] & kMask) + (k >= 1 ? e[k - 1] >> 16 : 0u);
        return Digit{s, s >> 16, s == kMask ? 1u : 0u};
      },
      false, 0u, out, sh);
}

// Exact (a * b) mod B^n_out: column sums, then carry resolution.
__device__ inline void mul(const uint32_t* a, int na, const uint32_t* b,
                           int nb, int n_out, uint64_t* col, uint32_t* e,
                           uint32_t* out, Shared& sh) {
  mul_columns(a, na, b, nb, n_out, col);
  resolve(col, e, n_out, out, sh);
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

// Launches `kernel` with one block per instance and `bytes` of dynamic
// shared memory, and reports a refused launch.  The kernel's shared
// memory allowance on the current device is raised only when a launch
// needs more than was allowed before, not on every launch.
template <auto kernel, class... Args>
cudaError_t launch(int batch, size_t bytes, cudaStream_t stream,
                   Args... args) {
  if (batch <= 0) return cudaSuccess;
  static std::mutex mu;
  static size_t allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (bytes > allowed[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return err;
      allowed[dev] = bytes;
    }
  }
  kernel<<<batch, kThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace limbs
