// One Refine iteration of the shifted-inverse Newton loop: two kernels.
//
//   powdiff  replaces repro/kernels/fused.py:_powdiff_kernel and
//            _powdiff_grid_kernel: vp = shift(v, -s) to the window, the
//            product p = vp * wq to 2*win limbs, and Algorithm 2's
//            sign/magnitude select (fused.py:_powdiff_glue).
//   update   replaces fused.py:_update_kernel and _update_grid_kernel:
//            tmp = wq * x, shift by 2m - h, add to or subtract from
//            shift(wq, m), floor correction, the -1 normalization shift
//            and the active-lane select (fused.py:_update_glue).
//
// The TPU needed two generations of each (unrolled and grid-scheduled)
// because of its VMEM budget; here one kernel per stage covers every
// window from 32 to 32778 limbs (a 2^18-bit modulus's precompute).
//
// Both products are digit GEMMs on the int8 tensor cores (digitmma.cuh)
// over the operands' significant limbs only, the longer operand as the
// window A and the shorter as the Toeplitz band B, both staged at two
// bytes per limb.  Bound: the limb products of the clipped (and for
// update, cut) product (operations), or the full-width stores of x and
// the new w (bytes), which bound the division's small windows.  Each
// kernel is written once over a team (the Team types below) and
// launched in one of two geometries, chosen by the launch's shape in
// kernels/digitmma.py:step_plan:
//
//   clustered  an instance on a thread-block cluster of 512-thread
//              blocks (8 blocks for the precompute's single lane, 1 from
//              132 lanes): 4 win + 400 bytes of shared memory (131 KB at
//              W = 32778); each block sums a balanced range of product
//              columns into the instance's global scratch and the
//              cluster resolves the carries together.  Every select of
//              the JAX glue is on a per-instance condition, so every
//              block of a cluster takes the same branch; the glue's
//              reductions and carry chains run cluster-wide, each block
//              over its share of the positions.
//   packed     for the clustered geometry's fixed cost: a launch there
//              runs a serial chain of ~20 block and cluster barriers per
//              instance with two instances per SM, which costs about the
//              same at every window (~25,000 cycles a block at window 32,
//              most of it in the two carry chains).  So at cluster 1
//              (batch >= SMs) and a window of at most 1,040 limbs, or
//              144 under 1.5 instances an SM, where most SMs would run
//              one clustered block alone (digitmma.py step_plan, from
//              the shape alone; it is given lane_bytes), a team of
//              one warp (window <= 272), two (<= 528) or four runs an
//              instance, several teams a block, so that 8-32 divisions
//              are in flight per SM.  An instance's staged operands,
//              column sums and product stay in its team's shared memory
//              (lane_bytes, no global scratch); reductions are warp
//              shuffles and the carry chains one warp's ballots
//              (digitmma.cuh warp_chain); only the team synchronises.
//              Its bound is the full-width stores of x and w, zero above
//              the window (16-byte, coalesced), up to the product at
//              the wider windows.
//
// update needs tmp only below limb max(h - 2m, 0) + win, so its product
// stops there.
#include <cstdint>

#include "digitmma.cuh"

using namespace digitmma;
using limbs::add_digit;
using limbs::MaxOp;
using limbs::MinOp;
using limbs::sub_digit;

namespace {

constexpr int kPackThreads = 256;    // most threads of a packed block

// Per-instance global scratch of the clustered geometry, shared by the
// instance's cluster: column sums (2*win x 8 bytes), resolve pieces
// (2*win x 4) and the product (2*win x 4).
__host__ __device__ size_t step_bytes(int win) {
  return limbs::align16(32 * (size_t)win);
}

__host__ __device__ size_t smem_bytes(int win) {
  return a_bytes(win) + b_bytes(win);
}

// Shared memory of one packed instance: 16 bytes of team reduction
// slots, the column sums (2*win x 8 bytes), then the A and B layouts,
// over which the product is written as 16-bit limbs (2*win x 2 bytes)
// once the digit GEMM is done.
__host__ __device__ size_t lane_bytes(int win) {
  return 16 + 16 * (size_t)win + a_bytes(win) + b_bytes(win);
}

struct Scratch {
  uint64_t* col;
  uint32_t* e;
  uint32_t* p;
};

__device__ Scratch scratch_of(unsigned char* scratch, int b, int win) {
  unsigned char* base = scratch + (size_t)b * step_bytes(win);
  Scratch s;
  s.col = reinterpret_cast<uint64_t*>(base);
  s.e = reinterpret_cast<uint32_t*>(base + 16 * (size_t)win);
  s.p = reinterpret_cast<uint32_t*>(base + 24 * (size_t)win);
  return s;
}

// Significant limbs of limb(0), ..., limb(n - 1) (arith.prec).
template <class F>
__device__ int prec_of(int n, F limb, limbs::Shared& sh) {
  int top = 0;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (limb(i) != 0) top = i + 1;
  return limbs::block_reduce(top, MaxOp(), 0, sh);
}

// A team is what runs one instance: its index, which of its threads
// take which positions (each), reductions, carry chains, the product
// p = fa * fb to n limbs (product, then p(i)), the zero fill above the
// window, the copy of an inactive lane and the one thread that writes
// per-instance results (leader).

// The clustered geometry: the instance's whole cluster.
struct ClusterTeam {
  static constexpr int kBlockThreads = kThreads;
  static constexpr int kMinBlocks = 2;          // two blocks per SM

  Block& st;
  cg::cluster_group cl;
  int cs, rank, b, win;
  unsigned char* smem;
  Scratch t;

  __device__ static Block& block_state() {
    __shared__ Block st;
    return st;
  }
  __device__ ClusterTeam(unsigned char* smem_, unsigned char* scratch,
                         int win_)
      : st(block_state()), cl(cg::this_cluster()), win(win_), smem(smem_) {
    cs = (int)cl.num_blocks();
    rank = (int)cl.block_rank();
    b = blockIdx.x / cs;
    t = scratch_of(scratch, b, win);
  }
  __device__ int instance() const { return b; }
  __device__ bool leader() const { return rank == 0 && threadIdx.x == 0; }
  template <class F>
  __device__ void each(int n, F f) const {
    int lo, hi;
    share(n, rank, cs, lo, hi);
    for (int i = lo + threadIdx.x; i < hi; i += kThreads) f(i);
  }
  template <class F>
  __device__ int prec(int n, F limb) { return prec_of(n, limb, st.sh); }
  template <class Op>
  __device__ int reduce(int x, Op op, int ident) {
    return cluster_reduce(x, op, ident, st, cl);
  }
  template <class F, class S>
  __device__ void chain(int n, F digit, bool subtract, S store,
                        uint32_t cin = 0) {
    cluster_chain(n, digit, subtract, store, st, cl, cin);
  }
  // Limbs [0, n) of fa * fb (significant widths na, nb >= 1) into the
  // scratch's p, visible to the whole cluster on return.
  template <class FA, class FB>
  __device__ void product(FA fa, int na, FB fb, int nb, int n) {
    unsigned char* A = smem;
    unsigned char* Bv = smem + a_bytes(win);
    if (na >= nb) {                    // B is the shorter operand
      stage_a_fn(A, win, fa, na);
      stage_b_fn(Bv, win, fb, nb);
    } else {
      stage_a_fn(A, win, fb, nb);
      stage_b_fn(Bv, win, fa, na);
    }
    __syncthreads();
    digit_product(A, 2 * max(na, nb), Bv, 2 * min(na, nb), n, t.col, st,
                  rank, cs);
    cl.sync();                         // column sums visible to the cluster
    uint32_t* p = t.p;
    cluster_resolve(t.col, n, t.e, n,
                    [&](int i, uint32_t limb) { p[i] = limb; }, st, cl);
  }
  __device__ uint32_t p(int i) const { return t.p[i]; }
  __device__ void zero(uint32_t* x, int lo, int hi) const {
    each(hi - lo, [&](int i) { x[lo + i] = 0; });
  }
  __device__ void copy(uint32_t* dst, const int32_t* src, int n) const {
    each(n, [&](int i) { dst[i] = src[i]; });
  }
};

// The packed geometry: kTeamWarps warps of a block, one instance.
template <int kTeamWarps>
struct WarpTeam {
  static constexpr int kSize = 32 * kTeamWarps;
  static constexpr int kBlockThreads = kPackThreads;
  static constexpr int kMinBlocks = 4;          // 64 registers a thread

  int id, tid, warp, b;
  int* red;                          // a slot per warp
  uint64_t* col;
  unsigned char* A;
  unsigned char* Bv;
  uint16_t* p16;                     // the product, over A and B
  int win;

  __device__ WarpTeam(unsigned char* smem, unsigned char*, int win_)
      : win(win_) {
    id = threadIdx.x / kSize;
    tid = threadIdx.x % kSize;
    warp = tid >> 5;
    b = blockIdx.x * (blockDim.x / kSize) + id;
    unsigned char* base = smem + id * lane_bytes(win);
    red = reinterpret_cast<int*>(base);
    col = reinterpret_cast<uint64_t*>(base + 16);
    A = base + 16 + 16 * (size_t)win;
    Bv = A + a_bytes(win);
    p16 = reinterpret_cast<uint16_t*>(A);
  }
  __device__ int instance() const { return b; }
  __device__ bool leader() const { return tid == 0; }
  __device__ void sync() const {
    if (kTeamWarps == 1)
      __syncwarp();
    else   // named barrier 1 + id: the team's warps only
      asm volatile("bar.sync %0, %1;" ::"r"(id + 1), "r"(kSize) : "memory");
  }
  template <class F>
  __device__ void each(int n, F f) const {
    for (int i = tid; i < n; i += kSize) f(i);
  }
  template <class Op>
  __device__ int reduce(int x, Op op, int ident) const {
    for (int off = 16; off > 0; off >>= 1)
      x = op(x, __shfl_xor_sync(kFull, x, off));
    if (kTeamWarps == 1) return x;
    if ((tid & 31) == 0) red[warp] = x;
    sync();
    int r = ident;
    for (int q = 0; q < kTeamWarps; ++q) r = op(r, red[q]);
    sync();                            // the slots are free again
    return r;
  }
  template <class F>
  __device__ int prec(int n, F limb) const {
    int top = 0;
    each(n, [&](int i) {
      if (limb(i) != 0) top = i + 1;
    });
    return reduce(top, MaxOp(), 0);
  }
  template <class F, class S>
  __device__ void chain(int n, F digit, bool subtract, S store,
                        uint32_t cin = 0) const {
    if (warp == 0) warp_chain(n, digit, subtract, store, cin);
    sync();
  }
  // Limbs [0, n) of fa * fb (significant widths na, nb >= 1) into p16,
  // visible to the whole team on return.
  template <class FA, class FB>
  __device__ void product(FA fa, int na, FB fb, int nb, int n) const {
    if (na >= nb) {                    // B is the shorter operand
      stage_a_fn(A, win, fa, na, tid, kSize);
      stage_b_fn(Bv, win, fb, nb, tid, kSize);
    } else {
      stage_a_fn(A, win, fb, nb, tid, kSize);
      stage_b_fn(Bv, win, fa, na, tid, kSize);
    }
    sync();
    team_product(A, 2 * max(na, nb), Bv, 2 * min(na, nb), n, col, warp,
                 kTeamWarps);
    sync();                            // col complete; A and B free
    if (warp == 0)
      warp_resolve(col, n, n,
                   [&](int i, uint32_t limb) { p16[i] = (uint16_t)limb; });
    sync();
  }
  __device__ uint32_t p(int i) const { return p16[i]; }
  // x[lo, hi) = 0: a scalar head to a 16-byte boundary, 16-byte stores,
  // a scalar tail.
  __device__ void zero(uint32_t* x, int lo, int hi) const {
    if (lo >= hi) return;
    const int head = min(hi, lo + (int)(((16 - ((uintptr_t)(x + lo) & 15))
                                          & 15) >> 2));
    each(head - lo, [&](int i) { x[lo + i] = 0; });
    const int nv = (hi - head) >> 2;
    uint4* q = reinterpret_cast<uint4*>(x + head);
    each(nv, [&](int i) { q[i] = make_uint4(0, 0, 0, 0); });
    each(hi - head - 4 * nv, [&](int i) { x[head + 4 * nv + i] = 0; });
  }
  // dst[0, n) = src[0, n), 16 bytes at a time where both share their
  // alignment.
  __device__ void copy(uint32_t* dst, const int32_t* src, int n) const {
    const int mis = (int)(((uintptr_t)dst & 15) >> 2);
    if (mis != (int)(((uintptr_t)src & 15) >> 2)) {
      each(n, [&](int i) { dst[i] = (uint32_t)src[i]; });
      return;
    }
    const int head = min(n, (4 - mis) & 3);
    each(head, [&](int i) { dst[i] = (uint32_t)src[i]; });
    const int nv = (n - head) >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    each(nv, [&](int i) { d4[i] = s4[i]; });
    const int tail = head + 4 * nv;
    each(n - tail, [&](int i) { dst[tail + i] = (uint32_t)src[tail + i]; });
  }
};

}  // namespace

template <class Team>
__global__ void __launch_bounds__(Team::kBlockThreads, Team::kMinBlocks)
powdiff_kernel(const int32_t* __restrict__ v, const int32_t* __restrict__ w,
               const int32_t* __restrict__ hpd_, const int32_t* __restrict__ lpd_,
               const int32_t* __restrict__ s_, int32_t* __restrict__ sign_out,
               int32_t* __restrict__ x_out, unsigned char* scratch,
               int batch, int full_w, int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  Team t(smem, scratch, win);
  const int b = t.instance();
  if (b >= batch) return;              // a packed block's spare teams
  const int hpd = hpd_[b], lpd = lpd_[b], sft = s_[b];
  const int32_t* vb = v + (size_t)b * full_w;
  const int32_t* wb = w + (size_t)b * full_w;
  uint32_t* x = reinterpret_cast<uint32_t*>(x_out + (size_t)b * full_w);
  auto vp = [&](int i) -> uint32_t {   // shift(v, -s) within the window
    const long src = (long)i + sft;
    return (src >= 0 && src < full_w) ? (uint32_t)vb[src] : 0u;
  };
  auto wq = [&](int i) -> uint32_t { return (uint32_t)wb[i]; };
  const int pv = t.prec(win, vp), pw = t.prec(win, wq);
  const int L = pv + pw - lpd + 1;
  const bool vwz = pv == 0 || pw == 0;
  const bool full = vwz || L >= hpd;
  const int np = vwz ? 0 : pv + pw;    // p < B^np, so its limbs [0, np)
  if (np > 0) t.product(vp, pv, wq, pw, np);
  auto pat = [&](int i) -> uint32_t { return i < np ? t.p(i) : 0u; };
  auto put = [&](int i, uint32_t d) { x[i] = d; };
  bool sign;
  if (vwz) {                                     // |B^h - 0| = B^h
    sign = hpd >= 0;
    t.each(win, [&](int i) { x[i] = i == hpd; });
  } else if (full) {
    // sign from prec(p) <= hpd; sub_pow's first nonzero limb >= hpd
    int top = 0, first = np;
    t.each(np, [&](int i) {
      if (t.p(i) != 0) {
        top = i + 1;
        if (i >= hpd) first = min(first, i);
      }
    });
    sign = t.reduce(top, MaxOp(), 0) <= hpd;
    if (sign) {                                  // B^h - p, low win limbs
      t.chain(
          win,
          [&](int i) {
            return add_digit(i < hpd ? kMask - pat(i) : 0u, i == 0);
          },
          false, put);
    } else {                                     // p - B^h (sub_pow)
      const int n = t.reduce(first, MinOp(), np);
      t.each(win, [&](int i) {
        x[i] = (i >= hpd && i <= n) ? (pat(i) - 1u) & kMask : pat(i);
      });
    }
  } else {
    // close branch: P = p mod B^L within the window, sign from its top
    int nz = 0;
    t.each(max(0, min(min(L, win), np)), [&](int i) { nz |= t.p(i) != 0; });
    const bool pz = t.reduce(nz, MaxOp(), 0) == 0;
    const uint32_t ptop = (L - 1 >= 0 && L - 1 < win) ? pat(L - 1) : 0u;
    sign = pz || ptop != 0;
    if (pz) {
      t.each(win, [&](int i) { x[i] = 0; });
    } else if (ptop == 0) {
      t.each(win, [&](int i) { x[i] = i < L ? pat(i) : 0u; });
    } else {                                     // B^L - P
      t.chain(
          win,
          [&](int i) {
            return add_digit(i < L ? kMask - pat(i) : 0u, i == 0);
          },
          false, put);
    }
  }
  t.zero(x, win, full_w);                        // zero above the window
  if (t.leader()) sign_out[b] = sign;
}

template <class Team>
__global__ void __launch_bounds__(Team::kBlockThreads, Team::kMinBlocks)
update_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ x,
              const int32_t* __restrict__ sign_, const int32_t* __restrict__ h_,
              const int32_t* __restrict__ m_, const int32_t* __restrict__ act_,
              int32_t* __restrict__ out, unsigned char* scratch, int batch,
              int full_w, int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  Team t(smem, scratch, win);
  const int b = t.instance();
  if (b >= batch) return;              // a packed block's spare teams
  const int32_t* wb = w + (size_t)b * full_w;
  const int32_t* xb = x + (size_t)b * full_w;
  uint32_t* ob = reinterpret_cast<uint32_t*>(out + (size_t)b * full_w);
  if (!act_[b]) {             // inactive lane, the whole team: w as it is
    t.copy(ob, wb, full_w);
    return;
  }
  const int h = h_[b], m = m_[b];
  const bool sign = sign_[b] != 0;
  auto wq = [&](int i) -> uint32_t { return (uint32_t)wb[i]; };
  auto xq = [&](int i) -> uint32_t { return (uint32_t)xb[i]; };
  const int pw = t.prec(win, wq), px = t.prec(win, xq);
  // tmp = wq * x is read below limb max(h - 2m, 0) + win only
  const int off = h - 2 * m;
  const int n = (pw == 0 || px == 0)
      ? 0 : min(min(2 * win, pw + px), max(off, 0) + win);
  if (n > 0) t.product(wq, pw, xq, px, n);

  // floor correction: a nonzero limb among the h - 2m dropped ones
  bool dropped = false;
  if (!sign) {
    int nz = 0;
    t.each(max(0, min(off, n)), [&](int i) { nz |= t.p(i) != 0; });
    dropped = t.reduce(nz, MaxOp(), 0) != 0;
  }

  // res = shift(wq, m) +/- shift(tmp, 2m - h), both within the window;
  // the floor correction is the subtraction's borrow-in; the -1
  // normalization shift stores res[i] at out[i - 1]
  auto sh_at = [&](int i) -> uint32_t {
    const long src = (long)i + off;
    return (src >= 0 && src < n) ? t.p((int)src) : 0u;
  };
  auto wm_at = [&](int i) -> uint32_t {
    const int src = i - m;
    return (src >= 0 && src < win) ? (uint32_t)wb[src] : 0u;
  };
  t.chain(
      win,
      [&](int i) {
        return sign ? add_digit(wm_at(i), sh_at(i))
                    : sub_digit(wm_at(i), sh_at(i));
      },
      !sign,
      [&](int i, uint32_t d) {
        if (i >= 1) ob[i - 1] = d;
      },
      dropped ? 1u : 0u);
  // the clustered chain's closing cluster.sync() keeps every block
  // resident until no block reads another's shared memory
  t.zero(ob, win - 1, full_w);
}

namespace {

template <class Team>
struct Powdiff {
  static constexpr auto kernel = powdiff_kernel<Team>;
};

template <class Team>
struct Update {
  static constexpr auto kernel = update_kernel<Team>;
};

// One launch of kernel K: clustered where team_warps is 0, else packed,
// `lanes` teams of team_warps warps a block.
template <template <class> class K, class... Args>
cudaError_t dispatch(int batch, int win, int team_warps, int lanes,
                     int* cluster, cudaStream_t stream, Args... args) {
  if (team_warps == 0)
    return launch<K<ClusterTeam>::kernel>(batch, cluster, smem_bytes(win),
                                          stream, args...);
  const int threads = 32 * team_warps * lanes;
  if (lanes < 1 || threads > kPackThreads) return cudaErrorInvalidValue;
  *cluster = 1;
  const size_t bytes = (size_t)lanes * lane_bytes(win);
  switch (team_warps) {
    case 1:
      return launch_packed<K<WarpTeam<1>>::kernel>(batch, lanes, threads,
                                                   bytes, stream, args...);
    case 2:
      return launch_packed<K<WarpTeam<2>>::kernel>(batch, lanes, threads,
                                                   bytes, stream, args...);
    case 4:
      return launch_packed<K<WarpTeam<4>>::kernel>(batch, lanes, threads,
                                                   bytes, stream, args...);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" size_t step_scratch_bytes(int win) { return step_bytes(win); }

extern "C" size_t step_smem_bytes(int win) { return smem_bytes(win); }

extern "C" size_t step_lane_bytes(int win) { return lane_bytes(win); }

extern "C" int step_pack_threads() { return kPackThreads; }

extern "C" int powdiff_launch(const void* v, const void* w, const void* hpd,
                              const void* lpd, const void* s, void* sign,
                              void* x, void* scratch, int batch, int full_w,
                              int win, int team_warps, int lanes,
                              int* cluster, void* stream) {
  return (int)dispatch<Powdiff>(
      batch, win, team_warps, lanes, cluster, (cudaStream_t)stream,
      (const int32_t*)v, (const int32_t*)w, (const int32_t*)hpd,
      (const int32_t*)lpd, (const int32_t*)s, (int32_t*)sign, (int32_t*)x,
      (unsigned char*)scratch, batch, full_w, win);
}

extern "C" int update_launch(const void* w, const void* x, const void* sign,
                             const void* h, const void* m, const void* act,
                             void* out, void* scratch, int batch, int full_w,
                             int win, int team_warps, int lanes,
                             int* cluster, void* stream) {
  return (int)dispatch<Update>(
      batch, win, team_warps, lanes, cluster, (cudaStream_t)stream,
      (const int32_t*)w, (const int32_t*)x, (const int32_t*)sign,
      (const int32_t*)h, (const int32_t*)m, (const int32_t*)act,
      (int32_t*)out, (unsigned char*)scratch, batch, full_w, win);
}
