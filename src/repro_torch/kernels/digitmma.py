"""The digit-GEMM schedule of the product kernels (`csrc/digitmma.cuh`),
its host-side cluster plan, and a plain emulation of it for the tests.

The product, step, finalization and Barrett kernels
(`mul_batch_kernel`, `powdiff_kernel`, `update_kernel`,
`correct_kernel`, `barrett_kernel`) read their 16-bit
limbs as 8-bit digits and compute the digit-column sums of a product
as one matrix product on the int8 tensor cores
(`mma.sync.m16n8k32.s32.u8.u8.s32`).  With N = 8 columns per row,

    C[r, c] = sum_k  a8[r*N + k] * b8[c - k],   k in [-(nb8 - 1), N - 1]

(digits outside an operand are 0), and digit column r*N + c of the
product is C[r, c].  A[r, k] = a8[r*N + k] is a sliding window of a,
B[k, c] = b8[c - k] a Toeplitz band of b, the same for every row;
neither is written out.  Rows come in tiles of 16 (the m of the mma),
k in steps of 32 (its k); each tile's k range is clipped to where its
window of a is nonzero.  A warp sweeps GROUP row tiles per B fragment
where its block has more tiles than warps, else one.
The s32 tile sums are flushed into 64-bit sums every K_CHUNK digits of
k, then digit columns fold into limb columns: col16[j] = c8[2j] +
c8[2j+1] * 2^8.

An instance runs on a thread-block cluster of `cluster_size(batch)`
blocks; block `rank` takes a contiguous range of row tiles, split by
`split_tiles` so that each block gets about the same number of k steps.
The step kernels also run packed (`step_plan`): at cluster 1 and a
small window, a team of warps per instance and several a block, the
tile groups dealt to the team's warps (the schedule of one block with
`warps` warps).

A launch asks only `cluster_size(batch, device_sms(device))`; the
kernels split rows themselves (`tile_scan` in csrc/digitmma.cuh) and
size their shared-memory staging (`mul_batch_smem_bytes`,
`step_smem_bytes`, `correct_smem_bytes`, `barrett_smem_bytes` in the
libraries), which each kernel's fit function (`fused.step_fit` & co.)
holds against shared memory through `check_staging`, on every launch
and before a division or a modulus launches anything (`ops.check_fit`).
`cluster_plan` (the split as row ranges) and `digit_columns_plain` (the
schedule's CPU emulation: the same windows, clipping, flushes, groups
and cluster split, with int32 tile sums whose bound is asserted) are
test-only: nothing on the main path calls them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .build import SMEM_BYTES
from .ops import resolve_columns

N = 8                 # columns of C per row (the n of m16n8k32)
TILE_ROWS = 16        # rows of a tile (the m)
K_STEP = 32           # digits of k per mma (the k)
K_CHUNK = 8192        # digits of k between flushes of the s32 sums
GROUP = 2             # row tiles a warp sweeps per B fragment, where a
WARPS = 16            # block has more tiles than warps (else 1)
SMS = 132             # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8       # the portable cluster size limit
# dynamic shared memory a block of the two kernels may ask for: Hopper's
# 227 KB less room for their static shared memory
DYNAMIC_SMEM_BYTES = SMEM_BYTES - 1024
# the s32 sums stay exact up to this many u8 x u8 terms
S32_TERMS = (2 ** 31 - 1) // (255 * 255)
# limb columns stay < 2^48 (cluster_resolve) up to this operand width
MAX_LIMBS = 1 << 16

assert K_CHUNK <= S32_TERMS

# the packed step geometry (csrc/step.cu, whose launch refuses a block
# of more threads or shared memory): (widest window, warps a team) from
# the narrowest; the widest window packed at all, and the widest packed
# under 1.5 instances an SM
PACK_TEAMS = ((272, 1), (528, 2), (1040, 4))
PACK_WINDOW = PACK_TEAMS[-1][0]
PACK_WINDOW_SPARSE = 144

# the cluster size each kernel's last launch used (after the launch's
# residency check), and its instances a block (1 where clustered), by
# kernel name (`fused._launch` records both)
last_cluster: dict[str, int] = {}
last_lanes: dict[str, int] = {}


def check_contract(na: int, nb: int) -> None:
    """Raise for operands whose limb columns could reach 2^48."""
    if min(na, nb) > MAX_LIMBS:
        raise ValueError(f"{na} x {nb} limbs: past the digit product's "
                         f"{MAX_LIMBS}-limb column-sum contract")


def check_staging(n: int, what: str) -> int:
    """n, the shared memory a launch of `what` stages; raises ValueError
    where that exceeds DYNAMIC_SMEM_BYTES."""
    if n > DYNAMIC_SMEM_BYTES:
        raise ValueError(f"{what} stages {n} bytes, more than shared "
                         f"memory holds")
    return n


def floor4(k: int) -> int:
    return k & ~3


def tile_range(t: int, na8: int, nb8: int, n: int = N):
    """(lo, hi) of k where row tile t's window of a meets a and k is a
    Toeplitz offset of b; empty when hi < lo."""
    lo = max(-(nb8 - 1), -(TILE_ROWS * t + TILE_ROWS - 1) * n)
    hi = min(n - 1, na8 - 1 - TILE_ROWS * t * n)
    return lo, hi


def tile_weight(t: int, na8: int, nb8: int, n: int = N) -> int:
    """k steps of row tile t plus one for its epilogue."""
    lo, hi = tile_range(t, na8, nb8, n)
    return 1 + ((hi - floor4(lo)) // K_STEP + 1 if hi >= lo else 0)


def split_tiles(weights, cs: int) -> list[int]:
    """Boundaries b_0 = 0 <= ... <= b_cs = len(weights): block r takes
    tiles [b_r, b_{r+1}), b_r the first s with cs * P(s) >= r * S (P the
    exclusive prefix sum of the weights, S their total)."""
    prefix = [0]
    for w in weights:
        prefix.append(prefix[-1] + w)
    total, t = prefix[-1], len(weights)
    bounds = [0]
    for r in range(1, cs):
        s = bounds[-1]
        while s < t and cs * prefix[s] < r * total:
            s += 1
        bounds.append(s)
    return bounds + [t]


def cluster_size(batch: int, sms: int = SMS) -> int:
    """1 when the batch fills the SMs, else the smallest power of two
    <= MAX_CLUSTER with batch * size >= sms."""
    cs = 1
    while cs < MAX_CLUSTER and 0 < batch * cs < sms:
        cs *= 2
    return cs


class StepPlan(NamedTuple):
    """A packed step launch: `warps` warps a team (one instance),
    `lanes` teams a block."""
    warps: int
    lanes: int


def step_plan(win: int, batch: int, sms: int, lane_bytes: int,
              threads: int) -> StepPlan | None:
    """The packed geometry of a powdiff or update launch, or None for the
    clustered one; `lane_bytes` is the shared memory of one packed
    instance at this window (the step library's `step_lane_bytes(win)`),
    `threads` the most of a packed block (its `step_pack_threads()`).
    Packed where an instance's cluster would be one block (batch >= sms)
    and the window is at most PACK_WINDOW limbs: there a clustered launch
    costs about the same at every window (a serial chain of block and
    cluster barriers per instance, two instances per SM), and tens of
    instances per SM hide it.  Under 1.5 instances an SM most SMs would
    run one clustered block alone, which finishes a window wider than
    PACK_WINDOW_SPARSE sooner than a team does, so only windows up to
    that pack there.  A team is one warp up to 272 limbs, two up to 528
    and four above, where the product grows; blocks hold as many teams as
    `threads` and DYNAMIC_SMEM_BYTES allow, and nothing packs
    where one instance does not fit.  (On an H100 at 2^15-2^18 bits, from
    132 to 131,072 instances: PERF.md.)"""
    if cluster_size(batch, sms) != 1 or win > PACK_WINDOW:
        return None
    if 2 * batch < 3 * sms and win > PACK_WINDOW_SPARSE:
        return None
    warps = next(w for top, w in PACK_TEAMS if win <= top)
    lanes = min(threads // (32 * warps), DYNAMIC_SMEM_BYTES // lane_bytes)
    return StepPlan(warps, lanes) if lanes else None


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sms(device.index if device.index is not None
                else torch.cuda.current_device())


def cluster_plan(batch: int, rows: int, sms: int = SMS, weights=None):
    """(cluster size, [(first row, end row) per block rank]) for an
    instance whose C has `rows` rows: contiguous ranges of whole row
    tiles, balanced by the tiles' `weights` (default: equal), as the
    kernels' `tile_scan` splits them.  Test-only."""
    cs = cluster_size(batch, sms)
    tiles = -(-rows // TILE_ROWS)
    if weights is None:
        weights = [1] * tiles
    if len(weights) != tiles:
        raise ValueError(f"{len(weights)} weights for {tiles} row tiles")
    b = split_tiles(weights, cs)
    return cs, [(min(TILE_ROWS * b[r], rows), min(TILE_ROWS * b[r + 1], rows))
                for r in range(cs)]


def _digits(a: torch.Tensor) -> torch.Tensor:
    """(batch, w) limbs -> (batch, 2w) little-endian 8-bit digits."""
    a = a.to(torch.int64)
    return torch.stack([a & 0xFF, a >> 8], dim=-1).reshape(a.shape[0], -1)


def digit_columns_plain(u: torch.Tensor, v: torch.Tensor, out_width: int,
                        *, n: int = N, k_chunk: int = K_CHUNK,
                        cluster: int | None = None,
                        group: int = GROUP,
                        warps: int = WARPS) -> torch.Tensor:
    """Limb column sums (batch, out_width) int64 of u * v by the kernels'
    schedule, on the CPU: `ops.resolve_columns` of them is (u * v) mod
    B^out_width.  `cluster` defaults to `cluster_size(batch)`; `warps`
    (the kernels' 16) sets where tiles start to share B fragments."""
    if k_chunk % K_STEP or not 0 < k_chunk <= S32_TERMS:
        raise ValueError(f"k_chunk {k_chunk}: a multiple of {K_STEP} up "
                         f"to {S32_TERMS}")
    batch = u.shape[0]
    na, nb = min(u.shape[1], out_width), min(v.shape[1], out_width)
    a, b = u[:, :na], v[:, :nb]
    if nb > na:                         # B is the shorter operand
        a, b, na, nb = b, a, nb, na
    check_contract(na, nb)
    n_cols = min(out_width, na + nb)
    na8, nb8 = 2 * na, 2 * nb
    rows = -(-2 * n_cols // n)
    tiles = -(-rows // TILE_ROWS)
    cs = cluster_size(batch) if cluster is None else cluster
    weights = [tile_weight(t, na8, nb8, n) for t in range(tiles)]
    bounds = split_tiles(weights, cs)
    # zero-padded digits: a8[i] at i + pa, b8[d] at d + pb
    pa = TILE_ROWS * n + 2 * K_STEP
    pb = n + 2 * K_STEP
    a8 = torch.nn.functional.pad(_digits(a), (pa, pa))
    b8 = torch.nn.functional.pad(_digits(b), (pb, pb))
    c8 = torch.zeros(batch, tiles * TILE_ROWS * n, dtype=torch.int64)
    i16 = torch.arange(TILE_ROWS)[:, None]
    j32 = torch.arange(K_STEP)
    cn = torch.arange(n)
    flush_every = k_chunk // K_STEP
    bound = 2 ** 31
    for r in range(cs):
        gsz = group if bounds[r + 1] - bounds[r] > warps else 1
        for g0 in range(bounds[r], bounds[r + 1], gsz):
            grp = range(g0, min(g0 + gsz, bounds[r + 1]))
            rng = {t: tile_range(t, na8, nb8, n) for t in grp}
            live = [t for t in grp if rng[t][1] >= rng[t][0]]
            if not live:
                continue
            lo_g = min(rng[t][0] for t in live)
            hi_g = max(rng[t][1] for t in live)
            acc32 = {t: torch.zeros(batch, TILE_ROWS, n, dtype=torch.int64)
                     for t in live}
            acc64 = {t: torch.zeros_like(acc32[t]) for t in live}
            k0, step = floor4(lo_g), 0
            while k0 <= hi_g:
                kk = k0 + j32                                  # (32,)
                # B[k, c] = b8[c - k]
                bmat = b8[:, cn[None, :] - kk[:, None] + pb]   # (b, 32, n)
                for t in live:
                    lo, hi = rng[t]
                    if k0 > hi or k0 + K_STEP - 1 < lo:
                        continue
                    rows_t = TILE_ROWS * t + i16               # (16, 1)
                    amat = a8[:, rows_t * n + kk[None, :] + pa]
                    acc32[t] += amat @ bmat
                    if acc32[t].abs().max() >= bound:
                        raise AssertionError("s32 tile sum overflowed")
                step += 1
                if step % flush_every == 0:
                    for t in live:
                        acc64[t] += acc32[t]
                        acc32[t].zero_()
                k0 += K_STEP
            for t in live:
                base = TILE_ROWS * t * n
                c8[:, base:base + TILE_ROWS * n] = (
                    acc64[t] + acc32[t]).reshape(batch, -1)
    c8 = c8[:, :2 * n_cols]
    col = c8[:, 0::2] + (c8[:, 1::2] << 8)
    return torch.nn.functional.pad(col, (0, out_width - n_cols))


def mul_digits_plain(u: torch.Tensor, v: torch.Tensor, out_width: int,
                     **kw) -> torch.Tensor:
    """(u * v) mod B^out_width through `digit_columns_plain`."""
    return resolve_columns(digit_columns_plain(u, v, out_width, **kw))
