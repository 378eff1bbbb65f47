"""Wrappers of the two standalone product kernels.

`mul_batch_cuda` (csrc/mul.cu) replaces
`repro/kernels/bigmul.py:mul_pallas_batched`: exact (u * v) mod
B^out_width as an 8-bit digit GEMM on the int8 tensor cores, an
instance spread over a thread-block cluster below 132 lanes
(`kernels/digitmma.py`); `kernels/ops.py:mul_plain` is its plain
version.

`mul_pairs` and `mulmod_pairs` (csrc/pairs.cu) replace `mul_pallas` and
`mulmod_pallas`, whose `_mul_kernel` summed tile pairs per output
diagonal.  On the card one launch computes the product as an int8
tensor-core digit GEMM per output column tile of an instance and
chains the carries between the tiles (`mulmod_pairs_cuda`).  Their
plain versions `mul_pairs_reference` and `mulmod_pairs_reference`, which
the CPU runs, sum the tile pairs per diagonal (`ops.pair_sums_plain`)
and overlap-add and resolve them (`ops.columns_from_pairs`).
`pairs_schedule_plain` emulates the kernel's schedule on the CPU for
the tests, and `threshold_lanes` builds operands at its carry chain's
edge; nothing on a path calls them.
"""

from __future__ import annotations

import ctypes
import random

import torch

from repro_torch.core import arith as A
from . import build, digitmma as D, ops
from .build import check_limbs


def mul_batch_cuda(u: torch.Tensor, v: torch.Tensor,
                   out_width: int) -> torch.Tensor:
    """(batch, Wu) x (batch, Wv) int32 limbs on the card -> (batch,
    out_width): one kernel launch, on clusters of
    `digitmma.cluster_size(batch, sms)` blocks per instance."""
    if u.ndim != 2 or v.ndim != 2 or u.shape[0] != v.shape[0]:
        raise ValueError(f"expected (batch, W) operands with equal batch, "
                         f"got {tuple(u.shape)} x {tuple(v.shape)}")
    u, v = u.contiguous(), v.contiguous()
    check_limbs("u", u)
    check_limbs("v", v)
    batch, wu = u.shape
    wv = v.shape[1]
    D.check_contract(min(wu, out_width), min(wv, out_width))
    lib = build.lib("mul")
    if lib.mul_batch_smem_bytes(wu, wv, out_width) > D.DYNAMIC_SMEM_BYTES:
        raise ValueError("operands too wide for the shared-memory product")
    out = torch.empty(batch, out_width, dtype=torch.int32, device=u.device)
    if batch == 0:
        return out
    scratch = torch.empty(batch * lib.mul_batch_scratch_bytes(out_width),
                          dtype=torch.uint8, device=u.device)
    cluster = ctypes.c_int(D.cluster_size(batch, D.device_sms(u.device)))
    with build.on_device(u) as stream:
        err = lib.mul_batch_launch(u.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), scratch.data_ptr(), batch,
                                   wu, wv, out_width, ctypes.byref(cluster),
                                   stream)
    build.check(err, "mul_batch kernel")
    build.count("mul_batch")
    D.last_cluster["mul_batch"] = cluster.value
    return out


# column sums of the pair product stay < 2^48 up to this many limbs
# (the contract of ops.resolve_columns and of csrc/pairs.cu's resolve)
PAIRS_MAX_LIMBS = 1 << 16
# the pair kernel's schedule (csrc/pairs.cu; the library reports its
# column tile through mul_pairs_tile()): limb columns a block owns, limbs
# of a v tile, and row tiles of a warp sharing one B fragment
PAIRS_TC, PAIRS_TV, PAIRS_GROUP = 1024, 1024, 2


def _pairs_limbs(u, v, l_max, out_width):
    """(n, wu, wv): the limbs the pair product computes, n = min(l_max,
    out_width, wu + wv), and the operand limbs that can reach them."""
    if u.ndim != 2 or v.ndim != 2 or u.shape[0] != v.shape[0]:
        raise ValueError(f"expected (batch, W) operands with equal batch, "
                         f"got {tuple(u.shape)} x {tuple(v.shape)}")
    n = max(min(l_max, out_width, u.shape[1] + v.shape[1]), 0)
    wu, wv = min(u.shape[1], n), min(v.shape[1], n)
    if min(wu, wv) > PAIRS_MAX_LIMBS:
        raise ValueError(f"pair product of {wu} x {wv} limbs: past the "
                         f"{PAIRS_MAX_LIMBS}-limb column-sum contract")
    return n, wu, wv


def mulmod_pairs_cuda(u: torch.Tensor, v: torch.Tensor, l_max: int,
                      out_width: int) -> torch.Tensor:
    """The pair kernel: (u * v) mod B^l_max of (batch, Wu) x (batch, Wv)
    int32 limbs on the card, as (batch, out_width) canonical limbs, zero
    from l_max up, in one launch (one block per output column tile of
    an instance, the carries chained between the tiles in the launch).
    Raises for tensors that are not on the card.

    Besides the output it allocates the ticket and one publish word per
    column tile, which the library zeroes with cudaMemsetAsync before
    the launch: a memset, not a counted launch."""
    n, wu, wv = _pairs_limbs(u, v, l_max, out_width)
    u, v = u.contiguous(), v.contiguous()
    check_limbs("u", u)
    check_limbs("v", v)
    batch = u.shape[0]
    out = torch.empty(batch, out_width, dtype=torch.int32, device=u.device)
    if batch == 0 or out_width <= 0:
        return out
    if n == 0:
        return out.zero_()
    lib = build.lib("pairs")
    tiles = -(-n // lib.mul_pairs_tile())
    pub = torch.empty(1 + batch * tiles, dtype=torch.int64, device=u.device)
    with build.on_device(u) as stream:
        err = lib.mul_pairs_launch(u.data_ptr(), v.data_ptr(),
                                   out.data_ptr(), pub.data_ptr(), batch,
                                   u.shape[1], v.shape[1], wu, wv, n,
                                   out_width, stream)
    build.check(err, "mul_pairs kernel")
    build.count("mul_pairs")
    return out


def _mulmod_plain(u, v, l_max, out_width):
    l_max = min(l_max, out_width)
    r = ops.columns_from_pairs(
        ops.pair_sums_plain(u, v, ops.tiles_for(l_max)), out_width)
    return A.mask_below(r, l_max) if l_max < out_width else r


def _mulmod(u, v, l_max, out_width):
    if ops._check_device(u, v) == "cuda":
        return mulmod_pairs_cuda(u, v, l_max, out_width)
    return _mulmod_plain(u, v, l_max, out_width)


def mul_pairs(u: torch.Tensor, v: torch.Tensor,
              out_width: int) -> torch.Tensor:
    """Exact (u * v) mod B^out_width of (batch, Wu) x (batch, Wv) limbs:
    one pair-kernel launch on the card, its plain version on the CPU."""
    return _mulmod(u, v, out_width, out_width)


def mulmod_pairs(u: torch.Tensor, v: torch.Tensor, l_max: int,
                 out_width: int) -> torch.Tensor:
    """The close product (u * v) mod B^l_max at out_width limbs (zero
    from limb l_max up), computing only the column tiles below l_max
    (Algorithm 2's MULTMOD, as `mulmod_pallas` prunes; its plain version
    only the diagonals d < ceil(l_max / T))."""
    return _mulmod(u, v, l_max, out_width)


def mul_pairs_reference(u: torch.Tensor, v: torch.Tensor,
                        out_width: int) -> torch.Tensor:
    """Plain version of `mul_pairs` on either device."""
    return _mulmod_plain(u, v, out_width, out_width)


def mulmod_pairs_reference(u: torch.Tensor, v: torch.Tensor, l_max: int,
                           out_width: int) -> torch.Tensor:
    """Plain version of `mulmod_pairs` on either device."""
    return _mulmod_plain(u, v, l_max, out_width)


def pairs_schedule_plain(u: torch.Tensor, v: torch.Tensor, l_max: int,
                         out_width: int, *, tc: int = PAIRS_TC,
                         tv: int = PAIRS_TV, group: int = PAIRS_GROUP):
    """The pair kernel's schedule on the CPU, in int64 (test-only).

    Column tiles of `tc` limbs below n = min(l_max, out_width, wu + wv),
    v tiles of `tv` limbs, the u window and v tile staged as the kernel
    stages them (every read asserted inside its buffer), each row tile's
    k range clipped, `group` row tiles per B fragment, the s32 sums of
    one v tile (bound asserted) flushed into 64-bit sums; then each
    tile's L_c and H_c and the chained carry in ticket order.  Returns
    (limbs (batch, out_width) int32, waited (batch, tiles) bool: the
    tiles whose limbs 4.. of L_c are all 0xFFFF, which wait for their
    carry-in before they publish, carry (batch, tiles) int64: the
    bracket [L_c + X_c >= B^tc])."""
    from .digitmma import K_STEP, N, TILE_ROWS, _digits, floor4
    if tc % (64 * group) or 2 * tv + 2 * K_STEP > 8192:
        raise ValueError(f"tc {tc} must be a multiple of {64 * group}; "
                         f"tv {tv} at most {4096 - K_STEP}")
    n, wu, wv = _pairs_limbs(u, v, l_max, out_width)
    batch = u.shape[0]
    out = torch.zeros(batch, out_width, dtype=torch.int32)
    tiles = -(-n // tc) if batch else 0
    waited = torch.zeros(batch, tiles, dtype=torch.bool)
    carry = torch.zeros(batch, tiles, dtype=torch.int64)
    if n == 0 or batch == 0:
        return out, waited, carry
    pad = 2 * (n + tc + tv + 64)              # u is zero around its digits
    a8 = torch.nn.functional.pad(_digits(u[:, :wu].cpu()), (pad, pad))
    b8 = _digits(v[:, :wv].cpu())
    a_words, a_base = tc + tv + 32, tv + 8
    a0, pb = 2 * a_base, 2 * tv + 13
    b_bytes = (2 * tv + 80 + 15) & ~15
    i16 = torch.arange(TILE_ROWS)[:, None]
    j32 = torch.arange(K_STEP)
    cn = torch.arange(N)
    x = torch.zeros(batch, dtype=torch.int64)           # X_c
    for c in range(tiles):
        c0 = c * tc
        need = min(tc, n - c0)
        wide = torch.zeros(batch, tc // 4, N, dtype=torch.int64)
        j_lo = -(-max(0, c0 - wu - tv + 2) // tv)
        j_hi = min((wv - 1) // tv, (c0 + need - 1) // tv)
        for j in range(j_lo, j_hi + 1):
            j0 = j * tv
            nbj, off = min(tv, wv - j0), c0 - j0
            # the u window: byte a0 + x' holds u digit 2*off + x'
            lo_d = pad + 2 * (off - a_base)
            win = a8[:, lo_d:lo_d + 2 * a_words]
            # the v tile: byte pb - d holds v_j digit d
            bt = torch.zeros(batch, b_bytes, dtype=torch.int64)
            d = torch.arange(2 * nbj)
            bt[:, pb - d] = b8[:, 2 * j0 + d]
            for g0 in range(0, tc // 64, group):
                rng = {}
                for t in range(g0, g0 + group):
                    lo = max(-(2 * nbj - 1),
                             -2 * off - (TILE_ROWS * t + 15) * N)
                    hi = min(N - 1, 2 * wu - 1 - 2 * off - TILE_ROWS * t * N)
                    if 64 * t < need and hi >= lo:
                        rng[t] = (lo, hi)
                if not rng:
                    continue
                lo_g = min(r[0] for r in rng.values())
                hi_g = max(r[1] for r in rng.values())
                acc = {t: torch.zeros(batch, TILE_ROWS, N, dtype=torch.int64)
                       for t in rng}
                k0 = floor4(lo_g)
                while k0 <= hi_g:
                    kk = k0 + j32
                    bidx = pb - (cn[None, :] - kk[:, None])     # (32, N)
                    if bidx.min() < 0 or bidx.max() >= b_bytes:
                        raise AssertionError("B read outside its buffer")
                    bmat = bt[:, bidx]
                    for t, (lo, hi) in rng.items():
                        if k0 > hi or k0 + K_STEP - 1 < lo:
                            continue
                        ai = a0 + (TILE_ROWS * t + i16) * N + kk[None, :]
                        if ai.min() < 0 or ai.max() >= 2 * a_words:
                            raise AssertionError("A read outside its buffer")
                        acc[t] += win[:, ai] @ bmat
                    k0 += K_STEP
                for t, a in acc.items():
                    if a.max() >= 2 ** 31:
                        raise AssertionError("s32 tile sum overflowed")
                    wide[:, TILE_ROWS * t:TILE_ROWS * (t + 1)] += a
        c8 = wide.reshape(batch, 2 * tc)
        col = c8[:, 0::2] + (c8[:, 1::2] << 8)
        r = ops.resolve_columns(torch.nn.functional.pad(col, (0, 3)))
        low = r[:, :tc].to(torch.int64)
        h = r[:, tc].long() + (r[:, tc + 1].long() << 16) \
            + (r[:, tc + 2].long() << 32)
        waited[:, c] = (low[:, 4:] == 0xFFFF).all(dim=1)
        s = low.clone()
        for k in range(min(4, tc)):
            s[:, k] += (x >> (16 * k)) & 0xFFFF
        s = ops.resolve_columns(torch.nn.functional.pad(s, (0, 1)))
        carry[:, c] = s[:, tc].long()
        if bool((carry[:, c] > 0)[~waited[:, c]].any()):
            raise AssertionError("a tile that published early carried")
        out[:, c0:c0 + need] = s[:, :need]
        x = h + carry[:, c]
    return out, waited, carry


def threshold_lanes(tc: int, tile: int, wt: int, wv: int, seed: int):
    """Operands (Python ints) for the carry chain's edge (test-only): u,
    v whose product has output tile `tile` (limbs [tile*tc, (tile +
    1)*tc)) equal to B^tc - 1 or B^tc - 2 (L_c + X_c just below B^tc: no
    carry out) and 0 or 1 (just above: the carry-in wrapped the tile).
    The product is p - (p mod v) for a random p < B^wt with that tile: u
    = p // v, and the borrow of the subtraction stops at p's random limbs
    between v's width wv and the tile (so wv < tile * tc)."""
    base = 1 << 16
    rnd = random.Random(seed)
    us, vs = [], []
    mask = (base ** tc - 1) << (16 * tc * tile)
    for pattern in (base ** tc - 1, base ** tc - 2, 0, 1):
        v = rnd.getrandbits(16 * wv) | 1 << (16 * wv - 1)
        p = rnd.getrandbits(16 * wt) | 1 << (16 * wt - 1)
        us.append(((p & ~mask) | pattern << (16 * tc * tile)) // v)
        vs.append(v)
    return us, vs
