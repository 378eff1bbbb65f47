"""The digit-GEMM schedule of the port's product and Barrett kernels
(`repro_torch.kernels.digitmma`) against the JAX package, bit for bit.

`digit_columns_plain` emulates on the CPU what `csrc/digitmma.cuh` runs
on the card: the same 8-bit digit windows and Toeplitz bands, the same
k clipping per row tile, the same s32 flushes every `k_chunk` digits and
the same split of row tiles over a cluster.  Its columns, resolved to
limbs, must equal the JAX package's `impl="blocked"` product, and the
Barrett core composed over it must equal JAX `reduce_shared_batch`.
Operands come from numpy with a fixed seed; tolerance: exact equality.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.core import modarith as JM
from repro.kernels import ops as JK
from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.kernels import digitmma as D
from repro_torch.kernels import fused as F
from repro_torch.kernels import ops as K

B = bi.BASE

# (wu, wv, out_width): widths 1-130 limbs; out_width below, at and above
# the 64-limb row-tile edges; a truncated and a full product
SHAPES = [(1, 1, 2), (7, 130, 137), (130, 130, 63), (130, 130, 64),
          (130, 130, 65), (64, 64, 128), (65, 64, 127), (65, 64, 129),
          (100, 33, 133), (130, 130, 260)]
# (cluster size, k_chunk, warps): every cluster size, flushes every 32,
# 64 and 96 digits of k (several flushes at these widths), and one or
# two warps per block, so that row tiles share B fragments in pairs
SCHEDULES = [(1, D.K_CHUNK, 16), (2, 32, 16), (4, 96, 16), (8, 64, 16),
             (1, 32, 1), (2, 64, 2)]


def _limbs(seed, batch, w):
    """numpy-seeded (batch, w) limbs: lane 0 all-0xFFFF, lane 1 zero,
    lane 2 a short value, the rest random."""
    a = np.random.default_rng(seed).integers(0, B, (batch, w),
                                             dtype=np.uint32)
    a[0] = B - 1
    a[1] = 0
    a[2, 1:] = 0
    return a


@functools.lru_cache(maxsize=None)
def _jax_product(wu, wv, wo):
    u, v = _limbs(wu, 5, wu), _limbs(wv + 1000, 5, wv)
    want = JK.mul_batch_jit(jnp.asarray(u), jnp.asarray(v), wo,
                            impl="blocked")
    return u, v, np.asarray(want).astype(np.int64)


@pytest.mark.parametrize("cluster,k_chunk,warps", SCHEDULES)
@pytest.mark.parametrize("wu,wv,wo", SHAPES)
def test_digit_columns_match_jax_blocked(wu, wv, wo, cluster, k_chunk,
                                         warps):
    u, v, want = _jax_product(wu, wv, wo)
    col = D.digit_columns_plain(bi.limbs_from_numpy(u, "cpu"),
                                bi.limbs_from_numpy(v, "cpu"), wo,
                                cluster=cluster, k_chunk=k_chunk,
                                warps=warps)
    assert col.shape == (u.shape[0], wo) and col.dtype == torch.int64
    got = K.resolve_columns(col).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)
    for x, y, row in zip(u, v, got):
        assert bi.to_int(row) == bi.to_int(x) * bi.to_int(y) % B ** wo


@functools.lru_cache(maxsize=None)
def _jax_reduce(m):
    rng = np.random.default_rng(m)
    vint = bi.to_int(rng.integers(0, B, m, dtype=np.uint32)) | 1 << (16 * m - 1)
    xs = [bi.to_int(r) for r in rng.integers(0, B, (12, 2 * m),
                                             dtype=np.uint32)]
    xs[:4] = [B ** (2 * m) - 1, 0, vint - 1, vint * (B ** m - 1)]
    ctx = JM.barrett_precompute(jnp.asarray(JB.from_int(vint, m)),
                                impl="blocked")
    x = JB.batch_from_ints(xs, 2 * m)
    r = JM.reduce_shared_batch(ctx, jnp.asarray(x), impl="blocked")
    return (vint, xs, x, np.asarray(ctx.v), np.asarray(ctx.mu),
            np.asarray(r).astype(np.int64))


@pytest.mark.parametrize("cluster", [1, 8])
@pytest.mark.parametrize("m", [4, 9])
def test_barrett_over_digit_product_matches_jax(m, cluster):
    """The Barrett core with the schedule's product, against JAX
    reduce_shared_batch with x < B^(2m)."""
    vint, xs, x, v, mu, want = _jax_reduce(m)
    mul = functools.partial(D.mul_digits_plain, cluster=cluster, k_chunk=32)
    r = F.barrett_reference(bi.limbs_from_numpy(x, "cpu"),
                            bi.limbs_from_numpy(mu, "cpu"),
                            bi.limbs_from_numpy(v, "cpu"),
                            h=MA.barrett_h(m), mul=mul)[:, :m]
    np.testing.assert_array_equal(r.numpy().astype(np.int64), want)
    assert bi.batch_to_ints(r) == [xx % vint for xx in xs]


@pytest.mark.parametrize("batch,sms,size", [
    (256, 132, 1), (128, 132, 2), (64, 132, 4), (16, 132, 8), (1, 132, 8),
    (5, 132, 8), (131, 132, 2), (132, 132, 1), (133, 132, 1),
    # an H100 PCIe's 114 SMs
    (16, 114, 8), (32, 114, 4), (57, 114, 2), (114, 114, 1)])
def test_cluster_size(batch, sms, size):
    assert D.cluster_size(batch, sms) == size
    assert D.cluster_plan(batch, 100, sms)[0] == size


# the Refine windows up to 2^18 bits (costmodel.refine_window), each
# side of the team sizes', the sparse and the packed bounds, and the
# precompute's widest
PLAN_WINDOWS = [1, 32, 48, 80, 144, 145, 272, 273, 528, 529, 1040, 1041,
                2056, 2064, 32778]


# a stand-in for the step library's step_pack_threads() (its
# kPackThreads, which the card tests pass to step_plan)
PACK_THREADS = 256


def _lane_bytes(win):
    """A stand-in for the step library's step_lane_bytes (checked against
    the library on the card): team slots, the 64-bit column sums and both
    staged operands at two bytes a limb, with their zero pads."""
    return 16 + 16 * win + 4 * win + 576


@pytest.mark.parametrize("win", PLAN_WINDOWS)
@pytest.mark.parametrize("batch,sms", [(1, 132), (5, 132), (131, 132),
                                       (132, 132), (133, 132), (197, 132),
                                       (198, 132), (301, 132),
                                       (16384, 132), (131072, 132),
                                       (113, 114), (114, 114), (171, 114)])
def test_step_plan_engages_at_cluster_one_and_small_windows(win, batch,
                                                            sms):
    """Packed exactly where an instance's cluster is one block and the
    window is at most digitmma.PACK_WINDOW, which takes every window up to
    272 limbs (Refine iterations 0-7 at every width); under 1.5 instances
    an SM only up to PACK_WINDOW_SPARSE; never below one lane per SM (one
    lane runs on a cluster of 8)."""
    plan = D.step_plan(win, batch, sms, _lane_bytes(win), PACK_THREADS)
    one_block = D.cluster_size(batch, sms) == 1
    assert one_block == (batch >= sms)
    top = D.PACK_WINDOW if 2 * batch >= 3 * sms else D.PACK_WINDOW_SPARSE
    assert (plan is not None) == (one_block and win <= top)
    assert D.PACK_WINDOW >= 272 and D.PACK_WINDOW_SPARSE >= 32


@pytest.mark.parametrize("batch", [132, 301, 16384, 131072])
def test_step_plan_fits_the_block(batch):
    """At every window it packs, a plan's block fits the kernels' thread
    bound and DYNAMIC_SMEM_BYTES by the lane bytes it is given; a team is
    1, 2 or 4 warps (the kernels' instantiations) and a multi-warp team
    has a named barrier of its own (ids 1-15)."""
    top = D.PACK_WINDOW if 2 * batch >= 3 * D.SMS else D.PACK_WINDOW_SPARSE
    for win in range(1, top + 1):
        plan = D.step_plan(win, batch, D.SMS, _lane_bytes(win),
                           PACK_THREADS)
        assert plan is not None
        assert plan.warps == next(w for top, w in D.PACK_TEAMS
                                  if win <= top)
        assert plan.warps in (1, 2, 4) and plan.lanes >= 1
        assert 32 * plan.warps * plan.lanes <= PACK_THREADS <= 1024
        assert plan.warps == 1 or plan.lanes <= 15
        assert plan.lanes * _lane_bytes(win) <= D.DYNAMIC_SMEM_BYTES


@pytest.mark.parametrize("lane_bytes,lanes", [
    (1, 8), (D.DYNAMIC_SMEM_BYTES // 8, 8), (D.DYNAMIC_SMEM_BYTES // 3, 3),
    (D.DYNAMIC_SMEM_BYTES, 1), (D.DYNAMIC_SMEM_BYTES + 1, 0)])
def test_step_plan_sizes_blocks_by_the_lane_bytes_given(lane_bytes, lanes):
    """Teams a block follow the shared memory of one instance that the
    caller passes (the library's own figure); where one instance does not
    fit, the launch stays clustered."""
    plan = D.step_plan(32, 16384, D.SMS, lane_bytes, PACK_THREADS)
    assert (plan.lanes if plan else 0) == lanes


@pytest.mark.parametrize("batch", [256, 128, 64, 16])
@pytest.mark.parametrize("rows", [1, 16, 17, 100, 4098])
@pytest.mark.parametrize("weighted", [False, True])
def test_cluster_plan_covers_every_row_once(batch, rows, weighted):
    tiles = -(-rows // D.TILE_ROWS)
    weights = ([D.tile_weight(t, 2 * rows, rows, 8) for t in range(tiles)]
               if weighted else None)
    cs, ranges = D.cluster_plan(batch, rows, weights=weights)
    assert len(ranges) == cs
    covered = [r for lo, hi in ranges for r in range(lo, hi)]
    assert covered == list(range(rows))
    for lo, _ in ranges:
        assert lo % D.TILE_ROWS == 0 or lo == rows
    if weighted and tiles >= 8 * cs:
        w = weights
        share = [sum(w[lo // 16:-(-hi // 16)]) for lo, hi in ranges]
        assert max(share) <= sum(w) / cs + max(w)


def test_k_chunk_must_keep_s32_sums_exact():
    u = torch.full((1, 4), B - 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="k_chunk"):
        D.digit_columns_plain(u, u, 8, k_chunk=D.S32_TERMS + 32)
    with pytest.raises(ValueError, match="k_chunk"):
        D.digit_columns_plain(u, u, 8, k_chunk=48)


# -- the deep main loop (csrc/digitmma.cuh sweep_deep) ------------------------

RING = 4 * D.DEEP            # the kernel's kRing: A words a lane holds


def _deep_trace(tg, ng, na8, nb8, k_chunk):
    """One group of D.DEEP row tiles from tile tg (ng of them real) as
    sweep_deep runs it, step by step: the events ("mma", j, s) and
    ("flush",) in order, the shared words it loads (A, B) and the mma it
    issues in its parity passes (steady) and in all.  The A ring of each
    pass is kept as a dict slot -> word x (A's words 16 bytes apart, tile
    j at step s reading x = 8j + 2s + {0, 4, 1, 5}), and every pass mma
    is checked to find its four words in the slots it names; the steps
    between two flushes are counted and held to k_chunk."""
    chunk = k_chunk // D.K_STEP
    rng = [D.tile_range(tg + j, na8, nb8) if j < ng else (1, 0)
           for j in range(D.DEEP)]
    live = [j for j in range(D.DEEP) if rng[j][1] >= rng[j][0]]
    ev, st = [], dict(a=0, b=0, mma=0, steady_a=0, steady_b=0,
                      steady_mma=0, edges=0, fill=0)
    run = 0                            # steps in the s32 sums since a flush

    def flush():
        nonlocal run
        ev.append(("flush",))
        run = 0

    if live:
        lo_g = min(rng[j][0] for j in live)
        hi_g = max(rng[j][1] for j in live)
        k_start = D.floor4(lo_g)
        steps = (hi_g - k_start) // D.K_STEP + 1
        big = 1 << 30
        first = [(lo - k_start) >> 5 if hi >= lo else big for lo, hi in rng]
        last = [(hi - k_start) >> 5 if hi >= lo else -1 for lo, hi in rng]
        s0, s1 = max([0] + first), min([steps - 1] + last)
        if s0 > s1:
            s0 = steps
        cnt = 0

        def edge(s):
            nonlocal cnt, run
            st["b"] += 4
            st["edges"] += 1
            for j in range(D.DEEP):
                if first[j] <= s <= last[j]:
                    st["a"] += 4
                    st["mma"] += 1
                    ev.append(("mma", j, s))
            cnt += 1
            run += 1
            if cnt == chunk:
                cnt = 0
                flush()

        for s in range(s0):
            edge(s)
        for s in range(steps if s0 > s1 else s1 + 1, steps):
            edge(s)
        for par in range(2):
            sp = s0 + par
            if sp > s1:
                break
            n = (s1 - sp) // 2 + 1
            ring = {}
            for m in range(RING // 2 - 1):
                ring[2 * m], ring[2 * m + 1] = 2 * sp + 4 * m, 2 * sp + 4 * m + 1
                st["a"] += 2
                st["fill"] += 2
            q = base = 0
            while q < n:
                if cnt > chunk - RING // 2:
                    cnt = 0
                    flush()
                cnt += RING // 2
                for i in range(RING // 2):
                    if q == n:
                        break
                    m = i + RING // 2 - 1
                    x = 2 * sp + 4 * (base + m)
                    ring[2 * m % RING], ring[(2 * m + 1) % RING] = x, x + 1
                    st["a"] += 2
                    st["b"] += 4
                    st["steady_a"] += 2
                    st["steady_b"] += 4
                    s = sp + 2 * q
                    for j in range(D.DEEP):
                        r = 2 * (2 * j + i)
                        got = [ring[r % RING], ring[(r + 2) % RING],
                               ring[(r + 1) % RING], ring[(r + 3) % RING]]
                        assert got == [8 * j + 2 * s + o for o in (0, 4, 1, 5)]
                        st["mma"] += 1
                        st["steady_mma"] += 1
                        ev.append(("mma", j, s))
                    run += 1
                    assert run <= chunk, "s32 sums past k_chunk"
                    q += 1
                base += RING // 2
        want = {(j, s) for j in live for s in range(first[j], last[j] + 1)}
        got = [(e[1], e[2]) for e in ev if e[0] == "mma"]
        assert len(got) == len(set(got)) and set(got) == want
        st["k_start"] = k_start
    flush()                            # the closing put
    return ev, st


def digit_columns_deep(u, v, out_width, *, cluster=1, k_chunk=D.K_CHUNK,
                       warps=D.WARPS):
    """Limb column sums of u * v by the deep kernels' schedule: a block of
    at least D.DEEP * warps row tiles sweeps them in groups of D.DEEP by
    `_deep_trace` (int32 tile sums, bound asserted), a smaller one as
    `digit_columns_plain` does.  Returns (columns, the summed loads and
    mma of the deep groups)."""
    if k_chunk % D.K_STEP or not RING // 2 * D.K_STEP <= k_chunk <= D.S32_TERMS:
        raise ValueError(f"k_chunk {k_chunk}")
    batch = u.shape[0]
    na, nb = min(u.shape[1], out_width), min(v.shape[1], out_width)
    a, b = u[:, :na], v[:, :nb]
    if nb > na:
        a, b, na, nb = b, a, nb, na
    n, n_cols = D.N, min(out_width, na + nb)
    na8, nb8 = 2 * na, 2 * nb
    tiles = -(-2 * n_cols // n // D.TILE_ROWS)
    bounds = D.split_tiles([D.tile_weight(t, na8, nb8) for t in range(tiles)],
                           cluster)
    pa, pb = D.TILE_ROWS * n + 2 * D.K_STEP, n + 2 * D.K_STEP
    a8 = torch.nn.functional.pad(D._digits(a), (pa, pa))
    b8 = torch.nn.functional.pad(D._digits(b), (pb, pb))
    c8 = torch.zeros(batch, tiles * D.TILE_ROWS * n, dtype=torch.int64)
    i16, j32, cn = torch.arange(D.TILE_ROWS)[:, None], torch.arange(D.K_STEP), \
        torch.arange(n)
    total = dict(a=0, b=0, mma=0, steady_a=0, steady_b=0, steady_mma=0,
                 edges=0, fill=0, groups=0)
    plain = []
    for r in range(cluster):
        t0, t1 = bounds[r], bounds[r + 1]
        if t1 - t0 < D.DEEP * warps:
            plain += list(range(t0, t1))
            continue
        for tg in range(t0, t1, D.DEEP):
            ng = min(D.DEEP, t1 - tg)
            ev, st = _deep_trace(tg, ng, na8, nb8, k_chunk)
            total["groups"] += 1
            for key in st:
                if key != "k_start":
                    total[key] += st[key]
            acc = torch.zeros(D.DEEP, batch, D.TILE_ROWS, n, dtype=torch.int64)
            wide = torch.zeros_like(acc)
            for e in ev:
                if e[0] == "flush":
                    wide += acc
                    acc.zero_()
                    continue
                _, j, s = e
                kk = st["k_start"] + D.K_STEP * s + j32
                bmat = b8[:, cn[None, :] - kk[:, None] + pb]
                amat = a8[:, (D.TILE_ROWS * (tg + j) + i16) * n + kk[None, :] + pa]
                acc[j] += amat @ bmat
                assert acc[j].abs().max() < 2 ** 31, "s32 tile sum overflowed"
            for j in range(ng):
                base = D.TILE_ROWS * (tg + j) * n
                c8[:, base:base + D.TILE_ROWS * n] = wide[j].reshape(batch, -1)
    c8 = c8[:, :2 * n_cols]
    col = c8[:, 0::2] + (c8[:, 1::2] << 8)
    col = torch.nn.functional.pad(col, (0, out_width - n_cols))
    if plain:                           # the pair loop's tiles, as it sums them
        ref = D.digit_columns_plain(u, v, out_width, cluster=cluster,
                                    k_chunk=D.K_CHUNK, warps=warps)
        for t in plain:
            lo, hi = t * D.TILE_ROWS * n // 2, min((t + 1) * D.TILE_ROWS * n // 2,
                                                   n_cols)
            col[:, lo:hi] = ref[:, lo:hi]
    return col, total


# (wu, wv, out_width): full and truncated products, a B shorter than one
# k step (nb8 < 32), one row tile, out_width at and off the 64-limb
# tile edges, an A much longer than B
DEEP_SHAPES = [(130, 130, 260), (130, 130, 200), (7, 300, 307), (15, 300, 250),
               (16, 16, 32), (40, 40, 64), (200, 100, 300), (257, 129, 386),
               (300, 3, 303), (64, 64, 127)]
# (cluster, k_chunk, warps): one to eight blocks, flushes every 8 to 256
# k steps (so several in a tile's range), one or two warps a block so
# that small shapes hold D.DEEP * warps tiles
DEEP_SCHEDULES = [(1, 256, 1), (2, 288, 1), (8, 256, 1), (1, D.K_CHUNK, 1),
                  (1, 512, 2), (4, 320, 1)]


@pytest.mark.parametrize("cluster,k_chunk,warps", DEEP_SCHEDULES)
@pytest.mark.parametrize("wu,wv,wo", DEEP_SHAPES)
def test_deep_schedule_matches_the_pair_schedule(wu, wv, wo, cluster,
                                                 k_chunk, warps):
    """The deep loop's columns equal the pair loop's (digit_columns_plain,
    held to JAX above) and Python's product, on edge and random lanes;
    every pass mma finds its A words in the ring (checked inside)."""
    u = bi.limbs_from_numpy(_limbs(wu + 7, 5, wu), "cpu")
    v = bi.limbs_from_numpy(_limbs(wv + 11, 5, wv), "cpu")
    got, st = digit_columns_deep(u, v, wo, cluster=cluster, k_chunk=k_chunk,
                                 warps=warps)
    want = D.digit_columns_plain(u, v, wo, cluster=cluster, warps=warps)
    assert torch.equal(got, want)
    for x, y, row in zip(bi.batch_to_ints(u), bi.batch_to_ints(v),
                         bi.batch_to_ints(K.resolve_columns(got))):
        assert row == x * y % B ** wo


@pytest.mark.parametrize("wu,wv", [(1024, 1024), (1024, 200)])
def test_deep_schedule_loads_per_mma(wu, wv):
    """Counted from the schedule: each pass step loads 2 A words and a
    4-word B fragment for D.DEEP mma (1.5 an mma), and a long product
    under 3 an mma with its ring fills and ragged ends (one step at a
    time, 4 A words a tile); the pair loop loads 6 an mma (4 A words and
    half a B fragment)."""
    u = bi.limbs_from_numpy(_limbs(3, 3, wu), "cpu")
    v = bi.limbs_from_numpy(_limbs(4, 3, wv), "cpu")
    _, st = digit_columns_deep(u, v, wu + wv, warps=1)
    assert (st["steady_a"] + st["steady_b"]) * D.DEEP == 6 * st["steady_mma"]
    assert st["steady_mma"] > 0.8 * st["mma"]
    assert (st["a"] + st["b"]) / st["mma"] < 3


@pytest.mark.parametrize("nb8", [2, 14, 31, 32, 33, 200, 4096])
@pytest.mark.parametrize("tg", [0, 1, 3, 7, 40, 62])
def test_deep_trace_peels_exactly_the_ragged_ends(tg, nb8):
    """Steps outside the passes are exactly those where a tile of the
    group is idle (the ends of the k ranges, which differ by 4 steps a
    tile where the window of a clips them); every tile's steps run once
    (checked inside); a group past the product's last row only flushes."""
    na8 = 2 * 4096
    ev, st = _deep_trace(tg, D.DEEP, na8, nb8, D.K_CHUNK)
    steps = {(e[1], e[2]) for e in ev if e[0] == "mma"}
    busy = [s for s in {s for _, s in steps}
            if all((j, s) in steps for j in range(D.DEEP))]
    assert st["edges"] == len({s for _, s in steps}) - len(busy)
    assert st["steady_mma"] == D.DEEP * len(busy)
    ev, st = _deep_trace((na8 + nb8) // 128 + 1, D.DEEP, na8, nb8,
                         D.K_CHUNK)
    assert ev == [("flush",)] and st["mma"] == 0


# (k_limbs, n_cols, cluster, loop): products of a k_limbs-limb operand
# and an (n_cols - k_limbs)-limb one, the cells' full windows and the
# edges of the rule, each side of the readings it was drawn from
# (PERF.md: deep against pair at 2^15-2^18 bits on the card)
MAIN_LOOP_CASES = [
    (2056, 4112, 1, "deep"), (16392, 32784, 1, "deep"),
    (4096, 8192, 1, "deep"), (2048, 4096, 1, "deep"),
    (2048, 4032, 1, "pair"),            # 63 tiles: fewer than the warps' groups
    (256, 8448, 1, "deep"), (255, 8447, 1, "deep"), (64, 8256, 1, "deep"),
    (16392, 32784, 8, "pair"),          # 64 tiles a block under a cluster
    (16392, 32784, 4, "deep"), (16392, 32784, 2, "deep"),
    (8192, 16384, 4, "pair"), (8192, 16384, 2, "deep"),
    (8192, 32788, 8, "pair"),           # Barrett at 2^17 bits, 16 lanes
]


@pytest.mark.parametrize("k_limbs,n_cols,cluster,loop", MAIN_LOOP_CASES)
def test_main_loop_rule(k_limbs, n_cols, cluster, loop):
    """The rule of digit_product: deep where a block holds a group of
    DEEP tiles a warp, and the product two a warp for each block of a
    cluster, whatever the length of k; here every block of the split
    (split_tiles) takes `loop`."""
    na8, nb8 = 2 * (n_cols - k_limbs), 2 * k_limbs
    tiles = -(-n_cols // 64)
    bounds = D.split_tiles([D.tile_weight(t, na8, nb8)
                            for t in range(tiles)], cluster)
    got = {D.main_loop(n_cols, cluster, bounds[r + 1] - bounds[r])
           for r in range(cluster)}
    assert got == {loop}
    if loop == "deep":
        assert tiles / cluster >= D.DEEP * D.WARPS
