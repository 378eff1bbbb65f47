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
