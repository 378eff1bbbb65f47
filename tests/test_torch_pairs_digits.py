"""The pair kernel's schedule (`csrc/pairs.cu`), emulated on the CPU by
`repro_torch.kernels.bigmul.pairs_schedule_plain`, against the JAX
package's `mul_pallas` and `mulmod_pallas` (the single-instance Pallas
kernel, in interpret mode, as tests/test_torch_pairs.py runs it), the
port's plain version and Python ints, bit for bit.

The emulation stages the u window and the v tile as the kernel does
(every read asserted inside its buffer), clips each row tile's k range,
shares B fragments between `group` row tiles, flushes the s32 sums after
each v tile (their bound asserted), and chains the carry between the
output column tiles, reporting which tiles waited for their carry-in
and which carried out.  Small column tiles (`tc` 128 and 256 limbs, v
tiles of 64..200) give many tiles at widths JAX can run; the kernel's
own tiling (1,024 x 1,024) runs against Python ints.  Operands are
numpy- or random-seeded; widths are ragged in the JAX kernel's 64-limb
tiling and in the emulation's.  Tolerance: exact equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bigmul as JBM
from repro_torch.core import bigint as bi
from repro_torch.kernels import bigmul


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its limb tensors are
    a few dozen elements wide, and the test workers share the host's
    cores (at torch's default of one thread per core they oversubscribe
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = bi.BASE
TC, TV = 128, 64                      # the small tiling
WU, WV = 3 * TC + 5, 2 * TC + 3


def _t(xs, m):
    return bi.limbs_from_numpy(bi.batch_from_ints(xs, m), "cpu")


def _operands(seed, batch=4, wu=WU, wv=WV):
    """numpy-seeded limbs; lane 0 all-0xFFFF in both operands, lane 1 a
    zero u."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, B, (batch, wu), dtype=np.uint32)
    v = rng.integers(0, B, (batch, wv), dtype=np.uint32)
    u[0], v[0], u[1] = B - 1, B - 1, 0
    return u, v


def _ints(a):
    return [bi.to_int(row) for row in np.asarray(a)]


def _jax_mulmod(u, v, l_max, out_width):
    return np.asarray(jax.vmap(lambda a, b: JBM.mulmod_pallas(
        a, b, l_max, out_width))(jnp.asarray(u), jnp.asarray(v)))


def _check_ints(out, xs, ys, l_max):
    assert bi.batch_to_ints(out) == [x * y % B ** l_max
                                     for x, y in zip(xs, ys)]


@pytest.mark.parametrize("l_max", [1, TC - 1, TC, TC + 1, 2 * TC - 1,
                                   2 * TC, 2 * TC + 1, WU + WV])
def test_schedule_matches_mulmod_pallas(l_max):
    """The close product with l_max at and around column-tile edges:
    only the tiles below ceil(l_max / tc) run."""
    u, v = _operands(l_max)
    tu, tv = bi.limbs_from_numpy(u, "cpu"), bi.limbs_from_numpy(v, "cpu")
    out, waited, _ = bigmul.pairs_schedule_plain(tu, tv, l_max, WU + 2,
                                                 tc=TC, tv=TV)
    assert waited.shape[1] == -(-min(l_max, WU + 2) // TC)
    assert torch.equal(out, bigmul.mulmod_pairs_reference(tu, tv, l_max,
                                                          WU + 2))
    if l_max in (TC - 1, TC, TC + 1, 2 * TC):
        np.testing.assert_array_equal(_jax_mulmod(u, v, l_max, WU + 2),
                                      out.numpy().astype(np.uint32))
    _check_ints(out, _ints(u), _ints(v), min(l_max, WU + 2))


@pytest.mark.parametrize("wu,wv,wo", [(WU, WV, WU + WV), (WU, WV, 200),
                                      (20, 18, 40), (WV, WU, 300),
                                      (5, WU, WU + 5)])
def test_schedule_matches_mul_pallas(wu, wv, wo):
    u, v = _operands(wu + wo, wu=wu, wv=wv)
    tu, tv = bi.limbs_from_numpy(u, "cpu"), bi.limbs_from_numpy(v, "cpu")
    out, _, _ = bigmul.pairs_schedule_plain(tu, tv, wo, wo, tc=TC, tv=TV)
    if (wu, wv, wo) in ((WU, WV, WU + WV), (20, 18, 40)):
        want = jax.vmap(lambda a, b: JBM.mul_pallas(a, b, wo))(
            jnp.asarray(u), jnp.asarray(v))
        np.testing.assert_array_equal(np.asarray(want),
                                      out.numpy().astype(np.uint32))
    assert torch.equal(out, bigmul.mul_pairs_reference(tu, tv, wo))
    _check_ints(out, _ints(u), _ints(v), wo)


@pytest.mark.parametrize("tc,tv,group", [(128, 64, 1), (128, 96, 2),
                                         (256, 200, 2), (256, 64, 4),
                                         (512, 130, 2)])
def test_schedule_tilings(tc, tv, group):
    """Other column tiles, v tiles and row-tile groups: the same limbs."""
    u, v = _operands(tc + tv, wu=WU + 100, wv=WV + 40)
    tu, tv_ = bi.limbs_from_numpy(u, "cpu"), bi.limbs_from_numpy(v, "cpu")
    for l_max in (tc, tc + 3, WU + WV + 140):
        out, _, _ = bigmul.pairs_schedule_plain(
            tu, tv_, l_max, WU + WV + 140, tc=tc, tv=tv, group=group)
        _check_ints(out, _ints(u), _ints(v), l_max)


@pytest.mark.parametrize("w", [2 * TC + 2, 5 * TC])
def test_schedule_all_ones_waits_through_every_tile(w):
    """(B^w - 1)^2 mod B^w = 1: every whole tile above the first is 0
    after its carry-in, so each one's L_c is B^tc - X_c, all 0xFFFF from
    limb 4 up: the chain waits through every such tile, and each carries
    out.  (A last tile cut at l_max also sums columns past it, so its
    L_c need not be all 0xFFFF.)"""
    x = B ** w - 1
    xs = [x, x]
    out, waited, carry = bigmul.pairs_schedule_plain(_t(xs, w), _t(xs, w),
                                                     w, w, tc=TC, tv=TV)
    _check_ints(out, xs, xs, w)
    full = w // TC
    assert waited[:, 1:full].all() and not waited[:, 0].any()
    assert (carry[:, 1:full] == 1).all()
    if w == 2 * TC + 2:
        u = np.full((1, w), B - 1, dtype=np.uint32)
        np.testing.assert_array_equal(_jax_mulmod(u, u, w, w)[0],
                                      out[0].numpy().astype(np.uint32))


@pytest.mark.parametrize("tc,tv,tile,wt,wv", [(TC, TV, 2, 4 * TC + 7, 40),
                                              (1024, 1024, 1, 3200, 300)])
def test_schedule_carry_thresholds(tc, tv, tile, wt, wv):
    """Lanes whose tile `tile` sits just below B^tc after its carry-in
    (B^tc - 1, B^tc - 2: it waits, carries nothing) and just above (0, 1:
    it waits and carries out); the product exact through both."""
    us, vs = bigmul.threshold_lanes(tc, tile, wt, wv, tc + tile)
    wu = max(-(-x.bit_length() // 16) for x in us)
    u, v = _t(us, wu), _t(vs, wv)
    out, waited, carry = bigmul.pairs_schedule_plain(u, v, wt, wt, tc=tc,
                                                     tv=tv)
    _check_ints(out, us, vs, wt)
    assert waited[:, tile].tolist() == [True] * 4
    assert carry[:, tile].tolist() == [0, 0, 1, 1]
    assert torch.equal(out, bigmul.mulmod_pairs_reference(u, v, wt, wt))
    if tc == TC:
        np.testing.assert_array_equal(
            _jax_mulmod(bi.limbs_to_numpy(u), bi.limbs_to_numpy(v), wt, wt),
            out.numpy().astype(np.uint32))


@pytest.mark.parametrize("l_max", [1023, 1024, 1025, 2047, 2048, 2049, 3600])
def test_schedule_kernel_tiling(l_max):
    """The kernel's own tiling (1,024-limb column and v tiles, two row
    tiles per B fragment) at l_max around its tile edges, against the
    plain version and Python ints."""
    rnd = random.Random(l_max)
    wu, wv = 2100, 1500
    xs = [rnd.getrandbits(16 * wu) for _ in range(2)] + [B ** wu - 1]
    ys = [rnd.getrandbits(16 * wv) for _ in range(2)] + [B ** wv - 1]
    u, v = _t(xs, wu), _t(ys, wv)
    out, waited, _ = bigmul.pairs_schedule_plain(u, v, l_max, 3700)
    assert waited.shape == (3, -(-l_max // bigmul.PAIRS_TC))
    _check_ints(out, xs, ys, l_max)
    assert torch.equal(out, bigmul.mulmod_pairs_reference(u, v, l_max, 3700))


def test_schedule_kernel_tiling_all_ones():
    x = B ** 3072 - 1
    out, waited, carry = bigmul.pairs_schedule_plain(_t([x], 3072),
                                                     _t([x], 3072), 3072,
                                                     3072)
    _check_ints(out, [x], [x], 3072)
    assert waited.tolist() == [[False, True, True]]
    assert carry.tolist() == [[0, 1, 1]]


def test_pairs_contract_checked_before_the_device():
    """Operands past 2^16 limbs would break the column-sum contract: the
    wrapper and the emulation raise before anything else."""
    u = torch.zeros(1, bigmul.PAIRS_MAX_LIMBS + 1, dtype=torch.int32)
    for fn in (bigmul.mulmod_pairs_cuda, bigmul.pairs_schedule_plain):
        with pytest.raises(ValueError, match="column-sum contract"):
            fn(u, u, 2 * u.shape[1], 2 * u.shape[1])
    # a close product cut below the contract is fine
    out, _, _ = bigmul.pairs_schedule_plain(u, u, 3, 3)
    assert not out.any()
