"""The port's cost model in multiplications against the JAX package's:
`core/pyref.py` (the exact-int oracle and its `CostCounter`),
`obs/costmodel.py`'s constants and `refine_mul_work`, the paper's 5-7
full-multiplication band, and the work of every launch (limb products
and bytes) against a direct count of the products the plain versions
compute; `obs/roofline.py` over that work.
"""

import dataclasses
import math
import random

import numpy as np
import pytest

from repro.core import pyref as JR
from repro.obs import costmodel as JCM
from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.core import pyref as R
from repro_torch.core import shinv as S
from repro_torch.kernels import ops as K
from repro_torch.obs import costmodel as CM
from repro_torch.obs import roofline as RL

B = bi.BASE


def _records(counter):
    return [dataclasses.asdict(r) for r in counter.records]


@pytest.mark.parametrize("base,digits", [(10, 12), (B, 6), (B, 40),
                                         (2, 30), (7, 20)])
def test_pyref_matches_jax_pyref(base, digits):
    """divmod_shinv, shinv and powdiff with their CostCounter records
    equal to repro.core.pyref on seeded operands."""
    rnd = random.Random(base * 1000 + digits)
    for _ in range(12):
        u = rnd.randrange(base ** digits)
        v = rnd.randrange(1, base ** rnd.randint(1, digits))
        ours, theirs = R.CostCounter(), JR.CostCounter()
        got = R.divmod_shinv(u, v, base, ours)
        assert got == JR.divmod_shinv(u, v, base, theirs) == divmod(u, v)
        assert _records(ours) == _records(theirs)
        assert ours.digit_mults() == theirs.digit_mults()
        assert ours.n_full_mults(digits) == theirs.n_full_mults(digits)
        h = digits + 2
        assert R.shinv(v, h, base) == JR.shinv(v, h, base)
    assert R.shinv(27183, 15, 10) == 36787698193      # paper Example 1


def test_costmodel_constants_and_refine_mul_work_match_jax():
    assert (CM.DIV_FULL_MULTS_MIN, CM.DIV_FULL_MULTS_MAX,
            CM.BARRETT_MULS) == (JCM.DIV_FULL_MULTS_MIN,
                                 JCM.DIV_FULL_MULTS_MAX, JCM.BARRETT_MULS)
    sizes = [8, 9, 16, 33, 64, 100, 256, 1000, 1024, 2048, 4096, 8192,
             16384]
    for m in sizes:
        assert CM.refine_iters(m) == JCM.refine_iters(m)
        for windowed in (True, False):
            for width in (None, m + CM.PAD):
                assert CM.refine_mul_work(m, width, windowed) == \
                    JCM.refine_mul_work(m, width, windowed)
    # the windowed schedule costs less than 2 full mults per iteration
    assert CM.refine_mul_work(16384) < CM.refine_mul_work(
        16384, windowed=False) == 2 * CM.refine_iters(16384)


@pytest.mark.parametrize("m", [64, 256])
def test_full_multiplication_band(m):
    """The paper's 5-7 full multiplications per division from the
    port's pyref at the two smallest sizes of `benchmarks/costmodel.py`
    (prec(u) = M - 2, prec(v) in [2, M/2], 40 trials), asserted as it
    asserts them: min >= 5, median <= 7."""
    rng = np.random.default_rng(11 + m)
    counts = []
    for _ in range(40):
        u = bi._rand_big(rng, B ** (m - 3), B ** (m - 2))
        kv = int(rng.integers(2, m // 2 + 1))
        v = bi._rand_big(rng, B ** (kv - 1), B ** kv)
        c = R.CostCounter()
        assert R.divmod_shinv(u, v, B, c) == divmod(u, v)
        counts.append(c.n_full_mults(m) + sum(
            1 for rec in c.records
            if rec.where == "div-u*shinv" and rec.prec_out > m))
    assert CM.DIV_FULL_MULTS_MIN <= min(counts)
    assert sorted(counts)[len(counts) // 2] <= CM.DIV_FULL_MULTS_MAX


def _direct(a, b, n):
    return sum(1 for i in range(a) for j in range(b) if i + j < n)


def test_cut_products_is_a_direct_count():
    rnd = random.Random(0)
    cases = [(0, 3, 4), (3, 0, 4), (5, 5, 0), (1, 1, 1), (7, 3, 100)]
    cases += [(rnd.randint(0, 24), rnd.randint(0, 24), rnd.randint(0, 50))
              for _ in range(300)]
    for a, b, n in cases:
        assert CM.cut_products(a, b, n) == _direct(a, b, n), (a, b, n)


def test_per_launch_work_from_lane_limbs():
    """The data forms: powdiff, update, correct and barrett over given
    lane limbs, against direct counts."""
    rnd = random.Random(1)
    win, fw = 12, 20
    pv = [rnd.randint(0, win) for _ in range(6)]
    pw = [rnd.randint(0, win) for _ in range(6)]
    px = [rnd.randint(0, win) for _ in range(6)]
    off = [rnd.randint(-5, 15) for _ in range(6)]
    act = [True, False, True, True, False, True]
    assert CM.powdiff_work(6, fw, win, pv, pw) == (
        sum(a * b for a, b in zip(pv, pw)), 4 * 6 * (2 * win + fw + 4))
    prods, nbytes, kept = CM.update_work(6, fw, win, pw, px, off, act)
    assert prods == sum(
        _direct(a, b, min(a + b, max(o, 0) + win, 2 * win))
        for a, b, o, on in zip(pw, px, off, act) if on)
    assert nbytes == 4 * (4 * (2 * win + fw) + 2 * 2 * fw + 4 * 6)
    assert 0 < kept <= 1
    W = 16
    lanes = [(rnd.randint(1, W), rnd.randint(1, W), rnd.randint(1, W),
              rnd.randint(1, W), rnd.randint(0, W)) for _ in range(5)]
    assert CM.correct_work(5, W, lanes)[0] == sum(
        _direct(pu, ps, min(pu + ps, 2 * W, h + W))
        + _direct(pq, pv, min(pq + pv, W)) for pu, ps, pq, pv, h in lanes)
    m = 5
    Wb = CM.barrett_width(m)
    bl = [(rnd.randint(0, 2 * m), rnd.randint(0, Wb)) for _ in range(4)]
    assert CM.barrett_work(4, m, bl, nmu=Wb - 1, nv=m) == (
        sum(px * (Wb - 1) + _direct(nq, m, Wb) for px, nq in bl),
        4 * (4 * 2 * m + Wb + m + 4 * Wb))


class _Spy:
    """Counts every product the plain compositions call, directly."""

    def __init__(self):
        self.calls = []

    def __call__(self, u, v, out_width):
        self.calls.append(_direct(u.shape[1], v.shape[1], out_width)
                          * u.shape[0])
        return K.mul_plain(u, v, out_width)


@pytest.mark.parametrize("impl", ["cuda_batched", "cuda_pairs"])
@pytest.mark.parametrize("m,batch", [(4, 3), (9, 2)])
def test_op_work_is_the_plain_products(monkeypatch, impl, m, batch):
    """divmod, the precompute, reduce and modmul at (m, batch, impl):
    one work entry per product the unfused composition calls, with its
    limb products; cuda_fused's kernels need the same products, except
    Barrett's x * mu over x's 2m limbs."""
    spy = _Spy()
    monkeypatch.setitem(K._PRODUCTS, impl, spy)
    rnd = random.Random(m)
    mk = lambda n, w: bi.limbs_from_numpy(bi.batch_from_ints(
        [rnd.randrange(B ** w) for _ in range(n)], w), "cpu")
    u, v = mk(batch, m), mk(batch, m)
    S.divmod_batch(u, v, impl=impl)
    work = CM.divmod_work(m, batch, impl)
    assert [w[1] for w in work] == spy.calls
    assert {w[0] for w in work} == {CM.PRODUCT_KERNEL[impl]}
    assert len(work) == CM.divmod_launches(m, impl)
    fused = CM.divmod_work(m, batch)
    assert [w[0] for w in fused].count("correct") == 1
    assert sum(w[1] for w in fused) == sum(spy.calls)
    assert len(fused) == CM.divmod_launches(m)

    vm = bi.limbs_from_numpy(bi.from_int(rnd.randrange(2, B ** m), m),
                             "cpu")
    spy.calls.clear()
    ctx = MA.barrett_precompute(vm, impl=impl)
    assert [w[1] for w in CM.precompute_work(m, impl)] == spy.calls
    assert len(CM.precompute_work(m)) == CM.precompute_launches(m)
    for op, work, call in (
            ("reduce", CM.reduce_work, lambda: MA.reduce_shared(
                ctx, mk(batch, 2 * m), impl=impl)),
            ("modmul", CM.modmul_work, lambda: MA.modmul_shared(
                ctx, mk(batch, m), mk(batch, m), impl=impl))):
        spy.calls.clear()
        call()
        assert [w[1] for w in work(m, batch, impl)] == spy.calls, op
        assert len(work(m, batch)) == CM.model_launches(op, m)
    W = CM.barrett_width(m)
    assert CM.reduce_work(m, batch) == [
        ("barrett", batch * (2 * m * W + _direct(W, m, W)),
         4 * (batch * 2 * m + W + m + batch * W))]
    assert CM.divmod_work(m, batch, "blocked") == []


def test_work_widths_are_the_algorithms():
    for m in (4, 2048, 16384):
        assert CM.div_width(m) == m + S.PAD
        assert CM.barrett_width(m) == MA.barrett_width(m)
        assert MA.barrett_h(m) == 2 * m + MA.MU_GUARD


def test_roofline_terms():
    """Sums of the launches' terms, JAX's keys, no collective; the
    smoke's bound is the larger term of one launch."""
    work = CM.divmod_work(2048, 256)
    t = RL.roofline_terms(work)
    assert set(t) == {"compute_s", "memory_s", "collective_s",
                      "dot_flops", "bytes", "wire_bytes", "bottleneck"}
    assert t["collective_s"] == t["wire_bytes"] == 0
    ops = [RL.OPS_PER_LIMB_PRODUCT * w[1] / RL.PEAK_INT8_OPS for w in work]
    mem = [w[2] / RL.PEAK_BYTES for w in work]
    assert math.isclose(t["compute_s"], sum(ops), rel_tol=1e-12)
    assert math.isclose(t["memory_s"], sum(mem), rel_tol=1e-12)
    assert t["dot_flops"] == 8 * sum(w[1] for w in work)
    assert t["bottleneck"] == ("compute" if t["compute_s"] >= t["memory_s"]
                               else "memory")
    s, by = RL.bound(1000, 10 ** 9)
    assert by == "bytes" and s == 10 ** 9 / RL.PEAK_BYTES
    s, by = RL.bound(10 ** 12, 8)
    assert by == "operations" and s == 8 * 10 ** 12 / RL.PEAK_INT8_OPS
    assert RL.roofline_terms([])["bottleneck"] == "compute"
