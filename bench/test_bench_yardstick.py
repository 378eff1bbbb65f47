"""The frozen yardstick against the port: the copied cost model and
peaks agree with `repro_torch.obs` at the configurations' shapes (a
later change to the port shows here, not as a moved yardstick), and the
needed work per lane is a lower bound of the paper's own count."""

from __future__ import annotations

import random

import pytest

from bench.yardstick import costmodel as Y
from bench.yardstick import roofline as RL
from repro_torch.core import pyref as P
from repro_torch.obs import costmodel as CM
from repro_torch.obs import roofline as PRL

B = 1 << 16


def test_peaks_agree_with_the_port():
    assert (RL.PEAK_INT8_OPS, RL.PEAK_BYTES, RL.OPS_PER_LIMB_PRODUCT) == (
        PRL.PEAK_INT8_OPS, PRL.PEAK_BYTES, PRL.OPS_PER_LIMB_PRODUCT)
    assert RL.bound(10 ** 9, 10 ** 6) == PRL.bound(10 ** 9, 10 ** 6)
    assert RL.bound(1, 10 ** 9) == PRL.bound(1, 10 ** 9)


@pytest.mark.parametrize("m,batch", [(16384, 16384), (2048, 131072)])
def test_dense_forms_agree_with_the_port(m, batch):
    assert Y.divmod_work(m, batch) == CM.divmod_work(m, batch, "cuda_fused")
    assert Y.refine_iters(m) == CM.refine_iters(m)
    assert Y.div_width(m) == CM.div_width(m)
    for a, b, n in ((m, m, 2 * m), (m, 7, m), (3, m, 5), (m, m, 0)):
        assert Y.cut_products(a, b, n) == CM.cut_products(a, b, n)


@pytest.mark.parametrize("m,seed", [(64, 1), (128, 2)])
def test_division_work_is_a_lower_bound_of_the_papers_count(m, seed):
    rnd = random.Random(seed)
    for _ in range(25):
        u = rnd.randrange(B ** (m - 3), B ** (m - 2))
        kv = rnd.randint(2, m // 2)
        v = rnd.randrange(B ** (kv - 1), B ** kv)
        counter = P.CostCounter()
        P.divmod_shinv(u, v, B, counter)
        need = Y.divmod_lane_products(Y.prec(u), Y.prec(v))
        assert 0.9 * counter.digit_mults() <= need <= counter.digit_mults()
    assert Y.divmod_lane_products(0, 5) == 0
    assert Y.divmod_lane_products(9, 1) == 0
    assert Y.divmod_lane_products(9, 9) == 0


def test_division_work_counts_each_lane():
    lanes = [(62, 2), (62, 31), (62, 2), (62, 17)]
    products, nbytes = Y.divmod_needed(lanes, 64)
    assert products == sum(Y.divmod_lane_products(*x) for x in lanes) > 0
    assert nbytes == 4 * Y.LIMB_BYTES * 64 * 4
