"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked `cuda`: each test skips where there is no CUDA device
(the kernels have no CPU mode).  Run them on a machine with the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""

import random

import numpy as np
import pytest
import torch

from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import build, fused as F, ops as K
from repro_torch.obs import costmodel as CM

B = bi.BASE
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _t(xs, m, dev):
    return bi.limbs_from_numpy(bi.batch_from_ints(xs, m), dev)


@pytest.mark.parametrize("wu,wv,wo", [(130, 130, 63), (130, 130, 64),
                                      (130, 130, 65), (130, 130, 128),
                                      (130, 7, 300), (2056, 2056, 4112)])
def test_mul_kernel_matches_plain(dev, wu, wv, wo):
    rnd = random.Random(wo)
    xs = [rnd.randint(0, B ** wu - 1) for _ in range(3)] + [B ** wu - 1, 0]
    ys = [rnd.randint(0, B ** wv - 1) for _ in range(3)] + [B ** wv - 1, 5]
    u, v = _t(xs, wu, dev), _t(ys, wv, dev)
    got = K.mul_batch(u, v, wo)
    torch.cuda.synchronize()
    assert torch.equal(got, K.mul_plain(u, v, wo))
    for x, y, row in zip(xs, ys, bi.limbs_to_numpy(got)):
        assert bi.to_int(row) == (x * y) % B ** wo


def _states(full_w, win, batch, seed, dev):
    """Synthetic Refine states (tests/test_fused.py:114-142 at any
    window): random iterates and scalars, inactive lanes, 0 and
    all-0xFFFF lanes."""
    rnd = random.Random(seed)
    vs = [B ** full_w - 1, 0] + [rnd.randint(0, B ** full_w - 1)
                                 for _ in range(batch - 2)]
    ws = [B ** win - 1, 0] + [rnd.randint(0, B ** win - 1)
                              for _ in range(batch - 2)]
    col = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    return dict(
        v=_t(vs, full_w, dev), w=_t(ws, full_w, dev),
        l=col([rnd.randint(2, 5) for _ in range(batch)]),
        m=col([rnd.randint(0, 3) for _ in range(batch)]),
        h=col([rnd.randint(1, 2 * win - 1) for _ in range(batch)]),
        s=col([rnd.randint(0, 2) for _ in range(batch)]),
        active=torch.tensor([i % 3 != 0 for i in range(batch)], device=dev))


@pytest.mark.parametrize("full_w,win", [(16, 8), (16, 16), (40, 32),
                                        (600, 528)])
def test_step_kernels_match_plain(dev, full_w, win):
    st = _states(full_w, win, 12, win, dev)
    hpd, lpd = st["h"] - st["m"], st["l"] - 2
    sk, xk = F.powdiff_cuda(st["v"], st["w"], hpd, lpd, st["s"], win=win)
    sp, xp = F.powdiff_reference(st["v"], st["w"], hpd, lpd, st["s"], win=win)
    torch.cuda.synchronize()
    assert torch.equal(sk, sp) and torch.equal(xk, xp)
    args = (st["w"], xp, sp, st["h"], st["m"], st["active"])
    got = F.update_cuda(*args, win=win)
    torch.cuda.synchronize()
    assert torch.equal(got, F.update_reference(*args, win=win))
    kw = dict(h=st["h"], m=st["m"], l=st["l"], s=st["s"],
              active=st["active"], g=2, win=win)
    got = F.step_cuda(st["v"], st["w"], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, F.step_reference(st["v"], st["w"], **kw))


def _step_lanes(batch, full_w, win, seed, dev):
    """numpy-seeded Refine states of `batch` lanes: lane 0 all-0xFFFF,
    lane 1 with v = 0, lane 2 with a one-limb w, the rest random; by
    lane i % 3 the close branch (v shifted by win / 2, a short w,
    h = 2 win - 1), the full branch with p > B^(h-m) (h = win) and with
    p <= B^(h-m) (h = 2 win + m); every fourth lane inactive."""
    rng = np.random.default_rng(seed)
    i = np.arange(batch)
    kind, ms = i % 3, (i // 3) % 3
    v = rng.integers(0, B, (batch, full_w), dtype=np.uint32)
    w = rng.integers(0, B, (batch, full_w), dtype=np.uint32)
    w[:, win:] = 0
    w[kind == 0, max(1, win // 4):] = 0
    v[0], w[0, :win] = B - 1, B - 1
    if batch > 2:
        v[1] = 0
        w[2, 1:] = 0
    ls = np.where(kind == 2, 2, 2 + i % 4)
    hs = np.where(kind == 0, 2 * win - 1,
                  np.where(kind == 1, win, 2 * win + ms))
    col = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    h, m, l = col(hs), col(ms), col(ls)
    return dict(v=bi.limbs_from_numpy(v, dev), w=bi.limbs_from_numpy(w, dev),
                h=h, m=m, l=l, hpd=h - m, lpd=l - 2,
                s=col(np.where(kind == 0, win // 2, kind)),
                active=torch.tensor(i % 4 != 3, device=dev))


def _check_step(st, win):
    """powdiff and update against their plain versions on the same
    inputs; the clusters each launch used."""
    from repro_torch.kernels import digitmma as D
    pd = (st["v"], st["w"], st["hpd"], st["lpd"], st["s"])
    sk, xk = F.powdiff_cuda(*pd, win=win)
    torch.cuda.synchronize()
    sp, xp = F.powdiff_reference(*pd, win=win)
    assert torch.equal(sk, sp) and torch.equal(xk, xp)
    args = (st["w"], xk, sk, st["h"], st["m"], st["active"])
    got = F.update_cuda(*args, win=win)
    torch.cuda.synchronize()
    assert torch.equal(got, F.update_reference(*args, win=win))
    return D.last_cluster["powdiff"], D.last_cluster["update"]


@pytest.mark.parametrize("batch", [1, 5, 16, 64, 131, 132, 133, 256])
def test_step_kernels_every_cluster_size(dev, batch):
    from repro_torch.kernels import digitmma as D
    want = D.cluster_size(batch, D.device_sms(dev))
    for full_w, win in ((40, 32), (600, 528)):
        st = _step_lanes(batch, full_w, win, batch + win, dev)
        assert _check_step(st, win) == (want, want)


@pytest.mark.parametrize("win", [32, 528, 2056, 16392, 32778])
def test_step_kernels_wide_windows(dev, win):
    """One lane (cluster 8) at the windows of the division and
    precompute schedules, up to a 2^18-bit modulus's W = 32778: the
    all-0xFFFF lane, the close branch and the full branch with each
    sign."""
    from repro_torch.kernels import digitmma as D
    want = D.cluster_size(1, D.device_sms(dev))
    st = _step_lanes(6, win + 8, win, win, dev)
    for lane in (0, 3, 4, 5):
        one = {k: t[lane:lane + 1].contiguous() for k, t in st.items()}
        one["active"][:] = True
        assert _check_step(one, win) == (want, want)


@pytest.mark.parametrize("w", [12, 40])
def test_correct_kernel_matches_plain(dev, w):
    rnd = random.Random(w)
    us = [rnd.randint(0, B ** w - 1) for _ in range(6)] + [B ** w - 1, 9]
    vs = [rnd.randint(0, B ** (w // 2)) for _ in range(6)] + [1, 0]
    sis = [rnd.randint(0, B ** w - 1) for _ in range(8)]
    u, v, si = _t(us, w, dev), _t(vs, w, dev), _t(sis, w, dev)
    h = torch.tensor([rnd.randint(0, 2 * w) for _ in range(8)],
                     dtype=torch.int32, device=dev)
    qk, rk = F.correct_cuda(u, v, si, h=h)
    qp, rp = F.correct_reference(u, v, si, h=h)
    torch.cuda.synchronize()
    assert torch.equal(qk, qp) and torch.equal(rk, rp)


def _correct_operands(batch, m, seed, dev):
    """Finalization operands at W = m + PAD, as divmod_batch hands them
    over: u and v of m limbs (lane 0 all-0xFFFF, lane 1 v = 0, lane 2 a
    one-limb v, lane 3 u < v, lane 4 u = 0; the rest u = k v or k v - 1
    for a v of random length), h = prec(u) and si = floor(B^h / v) +
    lambda with lambda = -1, 0, +1 by lane, so that both corrections
    run.  Returns the tensors, the ints and each lane's lambda."""
    rnd = random.Random(seed)
    W = m + S.PAD
    us, vs, lams = [], [], []
    for i in range(batch):
        v = rnd.getrandbits(16 * rnd.randint(1, m)) | 1
        k = max(1, (B ** m - 1) // v - rnd.randint(0, 3))
        us.append(k * v - (i // 3) % 2)
        vs.append(v)
        lams.append(i % 3 - 1)
    edges = [(B ** m - 1, B ** (m // 2) - 1), (rnd.getrandbits(16 * m), 0),
             (rnd.getrandbits(16 * m), 0xFFFF), (12345, B ** m - 1),
             (0, rnd.getrandbits(16 * m) | 1)]
    for i, (uu, vv) in enumerate(edges[:batch]):
        us[i], vs[i] = uu, vv
    hs = [-(-x.bit_length() // 16) for x in us]
    sis = [max(0, B ** h // y + lam) if y else rnd.getrandbits(16 * W)
           for h, y, lam in zip(hs, vs, lams)]
    t = dict(u=_t(us, W, dev), v=_t(vs, W, dev), si=_t(sis, W, dev),
             h=torch.tensor(hs, dtype=torch.int32, device=dev))
    return t, us, vs, lams


def _check_correct(t, us, vs, lams):
    """correct_cuda against correct_reference bit for bit, and against
    Python divmod on every lane whose si is a valid shifted inverse
    (lambda 0 or 1; u < B^m keeps v * (q + 1) inside W limbs)."""
    qk, rk = F.correct_cuda(t["u"], t["v"], t["si"], h=t["h"])
    torch.cuda.synchronize()
    qp, rp = F.correct_reference(t["u"], t["v"], t["si"], h=t["h"])
    assert torch.equal(qk, qp) and torch.equal(rk, rp)
    for x, y, lam, qq, rr in zip(us, vs, lams, bi.batch_to_ints(qk),
                                 bi.batch_to_ints(rk)):
        if lam >= 0 or y == 0:
            assert (qq, rr) == (divmod(x, y) if y else (0, x))


@pytest.mark.parametrize("batch", [1, 16, 32, 64, 100, 132, 256])
def test_correct_kernel_every_cluster_size(dev, batch):
    """The finalization kernel at clusters of 8, 8, 8, 4, 2, 1 and 1
    blocks (132 SMs), at the 2^15-bit divmod's W = 2056 and at W = 528."""
    from repro_torch.kernels import digitmma as D
    for m in (520, 2048):
        _check_correct(*_correct_operands(batch, m, batch + m, dev))
        assert D.last_cluster["correct"] == D.cluster_size(
            batch, D.device_sms(dev))


def test_correct_kernel_2p18(dev):
    """W = 16392 (2^18 bits x 32 lanes, cluster 8 on 132 SMs), si around
    the true shifted inverse: lambda -1, 0, +1."""
    from repro_torch.kernels import digitmma as D
    _check_correct(*_correct_operands(32, 16384, 18, dev))
    assert D.last_cluster["correct"] == D.cluster_size(32, D.device_sms(dev))


def test_divmod_past_the_old_finalization_cap(dev):
    """A 30,000-limb division under cuda_fused, past the ~29,000 limbs
    the CUDA-core finalization staged: exact against Python, with
    costmodel.divmod_launches(30000) launches."""
    m = 30000
    rnd = random.Random(m)
    us = [B ** m - 1, rnd.getrandbits(16 * m), rnd.getrandbits(16 * m)]
    vs = [B ** (m // 2) - 1, rnd.getrandbits(16 * 5) | 1,
          rnd.getrandbits(16 * (m - 1000)) | 1]
    build.build_all()
    build.reset_launch_counts()
    q, r = S.divmod_batch(_t(us, m, dev), _t(vs, m, dev))
    torch.cuda.synchronize()
    it = CM.refine_iters(m)
    assert build.launch_counts() == {"powdiff": it, "update": it,
                                     "correct": 1}
    assert sum(build.launch_counts().values()) == CM.divmod_launches(m)
    for x, y, qq, rr in zip(us, vs, bi.batch_to_ints(q),
                            bi.batch_to_ints(r)):
        assert (qq, rr) == divmod(x, y)


def test_divmod_width_cap(dev):
    """The cuda_fused divmod cap the libraries set (the finalization
    kernel's staging): 38,440 limbs run exact, 38,441 raise ValueError
    in divmod_batch and in the division service's constructor before any
    launch; cuda_batched and cuda_pairs take that width, and past the
    column-sum contract cuda_fused and cuda_batched raise."""
    from repro_torch.serving.bigint_service import BigintDivisionService
    cap = 38440
    rnd = random.Random(cap)
    us = [rnd.getrandbits(16 * cap), B ** cap - 1]
    vs = [rnd.getrandbits(16 * 3) | 1, 0]
    build.build_all()
    build.reset_launch_counts()
    q, r = S.divmod_batch(_t(us, cap, dev), _t(vs, cap, dev))
    torch.cuda.synchronize()
    assert sum(build.launch_counts().values()) == CM.divmod_launches(cap)
    assert list(zip(bi.batch_to_ints(q), bi.batch_to_ints(r))) == [
        divmod(us[0], vs[0]), (0, us[1])]
    build.reset_launch_counts()
    wide = torch.ones(2, cap + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        S.divmod_batch(wide, wide)
    with pytest.raises(ValueError, match="shared memory"):
        BigintDivisionService(m_limbs=cap + 1, batch_buckets=(2,),
                              device=dev)
    for impl in ("cuda_batched", "cuda_pairs"):
        S.check_width(dev, cap + 1, impl)
        BigintDivisionService(m_limbs=cap + 1, batch_buckets=(2,),
                              device=dev, impl=impl)
    for impl in ("cuda_fused", "cuda_batched"):
        with pytest.raises(ValueError, match="column-sum contract"):
            S.check_width(dev, 65536, impl)
    assert build.launch_counts() == {}


@pytest.mark.parametrize("m", [4, 26, 130])
def test_divmod_on_card_exact_with_launch_count(dev, m):
    rnd = random.Random(m)
    us = [rnd.randint(0, B ** m - 1) for _ in range(16)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(16)]
    us[0], vs[0] = B ** m - 1, B ** (m // 2) - 1
    vs[1], vs[2], vs[3] = B ** (m // 2), 0, 7
    build.build_all()
    build.reset_launch_counts()
    q, r = S.divmod_batch(_t(us, m, dev), _t(vs, m, dev))
    torch.cuda.synchronize()
    counts = build.launch_counts()
    assert counts == {"powdiff": CM.refine_iters(m),
                      "update": CM.refine_iters(m), "correct": 1}
    assert sum(counts.values()) == CM.divmod_launches(m)
    for x, y, qq, rr in zip(us, vs, bi.batch_to_ints(q),
                            bi.batch_to_ints(r)):
        assert (qq, rr) == (divmod(x, y) if y else (0, x))
    np.testing.assert_array_equal(
        bi.limbs_to_numpy(q),
        bi.limbs_to_numpy(S.divmod_batch(_t(us, m, "cpu"),
                                         _t(vs, m, "cpu"))[0]))


def _barrett_lanes(m, dev):
    """Barrett core operands at W = barrett_width(m): a valid mu
    (shinv_h(v) + lambda) with x built to take `over` (lambda = 1,
    x = k v - 1 near B^(2m)) and `under` (lambda = 0, x = k v), edge
    moduli (1, B^k, all-0xFFFF, one limb) and one arbitrary mu."""
    from repro_torch.core import modarith as MA
    rnd = random.Random(m)
    W, h = MA.barrett_width(m), MA.barrett_h(m)
    vs = [rnd.randint(B ** (m - 1), B ** m - 1) for _ in range(4)] + [
        1, B ** (m - 1), B ** m - 1, 0xFFFF, rnd.randint(1, B ** m - 1)]
    ks = [(B ** (2 * m) - 1) // v for v in vs]
    xs = [ks[0] * vs[0] - 1, ks[1] * vs[1], ks[2] * vs[2] - 1, ks[3] * vs[3],
          B ** (2 * m) - 1, rnd.randint(0, B ** (2 * m) - 1), 5,
          0xFFFF * rnd.randint(1, B ** m), rnd.randint(0, B ** (2 * m) - 1)]
    lams = [1, 0, 1, 0, 0, 1, 0, 0, 1]
    mus = [B ** h // v + lam for v, lam in zip(vs, lams)]
    mus[-1] = rnd.randint(0, B ** W - 1)
    return (_t(xs, 2 * m, dev), _t(mus, W, dev), _t(vs, m, dev), h,
            (xs, vs))


@pytest.mark.parametrize("m", [4, 2048, 8192])
def test_barrett_kernel_matches_plain(dev, m):
    x, mu, v, h, (xs, vs) = _barrett_lanes(m, dev)
    got = F.barrett_cuda(x, mu, v, h=h)
    torch.cuda.synchronize()
    r, over, under = F.barrett_branches(x, mu, v, h=h)
    assert torch.equal(got, r)
    assert over[:-1].any() and under[:-1].any()
    for i, row in enumerate(bi.batch_to_ints(got[:-1])):
        assert row == xs[i] % vs[i]
    # a shared context: one mu and v read by every lane (row stride 0)
    got = F.barrett_cuda(x, mu[0], v[0], h=h)
    torch.cuda.synchronize()
    assert torch.equal(got, F.barrett_reference(x, mu[0], v[0], h=h))
    assert bi.batch_to_ints(got) == [xx % vs[0] for xx in xs]


@pytest.mark.parametrize("m", [4, 26, 130])
def test_modarith_on_card_exact_with_launch_counts(dev, m):
    from repro_torch.core import modarith as MA
    rnd = random.Random(m)
    v = rnd.randint(B ** (m - 1), B ** m - 1)
    xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(8)]
    a = [x % B ** m for x in xs]
    es = [rnd.randint(0, B - 1) for _ in range(8)]
    build.build_all()
    build.reset_launch_counts()
    ctx = MA.barrett_precompute(_t([v], m, dev)[0])
    torch.cuda.synchronize()
    assert sum(build.launch_counts().values()) == CM.precompute_launches(m)
    build.reset_launch_counts()
    assert bi.batch_to_ints(MA.reduce_shared(ctx, _t(xs, 2 * m, dev))) == \
        [x % v for x in xs]
    assert build.launch_counts() == {"barrett": 1}
    build.reset_launch_counts()
    got = MA.modexp_shared(ctx, _t(a, m, dev), _t(es, 1, dev))
    assert bi.batch_to_ints(got) == [pow(x, y, v) for x, y in zip(a, es)]
    counts = build.launch_counts()
    lad = CM.modexp_ladder(16)
    assert counts == {"barrett": lad["reductions"],
                      "mul_batch": lad["modmuls"]}
    assert sum(counts.values()) == CM.modexp_launches(16)
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(8)]
    per_lane = MA.modmul_batch(_t(a, m, dev), _t(a[::-1], m, dev),
                               _t(vs, m, dev))
    assert bi.batch_to_ints(per_lane) == [
        x * y % z for x, y, z in zip(a, a[::-1], vs)]


def test_modulus_past_shared_memory_raises(dev):
    """A 2^18-bit modulus (W = 32778) now fits the step, Barrett and
    product kernels' staging: under cuda_fused and cuda_batched it
    precomputes with `costmodel.precompute_launches(16384, impl)`
    launches and reduces exactly.  A modulus past the new cap (the
    Barrett kernel's x, mu and v at 24000 limbs) raises before any
    launch, as one past the column-sum contract does under both."""
    from repro_torch.core import modarith as MA
    m = 16384
    rnd = random.Random(18)
    mod = rnd.randint(B ** (m - 1), B ** m - 1)
    xs = [B ** (2 * m) - 1, rnd.randint(0, B ** (2 * m) - 1), mod * 3, 5]
    build.build_all()
    for impl, name in (("cuda_fused", None), ("cuda_batched", "mul_batch")):
        build.reset_launch_counts()
        ctx = MA.barrett_precompute(_t([mod], m, dev)[0], impl)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert sum(counts.values()) == CM.precompute_launches(m, impl)
        if name:
            assert counts == {name: CM.precompute_launches(m, impl)}
        else:
            assert counts == {"powdiff": CM.precompute_launches(m) // 2,
                              "update": CM.precompute_launches(m) // 2}
        mu = bi.to_int(bi.limbs_to_numpy(ctx.mu))
        assert mu - B ** MA.barrett_h(m) // mod in (0, 1)
        got = MA.reduce_shared(ctx, _t(xs, 2 * m, dev), impl)
        assert bi.batch_to_ints(got) == [x % mod for x in xs]
    build.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        MA.barrett_precompute(torch.ones(24000, dtype=torch.int32,
                                         device=dev))
    for impl in ("cuda_fused", "cuda_batched"):
        with pytest.raises(ValueError, match="column-sum contract"):
            MA.barrett_precompute(torch.ones(32768, dtype=torch.int32,
                                             device=dev), impl)
    assert build.launch_counts() == {}


# shapes of the pair kernel: ragged tiles, one operand shorter than a
# tile, a pruned product, and the 2^15-bit divmod's q*v (2048 limbs)
@pytest.mark.parametrize("wu,wv,wo", [(130, 130, 63), (130, 130, 128),
                                      (130, 130, 129), (300, 7, 400),
                                      (257, 385, 642), (2048, 2048, 2048)])
def test_pairs_kernel_matches_plain(dev, wu, wv, wo):
    from repro_torch.kernels import bigmul
    rnd = random.Random(wu + wv + wo)
    xs = [rnd.randint(0, B ** wu - 1) for _ in range(3)] + [B ** wu - 1, 0]
    ys = [rnd.randint(0, B ** wv - 1) for _ in range(3)] + [B ** wv - 1, 5]
    u, v = _t(xs, wu, dev), _t(ys, wv, dev)
    build.build_all()
    build.reset_launch_counts()
    got = bigmul.mul_pairs(u, v, wo)
    torch.cuda.synchronize()
    assert build.launch_counts() == {"mul_pairs": 1}
    assert torch.equal(got, bigmul.mul_pairs_reference(u, v, wo))
    assert torch.equal(got, K.mul_plain(u, v, wo))
    for x, y, row in zip(xs, ys, bi.batch_to_ints(got)):
        assert row == (x * y) % B ** wo
    emulated, _, _ = bigmul.pairs_schedule_plain(u.cpu(), v.cpu(), wo, wo)
    assert torch.equal(got.cpu(), emulated)


@pytest.mark.parametrize("l_max", [1, 63, 64, 65, 127, 128, 129, 255, 256,
                                   257, 300])
def test_mulmod_pairs_kernel_matches_plain(dev, l_max):
    from repro_torch.kernels import bigmul
    rnd = random.Random(l_max)
    wu, wv = 3 * 128 + 5, 2 * 128 + 3
    xs = [rnd.randint(0, B ** wu - 1) for _ in range(3)] + [B ** wu - 1]
    ys = [rnd.randint(0, B ** wv - 1) for _ in range(3)] + [B ** wv - 1]
    u, v = _t(xs, wu, dev), _t(ys, wv, dev)
    got = bigmul.mulmod_pairs(u, v, l_max, wu + 2)
    torch.cuda.synchronize()
    assert torch.equal(got, bigmul.mulmod_pairs_reference(u, v, l_max,
                                                          wu + 2))
    assert bi.batch_to_ints(got) == [(x * y) % B ** l_max
                                     for x, y in zip(xs, ys)]


def _pairs_once(u, v, l_max, out_width):
    """mulmod_pairs on the card, one launch, equal to its plain version."""
    from repro_torch.kernels import bigmul
    # the CPU emulation's column tile is the kernel's
    assert build.lib("pairs").mul_pairs_tile() == bigmul.PAIRS_TC
    build.reset_launch_counts()
    got = bigmul.mulmod_pairs(u, v, l_max, out_width)
    torch.cuda.synchronize()
    assert build.launch_counts() == {"mul_pairs": 1}
    assert torch.equal(got, bigmul.mulmod_pairs_reference(u, v, l_max,
                                                          out_width))
    return got


@pytest.mark.parametrize("l_max", [1023, 1024, 1025, 2047, 2048, 2049,
                                   3200])
def test_pairs_kernel_carry_chain(dev, l_max):
    """The in-launch carry at the kernel's 1,024-limb column tiles: lanes
    just below and just above a tile's carry threshold, all-0xFFFF lanes
    (every tile waits for its predecessor), random lanes; l_max at and
    around the tile edges."""
    from repro_torch.kernels import bigmul
    us, vs = bigmul.threshold_lanes(bigmul.PAIRS_TC, 1, 3200, 300, l_max)
    wu = max(-(-x.bit_length() // 16) for x in us)
    rnd = random.Random(l_max)
    us += [B ** wu - 1, rnd.getrandbits(16 * wu)]
    vs += [B ** 300 - 1, rnd.getrandbits(16 * 300)]
    got = _pairs_once(_t(us, wu, dev), _t(vs, 300, dev), l_max, 3300)
    assert bi.batch_to_ints(got) == [x * y % B ** l_max
                                     for x, y in zip(us, vs)]
    x = B ** 3072 - 1
    got = _pairs_once(_t([x], 3072, dev), _t([x], 3072, dev), l_max, 3072)
    assert bi.batch_to_ints(got) == [x * x % B ** min(l_max, 3072)]


@pytest.mark.parametrize("batch", [1, 256])
def test_pairs_kernel_batches(dev, batch):
    """The 2^15-bit divmod's q*v at batch 1 and 256 (lane 0 all-0xFFFF)."""
    rng = np.random.default_rng(batch)
    a = rng.integers(0, B, (2, batch, 2048), dtype=np.uint32)
    a[:, 0] = B - 1
    u, v = bi.limbs_from_numpy(a[0], dev), bi.limbs_from_numpy(a[1], dev)
    got = _pairs_once(u, v, 2048, 2048)
    assert bi.batch_to_ints(got[:2]) == [
        x * y % B ** 2048 for x, y in zip(bi.batch_to_ints(u[:2]),
                                         bi.batch_to_ints(v[:2]))]


def test_pairs_kernel_2p16_limbs(dev):
    """2^16 x 2^16 limbs -> 2^17, the column-sum contract's width, in one
    launch: the kernel stages fixed-size tiles, so no width cap came back."""
    from repro_torch.kernels import bigmul
    w = bigmul.PAIRS_MAX_LIMBS
    rnd = random.Random(16)
    xs, ys = [rnd.getrandbits(16 * w), B ** w - 1], [B ** w - 1] * 2
    build.build_all()
    build.reset_launch_counts()
    got = bigmul.mul_pairs(_t(xs, w, dev), _t(ys, w, dev), 2 * w)
    torch.cuda.synchronize()
    assert build.launch_counts() == {"mul_pairs": 1}
    assert bi.batch_to_ints(got) == [x * y for x, y in zip(xs, ys)]


@pytest.mark.parametrize("impl", ["cuda_batched", "cuda_pairs", "blocked"])
def test_impls_on_card_exact_with_launch_counts(dev, impl):
    """divmod, precompute, reduce and a short modexp under each unfused
    impl: the same bits as cuda_fused, and the launches the cost model
    counts for the impl."""
    from repro_torch.core import modarith as MA
    name = {"cuda_batched": "mul_batch", "cuda_pairs": "mul_pairs",
            "blocked": None}[impl]
    m = 130
    rnd = random.Random(m)
    us = [rnd.randint(0, B ** m - 1) for _ in range(8)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(8)]
    vs[1] = 0
    u, v = _t(us, m, dev), _t(vs, m, dev)
    build.build_all()

    def counted(fn, op, **kw):
        build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        want = CM.model_launches(op, m, impl, **kw)
        assert build.launch_counts() == ({name: want} if want else {})
        return out

    q, r = counted(lambda: S.divmod_batch(u, v, impl=impl), "divmod")
    q0, r0 = S.divmod_batch(u, v)
    assert torch.equal(q, q0) and torch.equal(r, r0)
    mod = rnd.randint(B ** (m - 1), B ** m - 1)
    ctx = counted(lambda: MA.barrett_precompute(_t([mod], m, dev)[0], impl),
                  "precompute")
    assert torch.equal(ctx.mu, MA.barrett_precompute(_t([mod], m, dev)[0]).mu)
    xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(4)]
    got = counted(lambda: MA.reduce_shared(ctx, _t(xs, 2 * m, dev), impl),
                  "reduce")
    assert bi.batch_to_ints(got) == [x % mod for x in xs]
    a = [x % B ** m for x in xs]
    got = counted(lambda: MA.modexp_shared(ctx, _t(a, m, dev),
                                           _t([3, 0, 1, 65535], 1, dev),
                                           impl=impl), "modexp", e_bits=16)
    assert bi.batch_to_ints(got) == [pow(x, y, mod) for x, y in
                                     zip(a, [3, 0, 1, 65535])]


def test_2p18_modulus_runs_under_cuda_pairs(dev):
    """A 2^18-bit modulus under cuda_pairs, whose kernel stages two tiles
    whatever the width: the precompute and a reduction exact, with only
    mul_pairs launched."""
    from repro_torch.core import modarith as MA
    m = 16384
    rnd = random.Random(18)
    mod = rnd.randint(B ** (m - 1), B ** m - 1)
    build.build_all()
    build.reset_launch_counts()
    ctx = MA.barrett_precompute(_t([mod], m, dev)[0], "cuda_pairs")
    xs = [B ** (2 * m) - 1, rnd.randint(0, B ** (2 * m) - 1)]
    got = MA.reduce_shared(ctx, _t(xs, 2 * m, dev), "cuda_pairs")
    torch.cuda.synchronize()
    assert bi.batch_to_ints(got) == [x % mod for x in xs]
    assert build.launch_counts() == {
        "mul_pairs": CM.precompute_launches(m, "cuda_pairs")
        + CM.barrett_launches("cuda_pairs")}


# -- the digit-GEMM kernels (csrc/digitmma.cuh): every cluster size --------

def _lanes(batch, w, seed, dev):
    """numpy-seeded (batch, w) limbs on the card: lane 0 all-0xFFFF,
    lane 1 zero, lane 2 = 1, the rest random."""
    a = np.random.default_rng(seed).integers(0, B, (batch, w),
                                             dtype=np.uint32)
    a[0] = B - 1
    if batch > 2:
        a[1] = 0
        a[2] = 0
        a[2, 0] = 1
    return bi.limbs_from_numpy(a, dev)


@pytest.mark.parametrize("batch", [1, 5, 16, 64, 131, 132, 133, 256])
def test_mul_kernel_every_cluster_size(dev, batch):
    from repro_torch.kernels import bigmul, digitmma as D
    for wu, wv, wo in ((300, 300, 600), (700, 129, 700), (2048, 2048, 2048)):
        u, v = _lanes(batch, wu, wu + batch, dev), _lanes(batch, wv, wv, dev)
        got = bigmul.mul_batch_cuda(u, v, wo)
        torch.cuda.synchronize()
        assert D.last_cluster["mul_batch"] == D.cluster_size(
            batch, D.device_sms(u.device))
        assert torch.equal(got, K.mul_plain(u, v, wo))
    for x, y, z in zip(*(bi.batch_to_ints(t[:3]) for t in (u, v, got))):
        assert z == x * y % B ** wo


@pytest.mark.parametrize("bits,batch", [(2 ** 15, 256), (2 ** 16, 128),
                                        (2 ** 17, 64), (2 ** 18, 32)])
def test_mul_kernel_paper_shapes(dev, bits, batch):
    """q*v of each division cell (m x m -> m) and modmul's full a*b
    (m x m -> 2m) at each modulus size."""
    from repro_torch.kernels import bigmul
    m = bits // 16
    u, v = _lanes(batch, m, bits, dev), _lanes(batch, m, bits + 1, dev)
    shapes = (m,) if bits == 2 ** 18 else (m, 2 * m)
    for wo in shapes:
        got = bigmul.mul_batch_cuda(u, v, wo)
        torch.cuda.synchronize()
        assert torch.equal(got, K.mul_plain(u, v, wo))
        for x, y, z in zip(*(bi.batch_to_ints(t[:3]) for t in (u, v, got))):
            assert z == x * y % B ** wo


@pytest.mark.parametrize("m,batch", [(2048, 256), (4096, 128), (8192, 64),
                                     (2048, 16), (8192, 5)])
def test_barrett_kernel_every_cluster_size(dev, m, batch):
    """The adversarial lanes of _barrett_lanes tiled to `batch` lanes
    (clusters of 1, 2, 4, 8 and 8), per-lane and shared contexts, each
    correction branch taken."""
    from repro_torch.kernels import digitmma as D
    x, mu, v, h, (xs, vs) = _barrett_lanes(m, dev)
    reps = -(-batch // x.shape[0])
    x, mu, v = (t.repeat(reps, 1)[:batch].contiguous() for t in (x, mu, v))
    got = F.barrett_cuda(x, mu, v, h=h)
    torch.cuda.synchronize()
    assert D.last_cluster["barrett"] == D.cluster_size(
        batch, D.device_sms(x.device))
    r, over, under = F.barrett_branches(x, mu, v, h=h)
    assert torch.equal(got, r)
    if batch >= 9:
        assert over.any() and under.any()
    n = len(xs)
    for i, row in enumerate(bi.batch_to_ints(got)):
        if i % n != n - 1:                  # the last lane's mu is arbitrary
            assert row == xs[i % n] % vs[i % n]
    got = F.barrett_cuda(x, mu[0], v[0], h=h)
    torch.cuda.synchronize()
    assert torch.equal(got, F.barrett_reference(x, mu[0], v[0], h=h))
    assert bi.batch_to_ints(got) == [xs[i % n] % vs[0] for i in range(batch)]


def test_barrett_kernel_2p18_modulus(dev):
    """W = 32778 (a 2^18-bit modulus) fits the kernel's staging; mu from
    the host, with lambda 0 and 1."""
    from repro_torch.core import modarith as MA
    m = 16384
    rnd = random.Random(18)
    W, h = MA.barrett_width(m), MA.barrett_h(m)
    vs = [rnd.randint(B ** (m - 1), B ** m - 1), B ** m - 1]
    mus = [B ** h // y for y in vs]
    xs = [(B ** (2 * m) - 1) // vs[0] * vs[0] - 1, B ** (2 * m) - 1,
          rnd.randint(0, B ** (2 * m) - 1), vs[1] - 1]
    lane = [0, 1, 0, 1]
    x = _t(xs, 2 * m, dev)
    mu = _t([mus[j] + (i % 2) for i, j in enumerate(lane)], W, dev)
    v = _t([vs[j] for j in lane], m, dev)
    got = F.barrett_cuda(x, mu, v, h=h)
    torch.cuda.synchronize()
    assert torch.equal(got, F.barrett_reference(x, mu, v, h=h))
    assert bi.batch_to_ints(got) == [xx % vs[j] for xx, j in zip(xs, lane)]


def test_staging_fits_the_paper_range(dev):
    """Two bytes per limb: the Barrett kernel stages a 2^18-bit modulus's
    x, mu and v, the product kernel modmul's a * b and the step kernels
    the precompute's full window W = 32778."""
    from repro_torch.kernels import digitmma as D
    from repro_torch.core import modarith as MA
    libs = build.build_all()
    mul = libs["mul"].mul_batch_smem_bytes
    bar = libs["barrett"].barrett_smem_bytes
    for m in (2048, 4096, 8192, 16384):
        w = MA.barrett_width(m)
        assert bar(2 * m, m, w) <= D.DYNAMIC_SMEM_BYTES
        assert mul(m, m, 2 * m) <= D.DYNAMIC_SMEM_BYTES
    assert mul(2 * 16394, 16394, 2 * 16394) <= D.DYNAMIC_SMEM_BYTES
    step = libs["step"].step_smem_bytes
    for m in (2048, 4096, 8192, 16384):
        assert step(MA.barrett_width(m)) <= D.DYNAMIC_SMEM_BYTES


@pytest.mark.parametrize("m", [2048, 8192])
def test_modarith_paper_moduli_launch_counts(dev, m):
    """reduce 1, modmul 2 and a 16-bit-exponent modexp's launches at a
    2^15- and a 2^17-bit modulus, every lane exact."""
    from repro_torch.core import modarith as MA
    rnd = random.Random(m)
    v = rnd.randint(B ** (m - 1), B ** m - 1)
    xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(4)]
    a = [x % B ** m for x in xs]
    build.build_all()
    ctx = MA.barrett_precompute(_t([v], m, dev)[0])
    for fn, want, expect in (
            (lambda: MA.reduce_shared(ctx, _t(xs, 2 * m, dev)),
             {"barrett": 1}, [x % v for x in xs]),
            (lambda: MA.modmul_shared(ctx, _t(a, m, dev), _t(a[::-1], m, dev)),
             {"barrett": 1, "mul_batch": 1},
             [x * y % v for x, y in zip(a, a[::-1])])):
        build.reset_launch_counts()
        got = fn()
        torch.cuda.synchronize()
        assert build.launch_counts() == want
        assert bi.batch_to_ints(got) == expect
    build.reset_launch_counts()
    es = [0, 1, 65535, 12345]
    got = MA.modexp_shared(ctx, _t(a, m, dev), _t(es, 1, dev))
    lad = CM.modexp_ladder(16)
    assert build.launch_counts() == {"barrett": lad["reductions"],
                                     "mul_batch": lad["modmuls"]}
    assert bi.batch_to_ints(got) == [pow(x, y, v) for x, y in zip(a, es)]


# ---------------------------------------------------------------------------
# bucket executables: one CUDA graph per (op, bucket, impl)
# ---------------------------------------------------------------------------

def _graph(fn, fill, impl):
    from repro_torch.serving import batching as BT
    return BT.Executable(fn, fill, BT.kernel_plan(impl))


def _replayed(exe, args, n=3):
    """n replays of exe on args: the last outputs and the launches the
    replays counted."""
    build.reset_launch_counts()
    for _ in range(n):
        out = exe(*args)
    torch.cuda.synchronize()
    return out, build.launch_counts()


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_batched",
                                  "cuda_pairs"])
@pytest.mark.parametrize("m", [4, 2048])
def test_divmod_graph_replay_equals_eager_and_plain(dev, m, impl):
    """A divmod graph captured on the padding fill: 3 replays count 3x
    the cost model's launches, and the replay equals the eager call,
    the plain versions (impl blocked) and Python divmod."""
    from functools import partial
    rnd = random.Random(m)
    us = [rnd.randint(0, B ** m - 1) for _ in range(8)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(8)]
    vs[1] = 0
    u, v = _t(us, m, dev), _t(vs, m, dev)
    fu = torch.zeros_like(u)
    fv = fu.clone()
    fv[:, 0] = 1
    exe = _graph(partial(S.divmod_batch, impl=impl), (fu, fv), impl)
    assert sum(exe.launches.values()) == CM.divmod_launches(m, impl)
    assert exe.static["kernel_launches"] == CM.divmod_launches(m, impl)
    (q, r), counts = _replayed(exe, (u.cpu(), v.cpu()))
    assert counts == {k: 3 * n for k, n in exe.launches.items()}
    for qq, rr in (S.divmod_batch(u, v, impl=impl),
                   S.divmod_batch(u, v, impl="blocked")):
        assert torch.equal(q, qq) and torch.equal(r, rr)
    assert list(zip(bi.batch_to_ints(q), bi.batch_to_ints(r))) == [
        divmod(x, y) if y else (0, x) for x, y in zip(us, vs)]


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_pairs"])
@pytest.mark.parametrize("m", [4, 2048])
def test_modarith_graphs_replay_equal_eager_and_plain(dev, m, impl):
    """The precompute, reduce, modmul and a 16-bit-exponent modexp as
    graphs over static context buffers: 3 replays count 3x the model,
    and every replay equals the eager call, the plain versions and
    Python."""
    from functools import partial
    from repro_torch.core import modarith as MA
    rnd = random.Random(m + 1)
    mod = rnd.randint(B ** (m - 1), B ** m - 1)
    xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(4)]
    a = [x % B ** m for x in xs]
    es = [0, 1, 65535, 12345]
    vt = _t([mod], m, dev)[0]
    one = torch.zeros_like(vt)
    one[0] = 1
    pre = _graph(partial(MA.barrett_precompute, impl=impl), (one,), impl)
    ctx, counts = _replayed(pre, (vt,))
    assert sum(counts.values()) == 3 * CM.precompute_launches(m, impl)
    ctx = MA.BarrettContext(*ctx)
    for eager in (MA.barrett_precompute(vt, impl),
                  MA.barrett_precompute(vt, "blocked")):
        assert torch.equal(ctx.mu, eager.mu) and torch.equal(ctx.k, eager.k)
    fill_ctx = (one, torch.zeros_like(ctx.mu), torch.zeros_like(ctx.k))
    cases = (("reduce", MA.reduce_shared, (_t(xs, 2 * m, dev),), {},
              [x % mod for x in xs]),
             ("modmul", MA.modmul_shared, (_t(a, m, dev),
                                           _t(a[::-1], m, dev)), {},
              [x * y % mod for x, y in zip(a, a[::-1])]),
             ("modexp", MA.modexp_shared, (_t(a, m, dev), _t(es, 1, dev)),
              {"e_bits": 16}, [pow(x, y, mod) for x, y in zip(a, es)]))
    for op, f, cols, kw, want in cases:
        def run(v, mu, k, *c, f=f):
            return f(MA.BarrettContext(v, mu, k), *c, impl=impl)
        exe = _graph(run, fill_ctx + tuple(torch.zeros_like(c)
                                           for c in cols), impl)
        got, counts = _replayed(exe, tuple(ctx) + cols)
        assert sum(counts.values()) == 3 * CM.model_launches(op, m, impl,
                                                             **kw)
        for eager in (f(ctx, *cols, impl=impl), f(ctx, *cols,
                                                   impl="blocked")):
            assert torch.equal(got, eager)
        assert bi.batch_to_ints(got) == want


def test_services_replay_graphs_per_bucket(dev):
    """Both services on the card at 2^15 bits: one executable per
    (op, bucket), a graph with the model's launches, exact answers, and
    a measured-vs-model report whose every row matches."""
    from repro_torch.obs import report as R
    from repro_torch.serving.bigint_service import BigintDivisionService
    from repro_torch.serving.modexp_service import ModArithService
    m = 2048
    rnd = random.Random(15)
    svc = BigintDivisionService(m_limbs=m, batch_buckets=(4, 8), device=dev)
    us = [rnd.randint(0, B ** m - 1) for _ in range(11)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(11)]
    qs, rs = svc.divide(us, vs)
    assert list(zip(qs, rs)) == [divmod(x, y) for x, y in zip(us, vs)]
    assert svc.stats()["bucket_compiles"] == 2
    mod = ModArithService(m_limbs=m, e_limbs=1, batch_buckets=(4,),
                          device=dev)
    v = rnd.randint(B ** (m - 1), B ** m - 1)
    a = [rnd.randint(0, B ** m - 1) for _ in range(4)]
    assert mod.modexp(a, [3, 0, 1, 65535], v) == [
        pow(x, e, v) for x, e in zip(a, [3, 0, 1, 65535])]
    assert mod.reduce([x * x for x in a], v) == [x * x % v for x in a]
    for snap in (svc.snapshot(), mod.snapshot()):
        rows = R.measured_vs_model(snap)
        assert rows and all(r["match"] and r["model_launches"]
                            for r in rows), R.render_measured_vs_model(snap)


def test_threads_share_one_bucket_graph(dev):
    """8 threads replay one bucket's graph with their own operands:
    every answer exact, one build."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.serving.bigint_service import BigintDivisionService
    m = 26
    svc = BigintDivisionService(m_limbs=m, batch_buckets=(4,), device=dev)
    rnd = random.Random(8)
    jobs = [([rnd.randint(0, B ** m - 1) for _ in range(4)],
             [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(4)])
            for _ in range(32)]

    def work(job):
        return svc.divide(*job)

    with ThreadPoolExecutor(max_workers=8) as pool:
        outs = list(pool.map(work, jobs))
    for (us, vs), (qs, rs) in zip(jobs, outs):
        assert list(zip(qs, rs)) == [divmod(x, y) for x, y in zip(us, vs)]
    st = svc.stats()
    assert (st["bucket_compiles"], st["bucket_reuses"]) == (1, 31)


def test_compile_fault_and_failed_capture_cache_nothing(dev):
    """A seeded compile fault raises the typed fault before any build,
    and a capture that raises caches nothing and leaves the device
    usable: the next build captures and answers exactly."""
    from repro_torch.serving import batching as BT
    from repro_torch.serving import errors as E
    from repro_torch.serving.bigint_service import BigintDivisionService
    from repro_torch.serving.faults import FaultInjector, FaultSpec
    m = 4
    svc = BigintDivisionService(m_limbs=m, batch_buckets=(2,), device=dev)
    svc.set_fault_injector(FaultInjector([FaultSpec(
        site="compile", impl="cuda_fused", kind="compile", times=1)]))
    build.build_all()
    build.reset_launch_counts()
    with pytest.raises(E.CompileFault):
        svc.divide([7, 9], [2, 4])
    assert len(svc._fns) == 0 and svc.kernel_plans == {}
    assert build.launch_counts() == {}
    assert svc.divide([7, 9], [2, 4]) == ([3, 2], [1, 1])

    def refuse(u, v):
        if torch.cuda.is_current_stream_capturing():
            raise build.LaunchError("a kernel under capture", 1)
        return S.divmod_batch(u, v)

    cache = BT.CompiledBuckets()
    fill = torch.ones(2, m, dtype=torch.int32, device=dev)
    with pytest.raises(build.LaunchError):
        cache.use("divmod", 2, "cuda_fused", "cuda_fused",
                  lambda: BT.Executable(refuse, (fill, fill),
                                        BT.kernel_plan()))
    assert len(cache) == 0 and cache.current == {}
    exe = cache.use("divmod", 2, "cuda_fused", "cuda_fused",
                    lambda: BT.Executable(S.divmod_batch, (fill, fill),
                                          BT.kernel_plan()))
    q, r = exe(_t([7, 9], m, dev), _t([2, 4], m, dev))
    assert bi.batch_to_ints(q) == [3, 2] and bi.batch_to_ints(r) == [1, 1]


def test_modexp_full_exponent_graph(dev):
    """ModArithService's default e_limbs = m_limbs at a small m: the whole
    ladder captures as one graph, with the model's launches, exact."""
    from repro_torch.serving.modexp_service import ModArithService
    m = 4
    mod = ModArithService(m_limbs=m, batch_buckets=(4,), device=dev)
    rnd = random.Random(44)
    v = rnd.randint(B ** (m - 1), B ** m - 1)
    a = [rnd.randint(0, B ** m - 1) for _ in range(4)]
    e = [rnd.randint(0, B ** m - 1) for _ in range(3)] + [B ** m - 1]
    mod.profile_bucket("precompute", 1)
    mod.profile_bucket("modexp", 4)
    build.reset_launch_counts()
    assert mod.modexp(a, e, v) == [pow(x, y, v) for x, y in zip(a, e)]
    torch.cuda.synchronize()
    assert sum(build.launch_counts().values()) == (
        CM.precompute_launches(m) + CM.modexp_launches(16 * m))


# ---------------------------------------------------------------------------
# the multi-device path: sharded services, the current device, the dry run
# ---------------------------------------------------------------------------

def _launched(fn):
    """fn()'s result and the launches it counted (after a synchronize)."""
    build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, sum(build.launch_counts().values())


def test_sharded_services_on_one_card_twice(dev):
    """Both services over a mesh naming the card twice (one graph and
    stream per shard): exact, equal to the unsharded services, shards x
    the model's launches per chunk, one precompute per modulus, every
    report row matching per shard."""
    from repro_torch.launch.mesh import mesh_of
    from repro_torch.obs import report as R
    from repro_torch.serving.bigint_service import BigintDivisionService
    from repro_torch.serving.modexp_service import ModArithService
    mesh = mesh_of([dev, dev])
    m = 2048
    rnd = random.Random(77)
    svc = BigintDivisionService(m, batch_buckets=(4, 8), mesh=mesh)
    plain = BigintDivisionService(m, batch_buckets=(4, 8), device=dev)
    for b in (4, 8):
        svc.profile_bucket(b)
    us = [rnd.randint(0, B ** m - 1) for _ in range(11)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(11)]
    got, n = _launched(lambda: svc.divide(us, vs))
    assert list(zip(*got)) == [divmod(x, y) for x, y in zip(us, vs)]
    assert got == plain.divide(us, vs)
    assert n == 2 * 2 * CM.divmod_launches(m)          # 2 chunks x 2 shards

    mod = ModArithService(m, e_limbs=1, batch_buckets=(4,), mesh=mesh)
    mod.profile_bucket("precompute", 1)
    for op in ("reduce", "modmul", "modexp"):
        mod.profile_bucket(op, 4)
    vs2 = [rnd.randint(B ** (m - 1), B ** m - 1), rnd.randint(3, B ** 9)]
    a = [rnd.randint(0, B ** m - 1) for _ in range(4)]
    e = [0, 1, 65535, rnd.randint(0, 65535)]
    per_round = 2 * (CM.barrett_launches() + CM.modmul_launches()
                     + CM.modexp_launches(16))
    for i, v in enumerate(vs2 + vs2):
        def calls():
            return (mod.reduce([x * x for x in a], v),
                    mod.modmul(a, a[::-1], v), mod.modexp(a, e, v))
        (r, mm, me), n = _launched(calls)
        assert r == [x * x % v for x in a]
        assert mm == [x * y % v for x, y in zip(a, a[::-1])]
        assert me == [pow(x, y, v) for x, y in zip(a, e)]
        first = i < 2
        assert n == per_round + first * CM.precompute_launches(m)
    assert mod.stats()["ctx_cache"]["misses"] == 2
    for snap in (svc.snapshot(), mod.snapshot()):
        rows = R.measured_vs_model(snap)
        assert all(r["match"] and r["model_launches"] for r in rows)
        assert {r["shards"] for r in rows if r["op"] != "precompute"} == {2}


def test_kernels_on_a_device_that_is_not_current(dev):
    """Every kernel wrapper on tensors of the second card while the
    first is current: equal to its plain version (each launch runs
    under `build.on_device`); a stream context on the second card makes
    it current; a service sharded over both cards is exact."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.core import modarith as MA
    from repro_torch.kernels import bigmul
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.serving.bigint_service import BigintDivisionService
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    s = torch.cuda.Stream(d1)
    with torch.cuda.stream(s):
        assert torch.cuda.current_device() == 1
    assert torch.cuda.current_device() == 0
    rnd = random.Random(9)
    m = 130
    u = _t([rnd.randint(0, B ** m - 1) for _ in range(5)], m, d1)
    v = _t([rnd.randint(1, B ** m - 1) for _ in range(5)], m, d1)
    assert torch.equal(K.mul_batch(u, v, 2 * m), K.mul_plain(u, v, 2 * m))
    assert torch.equal(bigmul.mul_pairs(u, v, 2 * m),
                       K.mul_plain(u, v, 2 * m))
    q, r = S.divmod_batch(u, v)                    # steps + correct
    qp, rp = S.divmod_batch(u, v, impl="blocked")
    assert torch.equal(q, qp) and torch.equal(r, rp)
    ctx = MA.barrett_precompute(v[0])
    x = _t([rnd.randint(0, B ** (2 * m) - 1) for _ in range(5)], 2 * m, d1)
    assert torch.equal(MA.reduce_shared(ctx, x),
                       MA.reduce_shared(ctx, x, impl="blocked"))
    assert torch.cuda.current_device() == 0
    svc = BigintDivisionService(m, batch_buckets=(4,),
                                mesh=make_device_mesh(2))
    us = [rnd.randint(0, B ** m - 1) for _ in range(4)]
    vs = [rnd.randint(1, B ** m - 1) for _ in range(4)]
    assert list(zip(*svc.divide(us, vs))) == [divmod(a, b)
                                              for a, b in zip(us, vs)]


def test_dryrun_2p15(dev):
    """One shard of 8,192 divisions over the 256-shard layout at 2^15
    bits: exact, the model's launches, the cost model's roofline."""
    from repro_torch.launch import bigint_dryrun as DR
    from repro_torch.obs import roofline as RL
    rec = DR.run(2048, 8192, device=dev)
    assert rec["exact"] and rec["status"] == "ok"
    assert rec["rows_per_shard"] == 32 and rec["shards"] == 256
    assert rec["launches"]["per_shard"] == CM.divmod_launches(2048)
    assert rec["roofline"] == RL.roofline_terms(CM.divmod_work(2048, 32))
    assert rec["memory"]["peak_bytes_est"] > 4 * 32 * 2048 * 4
    assert rec["capture_s"] is not None


def test_scope_adds_no_launch(dev):
    """With profiling on, a divmod and its captured graph launch the
    model's kernels, no more."""
    from repro_torch.obs import telemetry as T
    from repro_torch.serving import batching as BT
    m = 26
    rnd = random.Random(5)
    u = _t([rnd.randint(0, B ** m - 1) for _ in range(4)], m, dev)
    v = _t([rnd.randint(1, B ** m - 1) for _ in range(4)], m, dev)
    T.set_profiling(True)
    try:
        (q, r), n = _launched(lambda: S.divmod_batch(u, v))
        exe = BT.Executable(S.divmod_batch, (u, v), BT.kernel_plan())
        (q2, r2), n2 = _launched(lambda: exe(u, v))
    finally:
        T.set_profiling(False)
    assert n == n2 == CM.divmod_launches(m)
    assert sum(exe.launches.values()) == CM.divmod_launches(m)
    assert torch.equal(q, q2) and torch.equal(r, r2)
