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


def _branches(st, win, sign):
    """Per lane, which edge of the step a lane takes (plain ops on the
    card): v * w = 0, powdiff's close and full branches, and update's
    floor correction (a nonzero dropped limb under the minus sign)."""
    from repro_torch.core import arith as A
    vp = A.shift(st["v"], -st["s"])[:, :win]
    wq = st["w"][:, :win]
    pv, pw = A.prec(vp), A.prec(wq)
    vwz = (pv == 0) | (pw == 0)
    full = vwz | (pv + pw - st["lpd"] + 1 >= st["hpd"])
    x = F.powdiff_reference(st["v"], st["w"], st["hpd"], st["lpd"],
                            st["s"], win=win)[1]
    tmp = K.mul_plain(wq, x[:, :win], 2 * win)
    idx = torch.arange(2 * win, device=tmp.device)
    dropped = ((idx < (st["h"] - 2 * st["m"])[:, None]) & (tmp != 0)).any(-1)
    return dict(vwz=vwz, close=~full, full=full & ~vwz,
                dropped=dropped & ~sign & st["active"])


@pytest.mark.parametrize("full_w", [2056, 16392])
@pytest.mark.parametrize("win", [32, 48, 80, 144, 272, 528, 1040])
def test_step_kernels_packed_match_plain_and_clustered(dev, monkeypatch,
                                                       full_w, win):
    """The packed powdiff and update (`digitmma.step_plan`: 301 lanes, a
    batch that is no multiple of the teams a block) at each window the
    Refine loop runs packed, at the working widths of 2^15 and 2^18 bits:
    equal to the plain versions and to the clustered path bit for bit, on
    lanes that take v * w = 0, the close and the full branch, both signs,
    inactive lanes and the dropped-limb floor correction."""
    from repro_torch.kernels import digitmma as D
    batch = 301
    lib = build.lib("step")
    plan = D.step_plan(win, batch, D.device_sms(dev),
                       lib.step_lane_bytes(win), lib.step_pack_threads())
    assert plan is not None and batch % plan.lanes
    st = _step_lanes(batch, full_w, win, full_w + win, dev)
    pd = (st["v"], st["w"], st["hpd"], st["lpd"], st["s"])
    sk, xk = F.powdiff_cuda(*pd, win=win)
    assert (D.last_cluster["powdiff"], D.last_lanes["powdiff"]) == \
        (1, plan.lanes)
    args = (st["w"], xk, sk, st["h"], st["m"], st["active"])
    out = F.update_cuda(*args, win=win)
    assert (D.last_cluster["update"], D.last_lanes["update"]) == \
        (1, plan.lanes)
    torch.cuda.synchronize()
    sp, xp = F.powdiff_reference(*pd, win=win)
    assert torch.equal(sk, sp) and torch.equal(xk, xp)
    assert torch.equal(out, F.update_reference(*args, win=win))
    seen = _branches(st, win, sp)
    assert all(bool(lanes.any()) for lanes in seen.values()), seen
    assert bool(sp.any()) and bool((~sp).any())
    assert bool((~st["active"]).any())
    monkeypatch.setattr(D, "step_plan", lambda *a, **k: None)
    sc, xc = F.powdiff_cuda(*pd, win=win)
    oc = F.update_cuda(*args, win=win)
    torch.cuda.synchronize()
    assert D.last_lanes["powdiff"] == D.last_lanes["update"] == 1
    assert torch.equal(sc, sk) and torch.equal(xc, xk)
    assert torch.equal(oc, out)


def test_packed_lane_bytes_match_the_library(dev):
    """The step library's lane_bytes, which step_plan is given, holds an
    instance's column sums and both staged operands, and packs at least
    one instance a block at every window step_plan packs at all."""
    from repro_torch.kernels import digitmma as D
    lib = build.lib("step")
    for win in range(1, D.PACK_WINDOW + 1):
        got = lib.step_lane_bytes(win)
        assert got >= 16 + 16 * win + 4 * win
        assert got % 16 == 0
        plan = D.step_plan(win, 16384, D.device_sms(dev), got,
                           lib.step_pack_threads())
        assert plan is not None and plan.lanes * got <= D.DYNAMIC_SMEM_BYTES


@pytest.mark.parametrize("m", [2048, 16384])
def test_divmod_with_packed_steps_exact_with_launch_count(dev, m):
    """A division batch of 1.5 lanes an SM (cluster 1), so that its
    Refine iterations up to digitmma.PACK_WINDOW run packed: exact
    against Python on edge and random lanes (u all-0xFFFF, v = B^(m/2),
    v = 0, one-limb v, u < v), with the launches of
    costmodel.divmod_launches(m) + prologue_launches()."""
    from repro_torch.kernels import digitmma as D
    sms = D.device_sms(dev)
    batch = (3 * sms + 1) // 2
    lib = build.lib("step")
    for win in (CM.refine_window(0, m + S.PAD), D.PACK_WINDOW):
        assert D.step_plan(win, batch, sms, lib.step_lane_bytes(win),
                           lib.step_pack_threads()) is not None
    rnd = random.Random(m)
    us = [rnd.getrandbits(16 * m) for _ in range(batch)]
    vs = [rnd.getrandbits(16 * rnd.randint(1, m // 2)) | 1
          for _ in range(batch)]
    us[0], vs[0] = B ** m - 1, B ** (m // 2) - 1
    vs[1], vs[2], vs[3] = B ** (m // 2), 0, 7
    us[4], vs[4] = 12345, B ** (m // 2) + 1
    build.build_all()
    build.reset_launch_counts()
    q, r = S.divmod_batch(_t(us, m, dev), _t(vs, m, dev))
    torch.cuda.synchronize()
    it = CM.refine_iters(m)
    assert build.launch_counts() == {"prologue": 1, "powdiff": it,
                                     "update": it, "correct": 1}
    assert sum(build.launch_counts().values()) == \
        CM.divmod_launches(m) + CM.prologue_launches()
    for x, y, qq, rr in zip(us, vs, bi.batch_to_ints(q),
                            bi.batch_to_ints(r)):
        assert (qq, rr) == (divmod(x, y) if y else (0, x))


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
    costmodel.divmod_launches(30000) + prologue_launches() launches."""
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
    assert build.launch_counts() == {"prologue": 1, "powdiff": it,
                                     "update": it, "correct": 1}
    assert sum(build.launch_counts().values()) == \
        CM.divmod_launches(m) + CM.prologue_launches()
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
    assert sum(build.launch_counts().values()) == \
        CM.divmod_launches(cap) + CM.prologue_launches()
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
    assert counts == {"prologue": 1, "powdiff": CM.refine_iters(m),
                      "update": CM.refine_iters(m), "correct": 1}
    assert sum(counts.values()) == \
        CM.divmod_launches(m) + CM.prologue_launches()
    for x, y, qq, rr in zip(us, vs, bi.batch_to_ints(q),
                            bi.batch_to_ints(r)):
        assert (qq, rr) == (divmod(x, y) if y else (0, x))
    np.testing.assert_array_equal(
        bi.limbs_to_numpy(q),
        bi.limbs_to_numpy(S.divmod_batch(_t(us, m, "cpu"),
                                         _t(vs, m, "cpu"))[0]))


# -- the division's set-up (csrc/prologue.cu) ------------------------------

def _same(got, want):
    """Every output of the set-up equal, dtype and bits: the four limb
    arrays (uw None for the entry with h given), then each (batch,) row
    of the scalars and of the flags."""
    for g, w in zip(got[:4], want[:4]):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype and torch.equal(g, w)
    for gs, ws in zip(got[4:], want[4:]):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("m", [27, 2046, 2048, 16384])
def test_prologue_kernel_matches_plain_divmod_entry(dev, m):
    """u and v given: the kernel's pads, h = prec(u), lifted v, first
    iterate, scalars and special cases bit for bit with the ATen set-up
    on the edge lanes (v = 0, 1, single limbs, B^k, B^h / 2 and around
    it, B^h, a top limb 0xFFFF, u = 0), at the cells' W = 2,056 and
    16,392, an odd W = 35 and W = 2,054 (8-byte accesses), 37 lanes."""
    from _prologue_lanes import divmod_lanes
    lanes = divmod_lanes(m, seed=m)
    u = _t([a for a, _ in lanes], m, dev)
    v = _t([b for _, b in lanes], m, dev)
    build.build_all()
    build.reset_launch_counts()
    got = F.prologue_cuda(v, u=u)
    torch.cuda.synchronize()
    assert build.launch_counts() == {"prologue": 1}
    assert got[0].shape == (len(lanes), m + S.PAD)
    _same(got, S.prologue_plain(v, u=u))


@pytest.mark.parametrize("width", [35, 2056, 4106, 16392])
def test_prologue_kernel_matches_plain_shinv_entry(dev, width):
    """h given and v already W wide (`shinv_batch`, the Barrett
    precompute's entry; 4,106 is a 2^15-bit modulus's Barrett width):
    h = 0, in range, at and past the width and negative, v with top
    bits that 2v mod B^W drops, bit for bit with the ATen set-up."""
    from _prologue_lanes import shinv_lanes
    lanes = shinv_lanes(width, seed=width)
    v = _t([a for a, _ in lanes], width, dev)
    h = torch.tensor([b for _, b in lanes], dtype=torch.int32, device=dev)
    build.build_all()
    got = F.prologue_cuda(v, h=h)
    torch.cuda.synchronize()
    assert got[0] is None and got[1] is v
    _same(got, S.prologue_plain(v, h))


@pytest.mark.parametrize("m", [27, 2048, 16384])
def test_divmod_graph_exact_on_prologue_lanes(dev, m):
    """divmod_batch through a bucket executable on the set-up's edge
    lanes: every lane against Python divmod (divmod(u, 0) = (0, u))."""
    from functools import partial
    from _prologue_lanes import divmod_lanes
    lanes = divmod_lanes(m, seed=m + 1)
    u = _t([a for a, _ in lanes], m, dev)
    v = _t([b for _, b in lanes], m, dev)
    fu = torch.zeros_like(u)
    fv = fu.clone()
    fv[:, 0] = 1
    exe = _graph(partial(S.divmod_batch, impl="cuda_fused"), (fu, fv),
                 "cuda_fused")
    assert exe.launches["prologue"] == 1
    q, r = exe(u, v)
    assert list(zip(bi.batch_to_ints(q), bi.batch_to_ints(r))) == [
        divmod(x, y) if y else (0, x) for x, y in lanes]


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
    assert sum(build.launch_counts().values()) == \
        CM.precompute_launches(m) + CM.prologue_launches()
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
    precomputes with `costmodel.precompute_launches(16384, impl)` +
    `prologue_launches(impl)` launches and reduces exactly.  A modulus past the new cap (the
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
        assert sum(counts.values()) == \
            CM.precompute_launches(m, impl) + CM.prologue_launches(impl)
        if name:
            assert counts == {name: CM.precompute_launches(m, impl)}
        else:
            assert counts == {"prologue": 1,
                              "powdiff": CM.precompute_launches(m) // 2,
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
        assert CM.prologue_launches(impl) == 0      # the set-up in torch
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
    want = CM.divmod_launches(m, impl) + CM.prologue_launches(impl)
    assert sum(exe.launches.values()) == want
    assert exe.static["kernel_launches"] == want
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
    assert sum(counts.values()) == 3 * (CM.precompute_launches(m, impl)
                                        + CM.prologue_launches(impl))
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
        CM.precompute_launches(m) + CM.prologue_launches()
        + CM.modexp_launches(16 * m))


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
    assert n == 2 * 2 * (CM.divmod_launches(m)         # 2 chunks x 2 shards
                         + CM.prologue_launches())

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
        assert n == per_round + first * (CM.precompute_launches(m)
                                         + CM.prologue_launches())
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
    assert rec["launches"]["per_shard"] == \
        CM.divmod_launches(2048) + CM.prologue_launches()
    assert rec["launches"]["prologue"] == CM.prologue_launches()
    assert rec["roofline"] == RL.roofline_terms(CM.divmod_work(2048, 32))
    assert rec["memory"]["peak_bytes_est"] > 4 * 32 * 2048 * 4
    assert rec["capture_s"] is not None


def test_scope_adds_no_launch(dev):
    """With profiling on, a divmod and its captured graph launch the
    model's kernels, no more; the eager calls (the call and the build's
    warm-up) log host spans, the replay device spans."""
    from repro_torch.obs import telemetry as T
    from repro_torch.serving import batching as BT
    m = 26
    rnd = random.Random(5)
    u = _t([rnd.randint(0, B ** m - 1) for _ in range(4)], m, dev)
    v = _t([rnd.randint(1, B ** m - 1) for _ in range(4)], m, dev)
    T.reset_span_log()
    T.set_profiling(True)
    try:
        (q, r), n = _launched(lambda: S.divmod_batch(u, v))
        exe = BT.Executable(S.divmod_batch, (u, v), BT.kernel_plan())
        (q2, r2), n2 = _launched(lambda: exe(u, v))
    finally:
        T.set_profiling(False)
    spans = T.span_log()
    assert sum(s.device and s.name == "divmod" for s in spans) == 1
    assert sum(not s.device and s.name == "divmod" for s in spans) == 2
    want = CM.divmod_launches(m) + CM.prologue_launches()
    assert n == n2 == want
    assert sum(exe.launches.values()) == want
    assert torch.equal(q, q2) and torch.equal(r, r2)


def _marked_division(dev, lanes=64, seed=15):
    """A divmod executable at 2^15 bits x `lanes`, built on the padding
    fill, and operands with divisors of 1..1,024 limbs."""
    from functools import partial
    from repro_torch.serving import batching as BT
    m = 2048
    rnd = random.Random(seed)
    u = _t([rnd.randint(0, B ** m - 1) for _ in range(lanes)], m, dev)
    v = _t([rnd.randint(1, B ** rnd.randint(1, m // 2) - 1)
            for _ in range(lanes)], m, dev)
    fu = torch.zeros_like(u)
    fv = fu.clone()
    fv[:, 0] = 1
    exe = BT.Executable(partial(S.divmod_batch, impl="cuda_fused"),
                        (fu, fv), BT.kernel_plan("cuda_fused"))
    return m, exe, u, v


def _phases(spans) -> dict:
    """{call: (prologue + Refine + finalization ns, Refine ns, Refine
    glue ns)} of the device spans."""
    out: dict = {}
    by_id = {s.id: s for s in spans}
    for s in spans:
        if not s.device:
            continue
        d = s.end_ns - s.start_ns
        ph, ref, glue = out.get(s.call, (0, 0, 0))
        if s.name.startswith("refine_iter_"):
            ph, ref, glue = ph + d, ref + d, glue + d
        elif s.name in ("divmod/prologue", "divmod/epilogue",
                        "fused_correct"):
            ph += d
        elif s.name == "fused_step" and \
                by_id[s.parent].name.startswith("refine_iter_"):
            glue -= d
        out[s.call] = (ph, ref, glue)
    return out


def test_marks_change_no_answer_and_no_launch_count(dev):
    """Through the executable at 2^15 bits x 64 lanes: the spans are
    2 * refine_iters + 4, their marks as many nodes (a boundary with
    nothing captured since the last mark shares it), and the answers
    are bit-equal to eager `divmod_batch`'s with the cost model's
    launches counted a replay."""
    m, exe, u, v = _marked_division(dev)
    assert len(exe.marks.tape) == 2 * S.refine_iters(m) + 4
    assert exe.marks.width == 2 * S.refine_iters(m) + 4
    (q1, r1), counts = _replayed(exe, (u, v))
    q2, r2 = S.divmod_batch(u, v)
    assert torch.equal(q1, q2) and torch.equal(r1, r2)
    assert sum(exe.launches.values()) == \
        CM.divmod_launches(m) + CM.prologue_launches()
    assert counts == {k: 3 * n for k, n in exe.launches.items()}


def test_division_phases_sum_to_an_event_timed_replay(dev):
    """Prologue + Refine + finalization from the span log come within
    2% of each call's CUDA-event time (calls queued behind a spin, so
    the host adds no gap), with the Refine glue inside the Refine."""
    from repro_torch.obs import telemetry as T
    m, exe, u, v = _marked_division(dev)
    exe(u, v)
    torch.cuda.synchronize()
    T.reset_span_log()
    events = []
    T.set_profiling(True)
    try:
        torch.cuda._sleep(50_000_000)
        for _ in range(5):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            exe(u, v)
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
    finally:
        T.set_profiling(False)
    spans = T.span_log()
    assert T.spans_dropped() == 0
    phases = [p for _, p in sorted(_phases(spans).items())]
    assert len(phases) == 5
    for (e0, e1), (ph, ref, glue) in zip(events, phases):
        ms = e0.elapsed_time(e1)
        assert abs(ph / 1e6 - ms) <= 0.02 * ms, (ph / 1e6, ms)
        assert 0 <= glue <= ref


def test_span_log_matches_the_profiler(dev):
    """In one torch.profiler trace every `span_mark_kernel` starts
    within 0.1 ms of a mark time of the log and every mark time lies
    within 0.1 ms of one, a replay's worth of kernels a call; the host
    span `exe/replay` starts within 0.1 ms of its profiler range."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs import telemetry as T
    m, exe, u, v = _marked_division(dev)
    exe(u, v)
    torch.cuda.synchronize()
    T.reset_span_log()
    T.set_profiling(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                exe(u, v)
            torch.cuda.synchronize()
    finally:
        T.set_profiling(False)
    spans = T.span_log()
    events = prof.profiler.kineto_results.events()
    kernels = sorted(ev.start_ns() for ev in events
                     if ev.name().startswith("span_mark_kernel")
                     and str(ev.device_type()).endswith("CUDA"))
    marks = sorted({t for s in spans if s.device
                    for t in (s.start_ns, s.end_ns)})
    assert len(kernels) == 3 * exe.marks.width
    assert len({s.call for s in spans if s.device}) == 3

    def far(xs, ys):
        return max(min(abs(x - y) for y in ys) for x in xs)

    assert far(kernels, marks) <= 100_000 and far(marks, kernels) <= 100_000
    ranges = sorted(ev.start_ns() for ev in events
                    if ev.name() == "exe/replay"
                    and not str(ev.device_type()).endswith("CUDA"))
    hosts = sorted(s.start_ns for s in spans if s.name == "exe/replay")
    assert len(ranges) == len(hosts) == 3
    assert far(hosts, ranges) <= 100_000


# ---------------------------------------------------------------------------
# the LM serve path (repro_torch.models): no hand-written kernel
# ---------------------------------------------------------------------------

LM_DECODER_ONLY = ["smollm-135m", "qwen2-0.5b", "starcoder2-3b",
                   "nemotron-4-340b", "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b",
                   "arctic-480b"]


@pytest.mark.parametrize("arch", LM_DECODER_ONLY)
def test_lm_reduced_on_card_matches_cpu(dev, arch):
    """One set of float32 weights on the CPU and a copy on the card:
    prefill logits within rtol = atol = 1e-4, 8 greedy decode steps
    within 1e-3 (the bf16 KV cache), tokens equal, no kernel launched."""
    import copy
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = C.get_config(arch).reduced()
    cpu = T.init_params(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
    build.reset_launch_counts()
    want = T.forward_prefill(cpu, {"tokens": toks})
    got = T.forward_prefill(card, {"tokens": toks.to(dev)}).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    cc = T.init_cache(cfg, 2, 8, "cpu")
    gc = T.init_cache(cfg, 2, 8, dev)
    tok = toks[:, 0]
    for i in range(8):
        lc, cc = T.forward_decode(cpu, cc, {"token": tok}, i)
        lg, gc = T.forward_decode(card, gc, {"token": tok.to(dev)}, i)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
        tok = lc[:, :cfg.vocab].argmax(-1)
        assert torch.equal(lg[:, :cfg.vocab].argmax(-1).cpu(), tok)
    assert not any(build.launch_counts().values())


def test_lm_smollm_full_decode_matches_prefill(dev):
    """smollm-135m at its published width and depth, built on the card:
    step-by-step decode of a 32-token prompt ends on the prefill's
    last-position logits, every logit finite.  A float32 copy of the
    weights at JAX's tolerance for this check (2e-2, float32 configs);
    the bf16 model at 2^-4 (its decode and prefill GEMMs differ in shape
    and round their bf16 outputs differently: 0.039 measured at 64
    positions, batch 8, on an H100 80GB HBM3 at 700 W)."""
    import copy
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = C.get_config("smollm-135m")
    model = T.init_params(cfg, 0, dev)
    assert sum(p.numel() for p in model.parameters()) == \
        T.vocab_padded(cfg) * cfg.d_model + cfg.n_params() \
        - cfg.vocab * cfg.d_model + cfg.n_layers * 2 * cfg.d_model \
        + cfg.d_model                       # padded vocab; norm scales
    m32 = copy.deepcopy(model).to(torch.float32)
    m32.cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype_str="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (4, 32), generator=gen, device=dev)
    for m, tol in ((m32, 2e-2), (model, 2 ** -4)):
        full = T.forward_prefill(m, {"tokens": toks})
        cache = T.init_cache(cfg, 4, 32, dev)
        for i in range(32):
            logits, cache = T.forward_decode(m, cache, {"token": toks[:, i]},
                                             i)
        assert torch.isfinite(full).all() and torch.isfinite(logits).all()
        torch.testing.assert_close(logits.float(), full.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_lm_recurrent_and_encdec_reduced_on_card_match_cpu(dev, arch):
    """The ssm, hybrid and encdec families, reduced, float32 weights on
    the CPU and a copy on the card: prefill logits within rtol = atol =
    1e-4 (rwkv at 128 positions, its chunked WKV form), 8 greedy decode
    steps within 1e-3, tokens equal; whisper with its cross cache filled
    by its encoder over enc_seq frames on each device.  No kernel
    launched."""
    import copy
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = C.get_config(arch).reduced()
    cpu = T.init_params(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(0)
    s = 128 if cfg.family == "ssm" else 32
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, s), generator=gen)}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((2, cfg.enc_seq, cfg.d_model),
                                          generator=gen)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    build.reset_launch_counts()
    want = T.forward_prefill(cpu, batch)
    got = T.forward_prefill(card, on_card).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    cc = T.init_cache(cfg, 2, 8, "cpu")
    gc = T.init_cache(cfg, 2, 8, dev)
    if cfg.family == "encdec":
        T.encode_cross(cpu, cc, batch)
        T.encode_cross(card, gc, on_card)
    tok = batch["tokens"][:, 0]
    for i in range(8):
        lc, cc = T.forward_decode(cpu, cc, {"token": tok}, i)
        lg, gc = T.forward_decode(card, gc, {"token": tok.to(dev)}, i)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-3, atol=1e-3)
        tok = lc[:, :cfg.vocab].argmax(-1)
        assert torch.equal(lg[:, :cfg.vocab].argmax(-1).cpu(), tok)
    assert not any(build.launch_counts().values())


def test_lm_rwkv_full_decode_matches_prefill(dev):
    """rwkv6-7b at its published width (d_model 4,096, 64 heads), built
    on the card: step-by-step decode of a 128-token prompt (the
    prefill's chunked WKV form) against the prefill's last-position
    logits on its first 4 of 32 layers (`first_layers`): a float32 copy
    of the weights at JAX's tolerance (2e-2), the bf16 model within 2^-3
    (chip_smoke.py LM_TOL_WKV_BF16: bf16 puts RWKV's logits 0.19 from
    float32's there).  At all 32 layers the bf16 prefill's logits are
    finite.  The smoke also holds the copy at 8, 16 and 32 layers."""
    import copy
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    cfg = C.get_config("rwkv6-7b")
    model = T.init_params(cfg, 0, dev)
    m32 = copy.deepcopy(model).to(torch.float32)
    m32.cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype_str="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (4, 128), generator=gen, device=dev)
    assert torch.isfinite(T.forward_prefill(model, {"tokens": toks})).all()
    for m, tol in ((m32, 2e-2), (model, 2 ** -3)):
        m = T.first_layers(m, 4)
        full = T.forward_prefill(m, {"tokens": toks}).float()
        cache = T.init_cache(m.cfg, 4, 1, dev)
        for i in range(128):
            logits, cache = T.forward_decode(m, cache,
                                             {"token": toks[:, i]}, i)
        torch.testing.assert_close(logits.float(), full, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# LM training (repro_torch.train): no hand-written kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-1.5-large-398b"])
def test_lm_train_step_on_card_matches_cpu(dev, arch):
    """A train step, float32 weights on the CPU and a copy on the card,
    the same batch: loss within rtol 1e-4, every gradient
    within rtol 1e-3, atol 1e-5 x the leaf's max
    (Jamba's bf16-stream leaves at atol 2^-8 x max, as
    tests/test_torch_train_model.py holds them against JAX); the AdamW
    update of the card's gradients on both devices (new parameters rtol
    1e-5, atol 1e-5 lr; moments rtol 1e-5, atol 1e-5 x max; the step):
    on the CPU's own gradients a parameter whose gradient element lies
    near eps would move by up to ~lr more (chip_smoke.py
    TRAIN_TOL_UPDATE); then a make_train_step step's loss on each.  No
    kernel launched."""
    import copy
    from repro_torch import configs as C
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    cfg = C.get_config(arch).reduced()
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
    cpu = T.init_params(cfg, 0, "cpu")
    card = copy.deepcopy(cpu).to(dev)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen)
             for k in ("tokens", "labels")}
    on_card = {k: v.to(dev) for k, v in batch.items()}
    build.reset_launch_counts()
    stream = ("mamba.dt_bias", "mamba.a_log", "mamba.x_proj",
              "mamba.dt_proj")

    def close(got, want, name):
        atol = (2 ** -8 if any(s in name for s in stream) else 1e-5) \
            * want.abs().max().item()
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=1e-3, atol=atol, msg=name)

    lc, _, gc = TS.make_grad_fn(cfg)(cpu, batch)
    lg, _, gg = TS.make_grad_fn(cfg)(card, on_card)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=0)
    for k in gc:
        close(gg[k], gc[k], k)
    card_g = {k: g.float() for k, g in gg.items()}
    oc = TS.apply_grads(cpu, adamw.init_state(dict(cpu.named_parameters()),
                                              ocfg),
                        {k: g.cpu() for k, g in card_g.items()}, ocfg)
    og = TS.apply_grads(card, adamw.init_state(
        dict(card.named_parameters()), ocfg), card_g, ocfg)
    assert int(og["step"]) == int(oc["step"]) == 1
    for (k, p), q in zip(cpu.named_parameters(), card.parameters()):
        torch.testing.assert_close(q.detach().cpu(), p.detach(), rtol=1e-5,
                                   atol=1e-5 * ocfg.lr, msg=k)
        for mom in ("m", "v"):
            want = oc[mom][k]
            torch.testing.assert_close(og[mom][k].cpu(), want, rtol=1e-5,
                                       atol=1e-5 * want.abs().max().item(),
                                       msg=f"{mom} {k}")
    step = TS.make_train_step(cfg, ocfg)
    _, _, mc = step(cpu, oc, batch)
    _, _, mg = step(card, og, on_card)
    torch.testing.assert_close(mg["loss"].cpu(), mc["loss"], rtol=1e-4,
                               atol=0)
    assert not any(build.launch_counts().values())


def test_lm_checkpoint_round_trip_on_card(dev):
    """A bf16 model and its AdamW state on the card saved (async) and
    restored onto the card and onto the CPU, bit for bit."""
    import dataclasses
    import tempfile
    from repro_torch import configs as C
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(C.get_config("smollm-135m").reduced(),
                              param_dtype_str="bfloat16", dtype="bfloat16")
    model = T.init_params(cfg, 0, dev)
    params = dict(model.named_parameters())
    opt = adamw.init_state(params, adamw.AdamWConfig())
    for t in opt["m"].values():
        t.normal_()
    tree = {"params": params, "opt": opt}
    with tempfile.TemporaryDirectory() as d:
        ck = CK.AsyncCheckpointer(d)
        ck.save_async(4, tree, {"next_step": 4})
        ck.wait()
        on_card, extra = CK.restore(d, device=dev)
        on_cpu, _ = CK.restore(d)
    assert extra == {"next_step": 4}
    assert CK.digest(on_card) == CK.digest(on_cpu) == CK.digest(tree)
    for k, p in params.items():
        got = on_card["params"][k]
        assert got.device.type == "cuda" and got.dtype == torch.bfloat16
        assert torch.equal(got, p)


CARD_DIST = r"""
import sys
from dataclasses import replace
import numpy as np, torch
from repro_torch import configs as C
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import comm, pipeline as PL
from repro_torch.train import ddp_shardmap as DDP
from repro_torch.train.ddp_shardmap import init_error_buffers, make_ddp_train_step
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
backend = comm.init_group(rank, world, port, "cuda")
seen = []                  # the gradients each step hands the optimizer
apply_grads = DDP.apply_grads
def spy(model, opt, grads, opt_cfg):
    seen.append({k: g.cpu().numpy() for k, g in grads.items()})
    return apply_grads(model, opt, grads, opt_cfg)
DDP.apply_grads = spy
dev = comm.rank_device("cuda", rank, backend)
cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4)
ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                    global_batch=4))
res = {"backend": backend}
for compress in (True, False):
    model = T.init_params(cfg, 0, dev)
    opt = adamw.init_state(dict(model.named_parameters()), ocfg)
    err = init_error_buffers(model)
    step = make_ddp_train_step(cfg, ocfg, compress=compress)
    losses = []
    seen.clear()
    for i in range(6):
        b = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in stream.batch(i).items()}
        model, opt, err, loss = step(model, opt, err, b)
        losses.append(float(loss))
    res[f"losses_{int(compress)}"] = np.array(losses)
    if not compress:
        res.update({f"grad/{k}": g for k, g in seen[0].items()})
model = T.init_params(cfg, 0, dev)
x = torch.randn(4, 64, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(dev)
with torch.no_grad():
    h = PL.make_pipelined_forward(cfg, None, 2)(model, x)
    ref = PL._stage_apply(model.blocks, x, cfg,
                          torch.arange(64, device=dev)[None].expand(4, 64))
res["h"], res["ref"] = h.cpu().numpy(), ref.cpu().numpy()
np.savez(out + f"/rank{rank}.npz", **res)
torch.distributed.destroy_process_group()
"""


def test_lm_ddp_and_pipeline_two_ranks_on_card(dev, tmp_path):
    """Two ranks on the card (gloo through pinned host memory on one card,
    NCCL on two): the reduced smollm's DDP step with and without
    compression (the ranks agree, both curves fall, the last losses
    within JAX's 0.25), every uncompressed loss equal to one process's
    step on the global batch (float32, 1e-5) and the first step's
    averaged gradient to its gradient (1e-5 of each leaf's largest
    entry), and the GPipe forward over 2 stages equal to the sequential
    layers (1e-5).  No kernel launched in this process."""
    from dataclasses import replace
    from _torch_dist import run_ranks
    from repro_torch import configs as C
    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_grad_fn, make_train_step
    build.reset_launch_counts()
    ranks = run_ranks(CARD_DIST, 2, tmp_path)
    a, b = ranks
    for c in (0, 1):
        np.testing.assert_array_equal(a[f"losses_{c}"], b[f"losses_{c}"])
        assert a[f"losses_{c}"][-1] < a[f"losses_{c}"][0]
    assert abs(a["losses_1"][-1] - a["losses_0"][-1]) < 0.25
    for r in ranks:
        np.testing.assert_allclose(r["h"], ranks[0]["ref"], rtol=1e-5,
                                   atol=1e-5)
    cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
    model = T.init_params(cfg, 0, dev)
    stream = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                        global_batch=4))
    batches = [{k: torch.from_numpy(v).to(dev, torch.long)
                for k, v in stream.batch(i).items()} for i in range(6)]
    grads = make_grad_fn(cfg)(model, batches[0])[2]
    for k, g in grads.items():
        g = g.float().cpu().numpy()
        np.testing.assert_allclose(a[f"grad/{k}"], g, rtol=0,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=k)
    step = make_train_step(cfg, ocfg)
    opt = adamw.init_state(dict(model.named_parameters()), ocfg)
    losses = []
    for batch in batches:
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(a["losses_0"], losses, rtol=1e-5, atol=0)
    assert not any(build.launch_counts().values())


CARD_PIPE_GRAD = r"""
import sys
from dataclasses import replace
import numpy as np, torch
from repro_torch import configs as C
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.models import transformer as T
from repro_torch.train import comm, pipeline as PL
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
backend = comm.init_group(rank, world, port, "cuda")
dev = comm.rank_device("cuda", rank, backend)
cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4)
model = T.init_params(cfg, 0, dev).requires_grad_(True)
b = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                               global_batch=4)).batch(0)
batch = {k: torch.from_numpy(v).to(dev, torch.long) for k, v in b.items()}
loss = PL.pipelined_loss(cfg, None, 2)(model, batch)
names, params = zip(*model.named_parameters())
grads = torch.autograd.grad(loss, params, materialize_grads=True)
np.savez(out + f"/rank{rank}.npz", loss=loss.item(),
         **{"g:" + n: g.cpu().numpy() for n, g in zip(names, grads)})
torch.distributed.destroy_process_group()
"""


def test_pipelined_gradient_two_ranks_on_card(dev, tmp_path):
    """Two ranks on the card (CUDA tensors through the ring's and the
    share's autograd functions: gloo through pinned host memory on one
    card, NCCL on two): the reduced smollm's pipelined loss and gradient
    over 2 stages in 2 microbatches equal `make_grad_fn`'s on the card
    (float32: loss 1e-5, each leaf 1e-5 of its largest entry, from the
    rank that holds it); the other stage's layers get zeros.  No kernel
    launched in this process."""
    from dataclasses import replace
    from _torch_dist import run_ranks
    from repro_torch import configs as C
    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.models import transformer as T
    from repro_torch.train.step import make_grad_fn
    build.reset_launch_counts()
    ranks = run_ranks(CARD_PIPE_GRAD, 2, tmp_path, timeout=120)
    cfg = replace(C.get_config("smollm-135m").reduced(), n_layers=4)
    model = T.init_params(cfg, 0, dev)
    b = SyntheticStream(DataConfig(vocab=cfg.vocab, seq_len=64,
                                   global_batch=4)).batch(0)
    loss, _m, grads = make_grad_fn(cfg)(model, {
        k: torch.from_numpy(v).to(dev, torch.long) for k, v in b.items()})
    per = cfg.n_layers // 2
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
    for k, g in grads.items():
        g = g.float().cpu().numpy()
        stage = int(k.split(".")[1]) // per if k.startswith("blocks.") \
            else 0
        np.testing.assert_allclose(ranks[stage]["g:" + k], g, rtol=0,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=k)
        if k.startswith("blocks."):
            assert not ranks[1 - stage]["g:" + k].any(), k
    assert not any(build.launch_counts().values())


def test_comm_stages_cuda_tensors_through_gloo(dev, tmp_path):
    """A world of two gloo ranks holding CUDA tensors: all_reduce (SUM,
    MAX, int32) and the ring shift give the right values on the card."""
    from _torch_dist import run_ranks
    script = r'''
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.train import comm
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
dev = torch.device("cuda", 0)
s = comm.all_reduce(torch.full((5,), rank + 1.0, device=dev))
m = comm.all_reduce(torch.tensor(float(rank), device=dev), dist.ReduceOp.MAX)
i = comm.all_reduce(torch.full((3,), rank + 2, dtype=torch.int32, device=dev))
r = comm.ring_shift(torch.full((2,), float(rank), device=dev))
assert s.is_cuda and r.is_cuda
np.savez(out + f"/rank{rank}.npz", s=s.cpu().numpy(), m=m.cpu().numpy(),
         i=i.cpu().numpy(), r=r.cpu().numpy())
dist.destroy_process_group()
'''
    got = run_ranks(script, 2, tmp_path)
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["s"], np.full(5, 3.0, np.float32))
        assert float(g["m"]) == 1.0
        np.testing.assert_array_equal(g["i"], np.full(3, 5, np.int32))
        np.testing.assert_array_equal(g["r"], np.full(2, 1.0 - rank,
                                                      np.float32))
