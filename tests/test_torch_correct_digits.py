"""The divmod finalization with the finalization kernel's digit-GEMM
product, against the JAX package and Python ints, bit for bit; and the
divmod width check.

The finalization kernel (`csrc/correct.cu`: `correct_kernel`) clips
each operand of its two products to its significant limbs and computes
them by the schedule that `digitmma.digit_columns_plain` emulates on
the CPU (the same digit windows, k clipping, s32 flushes and split over
a cluster): p = u * si to min(2W, prec(u) + prec(si), h + W) limbs (q
reads p below limb h + W only), then v * q to min(W, prec(q) + prec(v))
limbs.

Here the plain composition `fused.correct_reference` runs with that
product, lane by lane, for every cluster size, and must equal JAX
`ops.fused_correct(..., impl="blocked")` (vmapped, as
tests/test_torch_kernels.py runs it) and a Python-int model of the
finalization, and, on every lane whose si is a valid shifted inverse
(floor(B^h / v) + lambda, lambda in {0, 1}, h = prec(u), with v times
the estimate inside W limbs), Python `divmod`.  The lanes cover an all-0xFFFF u, v = B^k, one-limb v, u < v,
v = 0, u = 0, si = floor(B^h / v) + lambda for lambda in {-1, 0, +1}
(so that both the delta = -1 and the delta = +1 correction run), h = 0,
h = 2W, a small h whose q is cut at W limbs, and random lanes.
Operands come from numpy with a fixed seed; tolerance: exact equality.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.kernels import ops as JK
from repro_torch.core import arith as A
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import digitmma as D
from repro_torch.kernels import fused as F
from repro_torch.kernels import ops as K

B = bi.BASE
WIDTHS = (8, 16, 32, 48)
CLUSTERS = (1, 2, 4, 8)


def _prec(x: int) -> int:
    return -(-x.bit_length() // 16)


def _rand(rng, limbs: int) -> int:
    return bi.to_int(rng.integers(0, B, limbs, dtype=np.uint32))


def _lanes(width: int):
    """(u, v, si, h, valid) per lane: crafted lanes for each branch of
    the finalization, then random ones.  `valid` marks a lane where the
    result must be Python's divmod: v = 0, or si = floor(B^h / v) +
    lambda at h = prec(u) with lambda = 0, or lambda = 1 and u + v <
    B^W (so that the estimate's v * (q + 1) fits W limbs, as the PAD
    limbs of divmod_batch make sure)."""
    rng = np.random.default_rng(width)
    top = B ** width - 1
    lanes = []

    def inv(u, v, lam=0):
        """A lane with si = floor(B^h / v) + lam at h = prec(u)."""
        h = _prec(u)
        si = B ** h // v + lam
        assert 0 <= si <= top
        lanes.append((u, v, si, h, lam == 0 or (lam == 1 and u + v <= top)))

    def lane(u, v, si, h):
        lanes.append((u, v, si, h, v == 0))

    inv(top, _rand(rng, width // 2) | B ** (width // 2 - 1))   # 0xFFFF u
    inv(top, top)                                        # u == v
    inv(_rand(rng, width - 1), B ** (width // 3))        # v = B^k
    inv(_rand(rng, width - 1), int(rng.integers(2, B)), 1)   # one limb
    inv(_rand(rng, width - 1), 3)
    inv(_rand(rng, width // 4), _rand(rng, width // 2) | B ** (width // 2 - 1))
    lane(_rand(rng, width), 0, _rand(rng, width), width)     # v = 0
    lane(top, 0, 0, 0)
    inv(0, _rand(rng, width // 2) | 1)                   # u = 0
    lane(0, _rand(rng, 3), _rand(rng, width), width // 2)
    # around the true inverse: u = k v (delta = +1 where q comes out
    # low) and u = k v - 1 (delta = -1 where it comes out high)
    for lam in (-1, 0, 1):
        for j in range(2):
            v = _rand(rng, int(rng.integers(2, width // 2 + 1))) | 1
            k = top // v - int(rng.integers(0, 1000))
            inv(k * v - (lam == 1 or j), v, lam)
    lane(_rand(rng, width), _rand(rng, 3), _rand(rng, width), 0)   # h = 0
    lane(_rand(rng, width), _rand(rng, 2), _rand(rng, width), 2 * width)
    lane(top, _rand(rng, width // 2), top, 2)            # q cut at W
    for _ in range(6):
        lane(_rand(rng, width), _rand(rng, int(rng.integers(1, width + 1))),
             _rand(rng, width), int(rng.integers(0, 2 * width + 1)))
    for _ in range(4):
        v = _rand(rng, int(rng.integers(1, width))) | 1
        inv(_rand(rng, width - 1), v, int(rng.integers(0, 2)))
    return lanes


def _model(u, v, si, h, width):
    """The finalization on Python ints, with the correction it took."""
    bw = B ** width
    q = ((u * si) >> (16 * h)) % bw
    mm = v * q % bw
    neg = u < mm
    if neg:
        q, mm = (q - 1) % bw, (mm - v) % bw
    r = (u - mm) % bw
    pos = r >= v
    if pos:
        q, r = (q + 1) % bw, (r - v) % bw
    if v == 0:
        return 0, u, "v=0"
    return q, r, {(False, False): "0", (True, False): "-1",
                  (False, True): "+1", (True, True): "-1+1"}[(neg, pos)]


@functools.lru_cache(maxsize=None)
def _case(width: int):
    """The lanes as torch tensors, JAX blocked's (q, r) and the model's."""
    lanes = _lanes(width)
    cols = list(zip(*lanes))
    u, v, si = (JB.batch_from_ints(list(c), width) for c in cols[:3])
    hs = np.asarray(cols[3], np.int32)
    fn = jax.jit(jax.vmap(lambda a, b, c, d: JK.fused_correct(
        a, b, c, h=d, impl="blocked")))
    jq, jr = fn(jnp.asarray(u), jnp.asarray(v), jnp.asarray(si),
                jnp.asarray(hs))
    want = (np.asarray(jq).astype(np.int64), np.asarray(jr).astype(np.int64))
    t = dict(u=bi.limbs_from_numpy(u, "cpu"), v=bi.limbs_from_numpy(v, "cpu"),
             si=bi.limbs_from_numpy(si, "cpu"), h=torch.from_numpy(hs))
    model = [_model(*ln[:4], width) for ln in lanes]
    return lanes, t, want, model


def _kernel_product(cluster: int, h: torch.Tensor, width: int):
    """The finalization kernel's product as a `mul` for
    `correct_reference`: per lane, both operands clipped to their
    significant limbs and the digit-GEMM schedule on `cluster` blocks
    (s32 flushes every 32 digits), to prec(a) + prec(b) limbs, the
    double-width u * si also cut at h + W; zero above."""
    def mul(a, b, out_width):
        out = torch.zeros(a.shape[0], out_width, dtype=torch.int32)
        pa, pb = A.prec(a).tolist(), A.prec(b).tolist()
        for i in range(a.shape[0]):
            n = min(pa[i] + pb[i], out_width) if pa[i] and pb[i] else 0
            if out_width == 2 * width:            # p = u * si
                n = max(0, min(n, int(h[i]) + width))
            if n:
                col = D.digit_columns_plain(
                    a[i:i + 1, :pa[i]], b[i:i + 1, :pb[i]], n,
                    cluster=cluster, k_chunk=32)
                out[i, :n] = K.resolve_columns(col)[0]
        return out
    return mul


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("width", WIDTHS)
def test_correct_with_kernel_product_matches_jax(width, cluster):
    lanes, t, want, model = _case(width)
    q, r = F.correct_reference(t["u"], t["v"], t["si"], h=t["h"],
                               mul=_kernel_product(cluster, t["h"], width))
    np.testing.assert_array_equal(q.numpy().astype(np.int64), want[0])
    np.testing.assert_array_equal(r.numpy().astype(np.int64), want[1])
    qs, rs = bi.batch_to_ints(q), bi.batch_to_ints(r)
    assert list(zip(qs, rs)) == [(mq, mr) for mq, mr, _ in model]
    for (u, v, _, _, valid), qq, rr in zip(lanes, qs, rs):
        if valid:
            assert (qq, rr) == (divmod(u, v) if v else (0, u))


@pytest.mark.parametrize("width", WIDTHS)
def test_lanes_cover_every_branch(width):
    """Each width's lanes take both corrections, none, and the v = 0
    lane; h runs from 0 to 2W."""
    lanes, t, _, model = _case(width)
    branches = {br for _, _, br in model}
    assert {"0", "-1", "+1", "v=0"} <= branches
    assert int(t["h"].min()) == 0 and int(t["h"].max()) == 2 * width
    assert sum(valid for *_, valid in lanes) >= 10


@pytest.mark.parametrize("width", WIDTHS)
def test_cut_product_gives_the_same_finalization(width):
    """u * si cut at h + W limbs gives the finalization of the whole
    double-width product, and the cut removes limbs on some lane."""
    _, t, _, _ = _case(width)
    args = (t["u"], t["v"], t["si"])
    full = F.correct_reference(*args, h=t["h"])
    cut = F.correct_reference(*args, h=t["h"],
                              mul=_kernel_product(1, t["h"], width))
    assert torch.equal(cut[0], full[0]) and torch.equal(cut[1], full[1])
    np_full = A.prec(t["u"]) + A.prec(t["si"])
    assert (t["h"] + width < np_full).any()


def test_divmod_width_check():
    """No cap on the CPU or under cuda_pairs and blocked; on CUDA a
    working width past the digit product's column-sum contract raises
    for cuda_fused and cuda_batched before any library is built (on a
    machine without nvcc a build would raise BuildError instead)."""
    cuda = torch.device("cuda")
    for impl in (*K.IMPLS, None):
        S.check_width("cpu", 40000, impl)
        S.check_width("cpu", 100000, impl)
    too_wide = D.MAX_LIMBS - S.PAD + 1
    for impl in ("cuda_fused", "cuda_batched", None):
        with pytest.raises(ValueError, match="column-sum contract"):
            S.check_width(cuda, too_wide, impl)
    for impl in ("cuda_pairs", "blocked"):
        S.check_width(cuda, too_wide, impl)
    with pytest.raises(ValueError, match="unknown impl"):
        S.check_width("cpu", 8, "pallas")


def test_divmod_checks_width_before_anything_runs(monkeypatch):
    """divmod_batch asks check_width with its device, width and impl
    first: a refusal leaves nothing launched or computed."""
    seen = []

    class Refused(Exception):
        pass

    def refuse(device, m, impl=None):
        seen.append((torch.device(device).type, m, impl))
        raise Refused

    def never(*a, **k):
        raise AssertionError("ran after a refused width check")

    monkeypatch.setattr(S, "check_width", refuse)
    monkeypatch.setattr(K, "fused_step", never)
    monkeypatch.setattr(K, "fused_correct", never)
    z = torch.ones(2, 5, dtype=torch.int32)
    with pytest.raises(Refused):
        S.divmod_batch(z, z, impl="cuda_batched")
    assert seen == [("cpu", 5, "cuda_batched")]


def test_service_checks_width_at_construction(monkeypatch):
    """BigintDivisionService refuses at construction a width its impl
    cannot run on the card (here past the column-sum contract, which
    needs no library), and takes it under cuda_pairs or on the CPU."""
    from repro_torch.serving.bigint_service import BigintDivisionService
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    too_wide = D.MAX_LIMBS
    for impl in (None, "cuda_batched"):
        with pytest.raises(ValueError, match="column-sum contract"):
            BigintDivisionService(m_limbs=too_wide, device="cuda", impl=impl)
    BigintDivisionService(m_limbs=too_wide, device="cuda", impl="cuda_pairs")
    BigintDivisionService(m_limbs=too_wide, device="cpu")
