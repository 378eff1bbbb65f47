"""The division's set-up: `core/shinv.py:prologue_plain` (the ATen
version the CPU and every impl but cuda_fused run) against a lane-by-lane
model in Python ints of the arithmetic `kernels/csrc/prologue.cu` does
(one pass of statistics over v, u and 2v mod B^W, then the lane's scalar
work), on the edge lanes of `tests/_prologue_lanes.py`; and the set-up's
launch count per impl.  The kernel itself runs on the card only
(`tests/test_torch_cuda.py`)."""

from __future__ import annotations

import pytest
import torch

from _prologue_lanes import divmod_lanes, shinv_lanes
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import fused as F
from repro_torch.kernels import ops as K
from repro_torch.obs import costmodel as CM

MASK = 0xFFFF


def _wrap(x: int) -> int:
    """x as an int32, wrapped as torch's int32 arithmetic wraps."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _eq_pow(prec, nnz, one, p, width):
    return nnz == 1 and one and prec - 1 == p if 0 <= p < width \
        else prec == 0


def kernel_model(v: list[int], u: list[int] | None, h: int | None,
                 width: int):
    """One lane of csrc/prologue.cu: v (and u) of in_w limbs, the working
    width W.  Returns (uw, vw, vl, w, scal, flags) as lists."""
    in_w = len(v)
    pu = max((i + 1 for i, x in enumerate(u) if x), default=0) \
        if u is not None else 0
    # the pass: v's top limb and the one below, nonzero count, a limb 1;
    # the same of t = 2v mod B^W, limb i from v[i] and v[i - 1]
    vtop = nv = onev = pt = nt = onet = 0
    for i, x in enumerate(v):
        p = v[i - 1] if i else 0
        if x:
            nv, onev = min(nv + 1, 2), onev or x == 1
            vtop = (i + 1) << 32 | x << 16 | p
        t = ((x << 1) & MASK) | (p >> 15)
        if t:
            pt, nt, onet = i + 1, min(nt + 1, 2), onet or t == 1
    if in_w < width and v[-1] >> 15:          # t's limb in_w
        t = v[-1] >> 15
        pt, nt, onet = in_w + 1, min(nt + 1, 2), onet or t == 1
    # the lane's scalar work
    h = pu if u is not None else h
    pv, v0 = vtop >> 32, v[0]
    lift = pv <= 1
    hl = _wrap(h + lift)
    if lift:
        t1, t2 = (v0 << 1) & MASK, v0 >> 15
        pvl, V = (2 if v0 else 0), v0 << 16
        pt, nt, onet = (3 if t2 else 2 if t1 else 0), (t1 != 0) + (t2 != 0), \
            t2 == 1
    else:
        pvl, V = pv, vtop & 0xFFFFFFFF
    k = pvl - 1
    is_pow = nv == 1 and onev
    zero = pvl > hl and not _eq_pow(pvl, nv, onev, hl, width)
    one = pt > hl and not _eq_pow(pt, nt, onet, hl, width) and not zero
    Vc = V or 1
    q1 = ((2 ** 32 - Vc) // Vc + 1) % 2 ** 32
    t, q2 = (2 ** 32 - q1 * Vc) % 2 ** 32, 0
    for _ in range(16):
        t <<= 1
        geq = t >= Vc
        t -= Vc if geq else 0
        q2 = q2 << 1 | geq
    hk = _wrap(hl - k)
    n = _wrap(hk - 1)
    need = 2 + (sum((1 << j) < n for j in range(31)) if n >= 2 else 0)
    pad = [0] * (width - in_w)
    vl = list(v) + pad
    if lift:
        vl[0], vl[1] = 0, v0
    w = [0] * width
    w[S.GUARD:S.GUARD + 3] = [q2 & MASK, q1 & MASK, q1 >> 16]
    return ((list(u) + pad if u is not None else None), list(v) + pad, vl,
            w, (h, k, hk, need, 2), (zero, one, is_pow))


def _rows(t: torch.Tensor) -> list[list[int]]:
    return t.tolist()


def _check_lanes(got, vs, us, hs, width):
    uw, vw, vl, w, scal, flags = got
    scal = torch.stack(list(scal)).T.tolist()
    flags = torch.stack(list(flags)).T.tolist()
    for b, v in enumerate(vs):
        want = kernel_model(v, None if us is None else us[b],
                            None if hs is None else hs[b], width)
        lane = ((None if uw is None else _rows(uw)[b]), _rows(vw)[b],
                _rows(vl)[b], _rows(w)[b], tuple(scal[b]),
                tuple(bool(f) for f in flags[b]))
        assert lane == want, f"lane {b}"


@pytest.mark.parametrize("m", [27, 8, 64])
def test_kernel_arithmetic_matches_plain_divmod_entry(m):
    lanes = divmod_lanes(m, seed=m)
    u = bi.limbs_from_numpy(bi.batch_from_ints([a for a, _ in lanes], m),
                            "cpu")
    v = bi.limbs_from_numpy(bi.batch_from_ints([b for _, b in lanes], m),
                            "cpu")
    got = S.prologue_plain(v, u=u)
    assert got[0].shape == (len(lanes), m + S.PAD)
    _check_lanes(got, v.tolist(), u.tolist(), None, m + S.PAD)


@pytest.mark.parametrize("width", [35, 18, 2056 // 64])
def test_kernel_arithmetic_matches_plain_shinv_entry(width):
    lanes = shinv_lanes(width, seed=width)
    v = bi.limbs_from_numpy(bi.batch_from_ints([a for a, _ in lanes],
                                               width), "cpu")
    h = torch.tensor([b for _, b in lanes], dtype=torch.int32)
    got = S.prologue_plain(v, h)
    assert got[0] is None and got[1] is v
    _check_lanes(got, v.tolist(), None, h.tolist(), width)


@pytest.mark.parametrize("impl", K.IMPLS)
def test_prologue_launches_per_impl(impl):
    """One set-up launch under cuda_fused, none under the impls that run
    the set-up in torch ops; apart from the JAX-equal counts."""
    assert CM.prologue_launches(impl) == (
        CM.PROLOGUE_LAUNCHES if impl == "cuda_fused" else 0)
    assert CM.PROLOGUE_LAUNCHES == 1
    assert CM.divmod_launches(2048, impl) + CM.prologue_launches(impl) == \
        {"cuda_fused": 28, "cuda_batched": 28, "cuda_pairs": 28,
         "blocked": 0}[impl]


def test_prologue_kernel_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only, and checks its operands
    before building anything."""
    v = torch.zeros(2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        F.prologue_cuda(v, u=v)
    with pytest.raises(ValueError, match="u or h"):
        F.prologue_cuda(v)
