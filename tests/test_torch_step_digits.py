"""The Refine step with the step kernels' digit-GEMM product, against
the JAX package, bit for bit.

The step kernels (`csrc/step.cu`: `powdiff_kernel`, `update_kernel`)
clip each operand of their product to its significant limbs, take the
longer one as the digit GEMM's window A and the shorter as its Toeplitz
band B, and compute the product by the schedule that
`digitmma.digit_columns_plain` emulates on the CPU (the same digit
windows, k clipping, s32 flushes and split over a cluster).  powdiff
keeps all prec(vp) + prec(wq) limbs of its product; update reads its
product only below limb max(h - 2m, 0) + win, so it stops there.

Here the plain compositions (`fused.powdiff_reference`,
`update_reference`) run with that product, lane by lane, for every
cluster size, and must equal JAX `ops.fused_step(..., impl="blocked")`
(vmapped, as tests/test_torch_kernels.py runs it) and a Python-int model
of the step.  The states cover zero and all-0xFFFF operands, both signs
of the full branch, the close branch with P == 0, with a zero top limb
and with B^L - P, dropped limbs under the floor correction, and
inactive lanes.  Operands come from numpy with a fixed seed; tolerance:
exact equality.
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
from repro_torch.kernels import digitmma as D
from repro_torch.kernels import fused as F
from repro_torch.kernels import ops as K

B = bi.BASE
G = 2                 # guard digits of the Refine loop
PAD = 8               # full width = window + PAD
WINDOWS = (8, 16, 32, 48)
CLUSTERS = (1, 2, 4, 8)


def _prec(x: int) -> int:
    return -(-x.bit_length() // 16)


def _rand(rng, limbs: int) -> int:
    return bi.to_int(rng.integers(0, B, limbs, dtype=np.uint32))


def _states(win: int):
    """(v, w, h, m, l, s, active) per lane: crafted lanes for each branch
    of the step, then random ones."""
    rng = np.random.default_rng(win)
    q = max(3, win // 4)
    lanes = []

    def lane(v, w, h, m=0, l=2, s=0, act=True):
        lanes.append((v, w, h, m, l, s, act))

    top = B ** win - 1
    lane(B ** (win + PAD) - 1, top, win)                 # all-0xFFFF
    lane(0, _rand(rng, win), win)                        # v = 0
    lane(_rand(rng, win), 0, win, m=1)                   # w = 0
    lane(top, top, 2 * win - 1, m=1, l=3, s=1)           # full, p > B^h
    hi = B ** (q - 1)
    lane(_rand(rng, q) | hi, _rand(rng, q) | hi, 2 * q)  # full, p < B^h
    # the close branch (l = 5, so L = prec(vp) + prec(wq) - 2 < hpd)
    lane(B ** (q - 1), B ** (q - 1), win, l=5)           # P == 0
    lane(B ** (q - 1) + 1, B ** (q - 1), win, l=5)       # top limb of P 0
    lane(_rand(rng, q), _rand(rng, q), win, l=5)         # B^L - P
    lane(_rand(rng, q) | 1, _rand(rng, q), win, l=4, m=1)
    for i in range(11):
        m = int(rng.integers(0, 4))
        lane(_rand(rng, win + PAD), _rand(rng, int(rng.integers(1, win + 1))),
             int(rng.integers(m + 1, 2 * win)), m=m,
             l=int(rng.integers(2, 6)), s=int(rng.integers(0, 3)),
             act=i % 4 != 3)
    return lanes


def _step_int(v, w, h, m, l, s, act, win):
    """One Refine step on Python ints (powdiff then update), with the
    branch each lane took: the model the kernels and JAX must meet."""
    bw = B ** win
    vp, wq = (v >> (16 * s)) % bw, w % bw
    pv, pw = _prec(vp), _prec(wq)
    hpd, L = h - m, pv + pw - (l - G) + 1
    p = vp * wq
    if p == 0:
        sign, x, br = hpd >= 0, B ** hpd % bw if hpd < win else 0, "vwz"
    elif L >= hpd:
        sign = _prec(p) <= hpd
        x = (B ** hpd - p) % bw if sign else (p - B ** hpd) % bw
        br = "full+" if sign else "full-"
    else:
        P = p % B ** max(0, min(L, win))
        ptop = (P >> (16 * (L - 1))) % B if 0 <= L - 1 < win else 0
        sign = P == 0 or ptop != 0
        if P == 0:
            x, br = 0, "close P=0"
        elif ptop == 0:
            x, br = P, "close top=0"
        else:
            x, br = (B ** L - P) % bw, "close B^L-P"
    tmp = wq * x
    off = h - 2 * m
    if off >= 0:
        sh, dropped = (tmp >> (16 * off)) % bw, tmp % B ** off != 0
    else:
        sh, dropped = (tmp << (-16 * off)) % bw, False
    wm = (wq << (16 * m)) % bw
    res = (wm + sh) % bw if sign else (wm - sh - dropped) % bw
    return (res >> 16 if act else w), br, dropped and not sign


@functools.lru_cache(maxsize=None)
def _case(win: int):
    """The states as numpy limbs and torch tensors, JAX blocked's step
    and the Python-int model's."""
    lanes = _states(win)
    full_w = win + PAD
    cols = list(zip(*lanes))
    v = JB.batch_from_ints(list(cols[0]), full_w)
    w = JB.batch_from_ints(list(cols[1]), full_w)
    sc = {k: np.asarray(c, np.int32) for k, c in zip("hmls", cols[2:6])}
    act = np.asarray(cols[6])
    fn = jax.jit(jax.vmap(
        lambda vv, ww, hh, mm, ll, ss, aa: JK.fused_step(
            vv, ww, h=hh, m=mm, l=ll, s=ss, active=aa, g=G, win=win,
            impl="blocked")))
    want = np.asarray(fn(jnp.asarray(v), jnp.asarray(w),
                         *(jnp.asarray(sc[k]) for k in "hmls"),
                         jnp.asarray(act))).astype(np.int64)
    model = [_step_int(*ln, win) for ln in lanes]
    t = dict(v=bi.limbs_from_numpy(v, "cpu"), w=bi.limbs_from_numpy(w, "cpu"),
             active=torch.from_numpy(act),
             **{k: torch.from_numpy(c) for k, c in sc.items()})
    return t, want, model


def _kernel_product(cluster: int, cut=None):
    """The step kernels' product as a `mul` for the plain compositions:
    per lane, both operands clipped to their significant limbs and the
    digit-GEMM schedule on `cluster` blocks (s32 flushes every 32
    digits), to prec(u) + prec(v) limbs or, with `cut` (batch,), to
    min(prec(u) + prec(v), cut) limbs; zero above."""
    def mul(u, v, out_width):
        out = torch.zeros(u.shape[0], out_width, dtype=torch.int32)
        pu, pv = A.prec(u).tolist(), A.prec(v).tolist()
        for i in range(u.shape[0]):
            n = pu[i] + pv[i] if pu[i] and pv[i] else 0
            n = min(n, out_width, *([int(cut[i])] if cut is not None else []))
            if n:
                col = D.digit_columns_plain(
                    u[i:i + 1, :pu[i]], v[i:i + 1, :pv[i]], n,
                    cluster=cluster, k_chunk=32)
                out[i, :n] = K.resolve_columns(col)[0]
        return out
    return mul


def _update_cut(t, win):
    """update's product stops at limb max(h - 2m, 0) + win."""
    return torch.clamp(t["h"] - 2 * t["m"], min=0) + win


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("win", WINDOWS)
def test_step_with_kernel_product_matches_jax(win, cluster):
    t, want, model = _case(win)
    hpd, lpd = t["h"] - t["m"], t["l"] - G
    sign, x = F.powdiff_reference(t["v"], t["w"], hpd, lpd, t["s"], win=win,
                                  mul=_kernel_product(cluster))
    got = F.update_reference(
        t["w"], x, sign, t["h"], t["m"], t["active"], win=win,
        mul=_kernel_product(cluster, _update_cut(t, win)))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert bi.batch_to_ints(got) == [out for out, _, _ in model]


@pytest.mark.parametrize("win", WINDOWS)
def test_states_cover_every_branch(win):
    """Each window's states take every branch of powdiff's select, the
    floor correction and the inactive-lane copy."""
    t, _, model = _case(win)
    branches = {br for _, br, _ in model}
    assert branches == {"vwz", "full+", "full-", "close P=0",
                        "close top=0", "close B^L-P"}
    assert any(dropped for _, _, dropped in model)
    assert not t["active"].all()


@pytest.mark.parametrize("win", WINDOWS)
def test_update_truncated_product_gives_the_same_step(win):
    """update's product cut at max(h - 2m, 0) + win limbs gives the
    output of the whole 2 * win-limb product, and the cut removes limbs
    on some lanes."""
    t, _, _ = _case(win)
    hpd, lpd = t["h"] - t["m"], t["l"] - G
    sign, x = F.powdiff_reference(t["v"], t["w"], hpd, lpd, t["s"], win=win)
    args = (t["w"], x, sign, t["h"], t["m"], t["active"])
    cut = _update_cut(t, win)
    full = F.update_reference(*args, win=win)
    assert torch.equal(F.update_reference(
        *args, win=win, mul=_kernel_product(1, cut)), full)
    np_full = A.prec(t["w"][:, :win]) + A.prec(x[:, :win])
    assert (cut < np_full).any()
