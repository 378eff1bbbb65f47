"""The port's Barrett arithmetic (`repro_torch.core.modarith`, the plain
`kernels.fused.barrett_reference`) against the JAX package's
`impl="blocked"` functions and Python's `%` and `pow`, bit for bit.

JAX compiles every new shape again (10-20 s each here), so each modulus
width runs ONE jitted JAX program, in a module-scoped fixture, that
computes every function under test on one 16-lane batch; the port's
sub-batches of 1, 5 and 16 are compared with the matching rows.  Lanes
are independent, so a sub-batch must reproduce its rows bit for bit.
m = 4 runs every function; m = 26 (W = 62, so the precompute runs
windows of 32 < W) runs the precompute and the shared functions.  A
JAX per-lane precompute compiles for about 20 s at m = 26 and each
`*_batch` function compiles its own, so at m = 26 the port's `*_batch`
functions are held to Python's `%` only.
Tolerance: exact equality.
"""

import functools
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.core import modarith as JM
from repro.kernels import fused as JF
from repro.obs import costmodel as JCM
from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.kernels import fused as F
from repro_torch.kernels import ops as K
from repro_torch.obs import costmodel as CM


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
N = 16
E_LIMBS = {4: 2, 26: 1}
SUB = [(0, 1), (11, 5), (0, 16)]          # (first row, rows) of a sub-batch


def _lanes(m, seed):
    """16 lanes of (v, x, a, b, e): edge moduli (1, B^k, all-0xFFFF,
    one limb, 3) and edge operands (B^(2m) - 1, x < v, x a multiple of
    v, 0, all-0xFFFF) beside random ones; x < B^(2m)."""
    rnd = random.Random(seed)
    el = E_LIMBS[m]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(N)]
    vs[:8] = [1, B ** (m - 1), B ** m - 1, 0xFFFF, 3, B ** (m // 2),
              rnd.randint(B ** (m - 1), B ** m - 1), 0x10001]
    xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(N)]
    xs[:6] = [B ** (2 * m) - 1, B ** (2 * m) - 1, 5,
              vs[3] * rnd.randint(1, B ** m), 0, vs[5] - 1]
    xs[6] = (B ** (2 * m) - 1) // vs[6] * vs[6]
    a = [rnd.randint(0, B ** m - 1) for _ in range(N)]
    a[:3] = [B ** m - 1, 0, 1]
    b = [rnd.randint(0, B ** m - 1) for _ in range(N)]
    b[:2] = [B ** m - 1, B ** m - 1]
    e = [rnd.randint(0, B ** el - 1) for _ in range(N)]
    e[:4] = [B ** el - 1, 0, 1, B ** el - 1]
    return dict(v=vs, x=xs, a=a, b=b, e=e, vshared=vs[6])


def _barrett_cases(m, seed):
    """Barrett core operands at W = barrett_width(m) with a valid mu
    (shinv_h(v) + lambda, computed here) on most lanes and arbitrary mu
    on two: lanes built to take `over` (lambda = 1, x = k v - 1 near
    B^(2m)) and `under` (lambda = 0, x a multiple of v)."""
    rnd = random.Random(seed)
    h = MA.barrett_h(m)
    vs, mus, xs = [], [], []
    for i in range(N):
        v = rnd.randint(B ** (m - 1), B ** m - 1)
        lam = i % 2
        k = (B ** (2 * m) - 1) // v - rnd.randint(0, 3)
        x = [k * v - 1, k * v, rnd.randint(0, B ** (2 * m) - 1)][i % 3]
        vs.append(v)
        mus.append(B ** h // v + lam)
        xs.append(x)
    mus[-2] = rnd.randint(0, B ** MA.barrett_width(m) - 1)
    mus[-1] = 0
    return vs, mus, xs


def _np(xs, w):
    return JB.batch_from_ints(xs, w)


def _t(xs, w):
    return bi.limbs_from_numpy(JB.batch_from_ints(xs, w), "cpu")


def _jax_program(m, with_all):
    h, W = JM.barrett_h(m), JM.barrett_width(m)

    @jax.jit
    def run(x, a, b, e, v, vshared, bx, bmu, bv):
        ctx = JM.barrett_precompute(vshared, impl="blocked")
        out = dict(ctx_v=ctx.v, ctx_mu=ctx.mu, ctx_k=ctx.k,
                   reduce_shared=JM.reduce_shared(ctx, x, impl="blocked"),
                   modmul_shared=JM.modmul_shared(ctx, a, b,
                                                  impl="blocked"),
                   modexp_shared=JM.modexp_shared(ctx, a, e,
                                                  impl="blocked"))
        if with_all:
            out["reduce_batch"] = JM.reduce_batch(x, v, impl="blocked")
            out["modmul_batch"] = JM.modmul_batch(a, b, v, impl="blocked")
            out["modexp_batch"] = JM.modexp_batch(a, e, v, impl="blocked")
            out["barrett"] = jax.vmap(functools.partial(
                JF.barrett_reference, h=h, impl="blocked"))(bx, bmu, bv)
        return out

    return run, W


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX function under test, once per modulus width."""
    out = {}
    for m in (4, 26):
        L = _lanes(m, m)
        bvs, bmus, bxs = _barrett_cases(m, m + 1)
        run, W = _jax_program(m, with_all=m == 4)
        args = [jnp.asarray(a) for a in (
            _np(L["x"], 2 * m), _np(L["a"], m), _np(L["b"], m),
            _np(L["e"], E_LIMBS[m]), _np(L["v"], m),
            _np([L["vshared"]], m)[0], _np(bxs, W), _np(bmus, W),
            _np(bvs, W))]
        # integer programs: XLA's optimization level changes no bit, and
        # level 0 compiles in about two thirds of the time
        res = run.lower(*args).compile(
            {"xla_backend_optimization_level": 0})(*args)
        out[m] = (L, (bvs, bmus, bxs), {k: np.asarray(r)
                                        for k, r in res.items()})
    return out


def _rows(L, key, lo, n, w):
    return _t(L[key][lo:lo + n], w)


def _eq(want, got):
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy().astype(np.int64))


@pytest.mark.parametrize("lo,n", SUB)
@pytest.mark.parametrize("m", [4, 26])
def test_reduce_and_modmul_batch_match_jax(jax_runs, m, lo, n):
    L, _, J = jax_runs[m]
    v = _rows(L, "v", lo, n, m)
    r = MA.reduce_batch(_rows(L, "x", lo, n, 2 * m), v)
    if m == 4:
        _eq(J["reduce_batch"][lo:lo + n], r)
    assert bi.batch_to_ints(r) == [x % y for x, y in zip(
        L["x"][lo:lo + n], L["v"][lo:lo + n])]
    p = MA.modmul_batch(_rows(L, "a", lo, n, m), _rows(L, "b", lo, n, m), v)
    if m == 4:
        _eq(J["modmul_batch"][lo:lo + n], p)
    assert bi.batch_to_ints(p) == [x * y % z for x, y, z in zip(
        L["a"][lo:lo + n], L["b"][lo:lo + n], L["v"][lo:lo + n])]


@pytest.mark.parametrize("lo,n", SUB)
def test_modexp_batch_matches_jax(jax_runs, lo, n):
    m = 4
    L, _, J = jax_runs[m]
    got = MA.modexp_batch(_rows(L, "a", lo, n, m),
                          _rows(L, "e", lo, n, E_LIMBS[m]),
                          _rows(L, "v", lo, n, m))
    _eq(J["modexp_batch"][lo:lo + n], got)
    assert bi.batch_to_ints(got) == [pow(x, y, z) for x, y, z in zip(
        L["a"][lo:lo + n], L["e"][lo:lo + n], L["v"][lo:lo + n])]


@pytest.mark.parametrize("m", [4, 26])
def test_precompute_matches_jax(jax_runs, m):
    """The port's own context equals the JAX one, limb for limb, and mu
    is shinv_h(v) + lambda with lambda in {0, 1}."""
    L, _, J = jax_runs[m]
    ctx = MA.barrett_precompute(_t([L["vshared"]], m)[0])
    assert ctx.shared and ctx.mu.shape == (MA.barrett_width(m),)
    _eq(J["ctx_mu"], ctx.mu)
    _eq(J["ctx_v"], ctx.v)
    assert int(ctx.k) == int(J["ctx_k"])
    mu = bi.to_int(bi.limbs_to_numpy(ctx.mu))
    assert mu - B ** MA.barrett_h(m) // L["vshared"] in (0, 1)
    per_lane = MA.barrett_precompute(_t(L["v"], m))
    assert per_lane.mu.shape == (N, MA.barrett_width(m))
    assert [int(k) for k in per_lane.k] == [
        -(-v.bit_length() // 16) for v in L["v"]]


@pytest.mark.parametrize("lo,n", SUB)
@pytest.mark.parametrize("m", [4, 26])
def test_shared_match_jax_with_carried_context(jax_runs, m, lo, n):
    """reduce/modmul/modexp_shared against the JAX context's own mu,
    carried over by `context_from_numpy`."""
    L, _, J = jax_runs[m]
    ctx = MA.context_from_numpy(J["ctx_v"], J["ctx_mu"], J["ctx_k"], "cpu")
    vsh = L["vshared"]
    r = MA.reduce_shared(ctx, _rows(L, "x", lo, n, 2 * m))
    _eq(J["reduce_shared"][lo:lo + n], r)
    assert bi.batch_to_ints(r) == [x % vsh for x in L["x"][lo:lo + n]]
    a, b = _rows(L, "a", lo, n, m), _rows(L, "b", lo, n, m)
    p = MA.modmul_shared(ctx, a, b)
    _eq(J["modmul_shared"][lo:lo + n], p)
    e = _rows(L, "e", lo, n, E_LIMBS[m])
    got = MA.modexp_shared(ctx, a, e)
    _eq(J["modexp_shared"][lo:lo + n], got)
    assert bi.batch_to_ints(got) == [pow(x, y, vsh) for x, y in zip(
        L["a"][lo:lo + n], L["e"][lo:lo + n])]


@pytest.mark.parametrize("shared_mu", [False, True])
def test_barrett_reference_matches_jax(jax_runs, shared_mu):
    """The plain Barrett core against JAX `barrett_reference` under
    vmap, on lanes that take `over`, `under`, neither, and two with an
    arbitrary mu; a shared (W,) mu and v give the rows of the
    per-lane call."""
    m = 4
    _, (vs, mus, xs), J = jax_runs[m]
    W, h = MA.barrett_width(m), MA.barrett_h(m)
    x, mu, v = _t(xs, W), _t(mus, W), _t(vs, W)
    r, over, under = F.barrett_branches(x, mu, v, h=h)
    _eq(J["barrett"], r)
    assert torch.equal(F.barrett_reference(x, mu, v, h=h), r)
    valid = slice(0, N - 2)                     # the last two: arbitrary mu
    assert over[valid].any() and under[valid].any()
    assert not (over & under)[valid].any()
    for i, (xx, vv) in enumerate(zip(xs[:-2], vs[:-2])):
        assert bi.to_int(bi.limbs_to_numpy(r[i])) == xx % vv
    if shared_mu:
        # lane 3's valid mu and v for every lane, x and v cut to 2m and
        # m limbs
        i = 3
        got = F.barrett_reference(x[:, :2 * m], mu[i], v[i, :m], h=h)
        want = F.barrett_reference(
            x, mu[i:i + 1].expand(N, W), v[i:i + 1].expand(N, W), h=h)
        assert torch.equal(got, want)
        assert bi.batch_to_ints(got) == [xx % vs[i] for xx in xs]


def test_reduce_property_against_python():
    """Random x < B^(2m) (never wider: the JAX suite's property test
    draws past B^(2m)) and random moduli of every length, m = 8."""
    rnd = random.Random(8)
    m, n = 8, 64
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(n)]
    xs = [rnd.randint(0, B ** rnd.randint(1, 2 * m) - 1) for _ in range(n)]
    r = MA.reduce_batch(_t(xs, 2 * m), _t(vs, m))
    assert bi.batch_to_ints(r) == [x % v for x, v in zip(xs, vs)]


def test_reduce_rejects_wide_x_and_bad_window():
    ctx = MA.barrett_precompute(_t([12345], 4)[0])
    with pytest.raises(ValueError, match="reduce handles <= 8"):
        MA.reduce_shared(ctx, torch.zeros(2, 9, dtype=torch.int32))
    a = _t([3, 4], 4)
    for w in (3, 5, 16 + 1):
        with pytest.raises(ValueError, match="window_bits must divide"):
            MA.modexp_shared(ctx, a, _t([5, 6], 1), window_bits=w)
    per_lane = MA.barrett_precompute(_t([7, 9], 4))
    with pytest.raises(ValueError, match="shared context"):
        MA.reduce_shared(per_lane, _t([1, 2], 8))
    # windows other than 4 agree with pow as well
    for w in (1, 2, 8):
        got = MA.modexp_shared(ctx, a, _t([5, 65535], 1), window_bits=w)
        assert bi.batch_to_ints(got) == [pow(3, 5, 12345),
                                         pow(4, 65535, 12345)]


@pytest.mark.parametrize("w", [1, 2, 4, 8])
@pytest.mark.parametrize("e_bits", [16, 64, 256])
def test_costmodel_matches_jax(e_bits, w):
    assert CM.modexp_ladder(e_bits, w) == JCM.modexp_ladder(e_bits, w)
    assert CM.modexp_launches(e_bits, w) == JCM.modexp_launches(
        e_bits, w, impl="pallas_fused")
    assert CM.barrett_launches() == JCM.barrett_launches("pallas_fused")
    assert CM.modmul_launches() == JCM.modmul_launches("pallas_fused")


def test_precompute_model_matches_jax_formula():
    for m in (4, 26, 2048, 4096, 8192):
        h = JM.barrett_h(m)
        assert CM.precompute_iters(m) == \
            math.ceil(math.log2(max(h - 1, 2))) + 2
    assert [CM.precompute_launches(m) for m in (2048, 4096, 8192)] == \
        [30, 32, 34]
    assert CM.modexp_launches(256, 4) == 674
    assert (MA.barrett_h(7), MA.barrett_width(7)) == \
        (JM.barrett_h(7), JM.barrett_width(7))


@pytest.mark.parametrize("e_limbs,w", [(1, 4), (2, 2), (1, 8)])
def test_dispatches_match_costmodel(monkeypatch, e_limbs, w):
    """Each dispatch is one launch on the card: the precompute calls
    `fused_step` precompute_iters times (two launches each), a modexp
    calls `fused_barrett` and `mul_batch` exactly as the model says."""
    calls = []
    for name in ("fused_barrett", "mul_batch", "fused_step"):
        orig = getattr(K, name)

        def counted(*a, _o=orig, _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(K, name, counted)
    m = 4
    ctx = MA.barrett_precompute(_t([0xFFFF0001], m)[0])
    assert 2 * calls.count("fused_step") == CM.precompute_launches(m)
    calls.clear()
    MA.modexp_shared(ctx, _t([2, 3], m), _t([7, 8], e_limbs),
                     window_bits=w)
    lad = CM.modexp_ladder(16 * e_limbs, w)
    assert calls.count("mul_batch") == lad["modmuls"]
    assert calls.count("fused_barrett") == lad["reductions"]
    assert len(calls) == CM.modexp_launches(16 * e_limbs, w)
