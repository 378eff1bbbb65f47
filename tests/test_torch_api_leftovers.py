"""The port's thin counterparts of the last JAX names it lacked, against
the JAX functions on the CPU: `kernels/ops.py:set_default_impl`,
`core/shinv.py:shinv_fixed` and `divmod_fixed` (one instance), and
`core/modarith.py:{reduce,modmul,modexp}_shared_batch`.  Limbs are
compared bit for bit, and against Python ints.  The JAX functions run in
one program at m = 4 limbs (impl "blocked", XLA optimization level 0:
integer programs, the same bits in less compile time)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.core import modarith as JM
from repro.core import shinv as JS
from repro.kernels import ops as JK
from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.core import shinv as S
from repro_torch.kernels import ops as K
from repro_torch.obs.costmodel import PAD, refine_iters

M = 4
B = bi.BASE
# (u, v) pairs: random, v = 0, a one-limb v, v > u, v a power of B
PAIRS = [(random.Random(1).randrange(B ** M), random.Random(2)
          .randrange(1, B ** 3)), (12345678901, 0), (B ** M - 1, 7),
         (5, B ** 3 + 1), (B ** M - 2, B ** 2)]
X = [random.Random(3 + i).randrange(B ** (2 * M)) for i in range(3)]
A = [random.Random(9 + i).randrange(B ** M) for i in range(3)]
E = [random.Random(20 + i).randrange(B) for i in range(3)]
MOD = random.Random(30).randrange(B ** (M - 1), B ** M) | 1


def _np(xs, w):
    return JB.batch_from_ints(xs, w)


@pytest.fixture(scope="module")
def jax_out():
    width = M + PAD

    @jax.jit
    def run(u, v, vw, h, vmod, x, a, e):
        out = {}
        out["q"], out["r"] = jax.vmap(
            lambda u, v: JS.divmod_fixed(u, v, impl="blocked"))(u, v)
        out["si"] = jax.vmap(lambda v, h: JS.shinv_fixed(
            v, h, iters_max=refine_iters(M), impl="blocked"))(vw, h)
        ctx = JM.barrett_precompute(vmod, impl="blocked")
        out.update(ctx_v=ctx.v, ctx_mu=ctx.mu, ctx_k=ctx.k,
                   reduce=JM.reduce_shared_batch(ctx, x, impl="blocked"),
                   modmul=JM.modmul_shared_batch(ctx, a, a[::-1],
                                                 impl="blocked"),
                   modexp=JM.modexp_shared_batch(ctx, a, e, impl="blocked"))
        return out

    us, vs = zip(*PAIRS)
    h = np.array([2 * M - 1, M + 3, M, 2 * M - 1, M + 1], np.int32)
    args = [jnp.asarray(t) for t in (
        _np(us, M), _np(vs, M), _np(vs, width), h, _np([MOD], M)[0],
        _np(X, 2 * M), _np(A, M), _np(E, 1))]
    res = run.lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)
    return h, {k: np.asarray(r) for k, r in res.items()}


def _t(xs, w):
    return bi.limbs_from_numpy(_np(xs, w), "cpu")


def _eq(want, got):
    assert np.array_equal(np.asarray(want, np.int64),
                          got.numpy().astype(np.int64))


def test_divmod_fixed_matches_jax(jax_out):
    _, J = jax_out
    for i, (u, v) in enumerate(PAIRS):
        q, r = S.divmod_fixed(_t([u], M)[0], _t([v], M)[0])
        assert q.shape == r.shape == (M,)
        _eq(J["q"][i], q)
        _eq(J["r"][i], r)
        want = divmod(u, v) if v else (0, u)
        assert (bi.to_int(q.numpy()), bi.to_int(r.numpy())) == want


def test_shinv_fixed_matches_jax(jax_out):
    """h as an int and as a 0-d tensor; v = 0 gives 0."""
    h, J = jax_out
    for i, (_, v) in enumerate(PAIRS):
        vw = _t([v], M + PAD)[0]
        for hh in (int(h[i]), torch.tensor(h[i])):
            got = S.shinv_fixed(vw, hh, iters_max=refine_iters(M))
            _eq(J["si"][i], got)
        if v:
            w = bi.to_int(got.numpy())
            assert w - B ** int(h[i]) // v in (0, 1)


def test_shared_batch_names_match_jax(jax_out):
    _, J = jax_out
    ctx = MA.context_from_numpy(J["ctx_v"], J["ctx_mu"], J["ctx_k"], "cpu")
    r = MA.reduce_shared_batch(ctx, _t(X, 2 * M))
    _eq(J["reduce"], r)
    assert bi.batch_to_ints(r) == [x % MOD for x in X]
    p = MA.modmul_shared_batch(ctx, _t(A, M), _t(A[::-1], M))
    _eq(J["modmul"], p)
    assert bi.batch_to_ints(p) == [x * y % MOD for x, y in zip(A, A[::-1])]
    got = MA.modexp_shared_batch(ctx, _t(A, M), _t(E, 1), window_bits=4)
    _eq(J["modexp"], got)
    assert bi.batch_to_ints(got) == [pow(x, y, MOD) for x, y in zip(A, E)]


def test_set_default_impl_as_jax():
    """Both packages: a known name becomes what impl=None means, an
    unknown one raises ValueError and changes nothing."""
    before, jbefore = K.default_impl(), JK.default_impl()
    try:
        for name in K.IMPLS:
            K.set_default_impl(name)
            JK.set_default_impl(K.JAX_IMPLS[name])
            assert K.default_impl() == K.check_impl(None) == name
            assert JK.default_impl() == K.JAX_IMPLS[name]
        for setter, bad in ((K.set_default_impl, "pallas_fused"),
                            (JK.set_default_impl, "cuda_fused")):
            with pytest.raises(ValueError, match="unknown impl"):
                setter(bad)
        assert K.default_impl() == K.IMPLS[-1]
    finally:
        K.set_default_impl(before)
        JK.set_default_impl(jbefore)
    assert K.default_impl() == "cuda_fused"
