"""The port's impl registry (`repro_torch.kernels.ops`): the ladder
against the JAX package's, every entry point under each of the four
impls against the JAX package's `impl="blocked"` and `impl="pallas"`
(the single-instance Pallas kernel in interpret mode, as
tests/test_kernels.py runs it at m <= 16), and the launch counts of the
port's cost model against `repro/obs/costmodel.py` with the impl names
mapped (`ops.JAX_IMPLS`).

On the CPU every impl runs its composition with the plain versions of
its kernels; the products it would launch on the card are counted here
by wrapping the impl's product.  JAX compiles each program once per
module (about 15-25 s each).  Tolerance: exact equality.
"""

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
from repro.obs import costmodel as JCM
from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.core import shinv as S
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
M_DIV = 8                 # divmod width (the JAX pallas run needs m <= 16)
M_MOD = 4                 # modulus width
JAX_IMPLS = ("blocked", "pallas")


def _t(xs, w):
    return bi.limbs_from_numpy(JB.batch_from_ints(xs, w), "cpu")


def _j(xs, w):
    return jnp.asarray(JB.batch_from_ints(xs, w))


def _div_lanes():
    rnd = random.Random(8)
    m = M_DIV
    us = [rnd.randint(0, B ** m - 1) for _ in range(8)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(8)]
    us[0], vs[0] = B ** m - 1, B ** (m // 2) - 1
    vs[1], vs[2], vs[3] = B ** (m // 2), 0, 0xFFFF
    return us, vs


def _mod_lanes():
    rnd = random.Random(4)
    m = M_MOD
    v = rnd.randint(B ** (m - 1), B ** m - 1)
    xs = [rnd.randint(0, B ** (2 * m) - 1) for _ in range(8)]
    xs[:3] = [B ** (2 * m) - 1, 0, v * rnd.randint(1, B ** m - 1)]
    a = [rnd.randint(0, B ** m - 1) for _ in range(8)]
    a[:2] = [B ** m - 1, 0]
    b = a[::-1]
    e = [rnd.randint(0, B - 1) for _ in range(8)]
    e[:3] = [B - 1, 0, 1]
    return dict(v=v, x=xs, a=a, b=b, e=e)


@pytest.fixture(scope="module")
def jax_runs():
    """divmod at M_DIV and the shared modular functions at M_MOD, under
    JAX impl blocked and pallas, as numpy limbs."""
    us, vs = _div_lanes()
    L = _mod_lanes()
    out = {}
    for impl in JAX_IMPLS:
        q, r = JS.divmod_batch(_j(us, M_DIV), _j(vs, M_DIV), impl=impl)

        @jax.jit
        def mod(v, x, a, b, e, impl=impl):
            ctx = JM.barrett_precompute(v, impl=impl)
            return dict(mu=ctx.mu,
                        reduce=JM.reduce_shared(ctx, x, impl=impl),
                        modmul=JM.modmul_shared(ctx, a, b, impl=impl),
                        modexp=JM.modexp_shared(ctx, a, e, impl=impl))

        res = mod(jnp.asarray(JB.from_int(L["v"], M_MOD)),
                  _j(L["x"], 2 * M_MOD), _j(L["a"], M_MOD),
                  _j(L["b"], M_MOD), _j(L["e"], 1))
        out[impl] = dict(q=np.asarray(q), r=np.asarray(r),
                         **{k: np.asarray(a) for k, a in res.items()})
    return out


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64),
                                  torch_out.numpy().astype(np.int64))


class _Counted:
    """Wraps impl's product in the registry and counts its calls: on the
    card each is one kernel launch of the impl's product kernel."""

    def __init__(self, monkeypatch, impl):
        self.n = 0
        orig = K._PRODUCTS[impl]

        def counted(u, v, out_width):
            self.n += 1
            return orig(u, v, out_width)
        monkeypatch.setitem(K._PRODUCTS, impl, counted)

    def take(self):
        n, self.n = self.n, 0
        return n


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", K.IMPLS)
def test_fallback_chain_matches_jax(impl):
    chain = K.fallback_chain(impl)
    assert chain == {"cuda_fused": ["cuda_fused", "cuda_batched", "blocked"],
                     "cuda_batched": ["cuda_batched", "blocked"],
                     "cuda_pairs": ["cuda_pairs", "blocked"],
                     "blocked": ["blocked"]}[impl]
    assert [K.JAX_IMPLS[i] for i in chain] == \
        JK.fallback_chain(K.JAX_IMPLS[impl])
    nxt = K.fallback_impl(impl)
    assert (nxt and K.JAX_IMPLS[nxt]) == JK.fallback_impl(K.JAX_IMPLS[impl])


def test_registry_names_and_default():
    assert set(K.JAX_IMPLS) == set(K.IMPLS)
    assert set(K.JAX_IMPLS.values()) <= set(JK.IMPLS)
    assert K.default_impl() == "cuda_fused"
    assert K.check_impl(None) == "cuda_fused"
    for bad in ("scan", "pallas", "warp_speed"):
        with pytest.raises(ValueError):
            K.fallback_impl(bad)
    assert K.check_impl("blocked") == "blocked"


@pytest.mark.parametrize("impl", K.IMPLS)
def test_fallback_chain_on_the_card_ends_at_a_kernel(impl):
    """On the card the ladder stops at the last kernel rung: blocked
    (the plain versions) runs there only when it is asked for."""
    chain = {"cuda_fused": ["cuda_fused", "cuda_batched"],
             "cuda_batched": ["cuda_batched"],
             "cuda_pairs": ["cuda_pairs"],
             "blocked": ["blocked"]}[impl]
    assert K.fallback_chain(impl, "cuda") == chain
    assert K.fallback_chain(impl, torch.device("cuda", 0)) == chain
    assert K.fallback_chain(impl, "cpu") == K.fallback_chain(impl)


# ---------------------------------------------------------------------------
# every entry point under every impl, against JAX blocked and pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", K.IMPLS)
def test_divmod_under_each_impl_matches_jax(jax_runs, monkeypatch, impl):
    us, vs = _div_lanes()
    prods = _Counted(monkeypatch, impl)
    q, r = S.divmod_batch(_t(us, M_DIV), _t(vs, M_DIV), impl=impl)
    for j in JAX_IMPLS:
        _eq(jax_runs[j]["q"], q)
        _eq(jax_runs[j]["r"], r)
    for x, y, qq, rr in zip(us, vs, bi.batch_to_ints(q),
                            bi.batch_to_ints(r)):
        assert (qq, rr) == (divmod(x, y) if y else (0, x))
    if impl in ("cuda_pairs", "cuda_batched"):
        assert prods.take() == CM.divmod_launches(M_DIV, impl)


@pytest.mark.parametrize("impl", K.IMPLS)
def test_modarith_under_each_impl_matches_jax(jax_runs, monkeypatch, impl):
    L = _mod_lanes()
    m, v = M_MOD, L["v"]
    prods = _Counted(monkeypatch, impl)
    ctx = MA.barrett_precompute(_t([v], m)[0], impl)
    unfused = impl in ("cuda_pairs", "cuda_batched")
    if unfused:
        assert prods.take() == CM.precompute_launches(m, impl)
    x, a, b = _t(L["x"], 2 * m), _t(L["a"], m), _t(L["b"], m)
    got = dict(mu=ctx.mu[None],
               reduce=MA.reduce_shared(ctx, x, impl),
               modmul=MA.modmul_shared(ctx, a, b, impl),
               modexp=MA.modexp_shared(ctx, a, _t(L["e"], 1), impl=impl))
    if unfused:
        assert prods.take() == sum(CM.model_launches(op, m, impl, e_bits=16)
                                   for op in ("reduce", "modmul", "modexp"))
    for j in JAX_IMPLS:
        for k, t in got.items():
            _eq(jax_runs[j][k].reshape(t.shape), t)
    assert bi.batch_to_ints(got["modexp"]) == [
        pow(aa, ee, v) for aa, ee in zip(L["a"], L["e"])]
    # the per-lane entry point, against Python
    vs = [v, 1, 0xFFFF, B ** (m - 1)] * 2
    per = MA.modmul_batch(a, b, _t(vs, m), impl)
    assert bi.batch_to_ints(per) == [aa * bb % vv for aa, bb, vv in
                                     zip(L["a"], L["b"], vs)]


@pytest.mark.parametrize("impl", K.IMPLS)
def test_products_under_each_impl(impl):
    rnd = random.Random(5)
    xs = [rnd.randint(0, B ** 300 - 1) for _ in range(3)] + [B ** 300 - 1]
    ys = [rnd.randint(0, B ** 200 - 1) for _ in range(3)] + [B ** 200 - 1]
    u, v = _t(xs, 300), _t(ys, 200)
    for wo in (1, 128, 129, 500):
        got = K.mul_batch(u, v, wo, impl)
        assert bi.batch_to_ints(got) == [x * y % B ** wo
                                         for x, y in zip(xs, ys)]
        assert torch.equal(K.mul(u[0], v[0], wo, impl), got[0])
        L = torch.tensor([0, 1, wo // 2, wo], dtype=torch.int32)
        assert bi.batch_to_ints(K.mulmod(u, v, L, wo, impl)) == [
            x * y % B ** int(ll) for x, y, ll in zip(xs, ys, L)]


def test_width_cap_dispatch():
    """Every impl takes a 2^18-bit modulus (16384 limbs) on the CPU.  On
    the card the cap of cuda_fused and cuda_batched is read from the
    kernel libraries (tests/test_torch_cuda.py); a Barrett window past
    the digit product's column-sum contract raises before any library
    is built or launched, and only for those two impls.  Nothing
    reroutes on its own."""
    from repro_torch.kernels import digitmma as D
    cuda = torch.device("cuda")
    for impl in K.IMPLS:
        MA.check_width("cpu", 16384, impl)
        MA.check_width("cpu", 32768, impl)
    too_wide = D.MAX_LIMBS // 2                 # W = 2m + 10 > MAX_LIMBS
    assert MA.barrett_width(too_wide) > D.MAX_LIMBS
    for impl in ("cuda_fused", "cuda_batched", None):
        with pytest.raises(ValueError, match="column-sum contract"):
            MA.check_width(cuda, too_wide, impl)
    for impl in ("cuda_pairs", "blocked"):
        MA.check_width(cuda, too_wide, impl)


class _StubLibs:
    """Stand-ins for the kernel libraries' staging sizes (two bytes a
    limb per staged operand plus a fixed part, as csrc/*.cu size them),
    so that the fit functions and the width checks run without a card;
    `asked` records every library looked up."""

    def __init__(self):
        self.asked = []

    def __call__(self, name):
        self.asked.append(name)
        return self

    @staticmethod
    def step_smem_bytes(win):
        return 4 * win + 400

    @staticmethod
    def correct_smem_bytes(w):
        return 6 * w + 64

    @staticmethod
    def barrett_smem_bytes(nx, nv, w):
        return 2 * (nx + nv + w) + 64

    @staticmethod
    def mul_batch_smem_bytes(wu, wv, out):
        return 2 * (min(wu, out) + min(wv, out)) + 64


def _op_fits(op, impl, m):
    """Each kernel's fit function at the widths op runs it under impl
    on the card, as the docstrings of the width checks list them."""
    from repro_torch.kernels import bigmul, fused as F
    if op == "division":
        w = m + S.PAD
        if impl == "cuda_fused":
            return [lambda: F.step_fit(w), lambda: F.correct_fit(w)]
        return [lambda: bigmul.mul_batch_fit(w, w, 2 * w)]
    w = MA.barrett_width(m)
    if impl == "cuda_fused":
        return [lambda: F.step_fit(w), lambda: F.barrett_fit(2 * m, m, w),
                lambda: bigmul.mul_batch_fit(m, m, 2 * m)]
    return [lambda: bigmul.mul_batch_fit(w, w, 2 * w)]


def _fits(fits) -> bool:
    try:
        for fit in fits:
            fit()
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("impl", ["cuda_fused", "cuda_batched"])
@pytest.mark.parametrize("op", ["division", "modulus"])
def test_width_checks_agree_with_the_fit_functions(monkeypatch, op, impl):
    """With stand-in libraries: at the widest m the kernels' fit
    functions take (their cap, found by bisection), shinv.check_width
    or modarith.check_width passes, and at cap + 1 it raises the same
    refusal the failing fit function raises, before any launch."""
    from repro_torch.kernels import build
    stub = _StubLibs()
    monkeypatch.setattr(build, "lib", stub)
    check = S.check_width if op == "division" else MA.check_width
    from repro_torch.kernels import digitmma as D
    # fits at lo, not at hi, the widest m inside the column-sum contract
    lo, hi = 1, (D.MAX_LIMBS - S.PAD if op == "division"
                 else (D.MAX_LIMBS - MA.barrett_width(0)) // 2)
    assert _fits(_op_fits(op, impl, lo))
    assert not _fits(_op_fits(op, impl, hi))
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if _fits(_op_fits(op, impl, mid)) else (lo, mid)
    cuda = torch.device("cuda")
    check(cuda, lo, impl)
    if impl == "cuda_fused":
        check(cuda, lo)                 # None is the default, cuda_fused
    for fit in _op_fits(op, impl, hi):
        try:
            fit()
        except ValueError as exc:
            refusal = str(exc)
            break
    with pytest.raises(ValueError, match="shared memory") as got:
        check(cuda, hi, impl)
    assert refusal in str(got.value)
    assert "(impl='cuda_pairs' has no such cap)" in str(got.value)
    assert stub.asked


@pytest.mark.parametrize("op", ["division", "modulus"])
def test_width_checks_never_cap_unstaged_impls(monkeypatch, op):
    """cuda_pairs and blocked on the card, and every impl on the CPU,
    take any width below the column-sum contract without asking a
    kernel library, however much it would stage."""
    from repro_torch.kernels import build
    stub = _StubLibs()
    monkeypatch.setattr(build, "lib", stub)
    monkeypatch.setattr(stub, "step_smem_bytes", lambda win: 1 << 30)
    check = S.check_width if op == "division" else MA.check_width
    for impl in ("cuda_pairs", "blocked"):
        check(torch.device("cuda"), 30000, impl)
    for impl in (*K.IMPLS, None):
        check("cpu", 30000, impl)
    assert stub.asked == []
    with pytest.raises(ValueError, match="shared memory"):
        check(torch.device("cuda"), 8, "cuda_fused")


@pytest.mark.parametrize("fit,staged", [
    ("step_fit", "step_smem_bytes"), ("correct_fit", "correct_smem_bytes"),
    ("barrett_fit", "barrett_smem_bytes"),
    ("mul_batch_fit", "mul_batch_smem_bytes")])
def test_fit_function_holds_the_staging_to_shared_memory(monkeypatch, fit,
                                                         staged):
    """Each kernel's fit function gives the bytes its library reports
    up to digitmma.DYNAMIC_SMEM_BYTES and raises ValueError one byte
    past it; past the column-sum contract it raises without asking the
    library."""
    from repro_torch.kernels import bigmul, build, digitmma as D, fused
    stub = _StubLibs()
    monkeypatch.setattr(build, "lib", stub)
    fn = getattr(bigmul if fit == "mul_batch_fit" else fused, fit)
    nargs = 3 if fit in ("barrett_fit", "mul_batch_fit") else 1
    for n in (0, D.DYNAMIC_SMEM_BYTES):
        monkeypatch.setattr(stub, staged, lambda *a, n=n: n)
        assert fn(*[8] * nargs) == n
    monkeypatch.setattr(stub, staged, lambda *a: D.DYNAMIC_SMEM_BYTES + 1)
    with pytest.raises(ValueError, match="more than shared memory holds"):
        fn(*[8] * nargs)
    asked = len(stub.asked)
    with pytest.raises(ValueError, match="column-sum contract"):
        fn(*[D.MAX_LIMBS + 1] * nargs)
    assert len(stub.asked) == asked


# ---------------------------------------------------------------------------
# cost model per impl
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", K.IMPLS)
def test_costmodel_per_impl_matches_jax(impl):
    j = K.JAX_IMPLS[impl]
    assert CM.step_launches(impl) == JCM.step_launches(j)
    assert CM.step_glue_ops(impl) == JCM.step_glue_ops(j)
    assert CM.mul_launches(impl) == JCM.mul_launches(j)
    assert CM.barrett_launches(impl) == JCM.barrett_launches(j)
    assert CM.modmul_launches(impl) == JCM.modmul_launches(j)
    for m in (4, 26, 2048, 16384):
        assert CM.divmod_launches(m, impl) == JCM.divmod_launches(m, j)
        for op in ("divmod", "reduce", "modmul"):
            assert CM.model_launches(op, m, impl) == \
                JCM.model_launches(op, m, j)
    for e_bits, w in ((16, 4), (256, 4), (64, 2)):
        assert CM.modexp_launches(e_bits, w, impl) == \
            JCM.modexp_launches(e_bits, w, impl=j)
        assert CM.model_launches("modexp", 4, impl, e_bits=e_bits,
                                 window_bits=w) == \
            CM.modexp_launches(e_bits, w, impl)
    assert CM.model_launches("modexp", 4, impl) is None
    assert CM.model_launches("precompute", 2048, impl) == \
        CM.step_launches(impl) * CM.precompute_iters(2048)


def test_costmodel_fused_counts_unchanged():
    assert [CM.divmod_launches(m) for m in (2048, 4096, 8192, 16384)] == \
        [27, 29, 31, 33]
    assert [CM.precompute_launches(m) for m in (2048, 4096, 8192)] == \
        [30, 32, 34]
    assert (CM.barrett_launches(), CM.modmul_launches(),
            CM.modexp_launches(256)) == (1, 2, 674)
    assert (CM.divmod_launches(2048, "cuda_pairs"),
            CM.modexp_launches(256, impl="cuda_pairs")) == (28, 3 * 336 + 4)
