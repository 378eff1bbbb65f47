"""The port's limb format and limb primitives (`repro_torch.core`)
against the JAX package (`repro.core`), bit for bit.

The same operands, made with numpy/random from fixed seeds, go through
the JAX function (under jax.vmap) and the port's batched function;
the limbs cross between the two packages only through
`bigint.limbs_from_numpy` / `limbs_to_numpy`.  Tolerance: exact
equality (integer arithmetic).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arith as JA
from repro.core import bigint as JB
from repro.core import shinv as JS
from repro_torch.core import arith as A
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S

B = bi.BASE


def _ints(w, seed, n_random=6):
    """Zero, all-0xFFFF, B^k, sparse and random w-limb operands."""
    rnd = random.Random(seed)
    xs = [0, B ** w - 1, 1, B ** (w - 1), B ** (w // 2),
          (B ** w - 1) - (B ** (w // 2) - 1)]
    xs += [rnd.randint(0, B ** w - 1) for _ in range(n_random)]
    xs += [rnd.randint(0, B ** rnd.randint(1, w) - 1) for _ in range(4)]
    return xs


def _pair(w, seed):
    xs = _ints(w, seed)
    ys = _ints(w, seed + 1)[::-1]
    ys[:3] = xs[:3]                       # equal rows decide lt/eq ties
    return JB.batch_from_ints(xs, w), JB.batch_from_ints(ys, w)


def _both(a):
    return jnp.asarray(a), bi.limbs_from_numpy(a, "cpu")


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64),
                                  torch_out.numpy().astype(np.int64))


# ---------------------------------------------------------------------------
# bigint: representation and the carry-across functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 8, 17])
def test_bigint_round_trip_matches_jax(w):
    xs = _ints(w, w)
    a = bi.batch_from_ints(xs, w)
    np.testing.assert_array_equal(a, JB.batch_from_ints(xs, w))
    assert a.dtype == np.uint32
    t = bi.limbs_from_numpy(a, "cpu")
    assert t.dtype == bi.DTYPE and t.shape == (len(xs), w)
    np.testing.assert_array_equal(bi.limbs_to_numpy(t), a)
    assert bi.batch_to_ints(t) == xs == JB.batch_to_ints(a)
    assert [bi.to_int(bi.from_int(x, w)) for x in xs] == xs


def test_bigint_edges():
    assert bi.width_for_bits(2 ** 15) == JB.width_for_bits(2 ** 15) == 2048
    assert bi.width_for_bits(17) == 2
    with pytest.raises(OverflowError):
        bi.from_int(B ** 3, 3)
    with pytest.raises(ValueError):
        bi.from_int(-1, 3)
    with pytest.raises(ValueError):
        bi.limbs_from_numpy(np.array([[B]], np.uint32), "cpu")
    assert bi.batch_from_ints([], 4).shape == (0, 4)
    # same draws as the JAX package from the same seed
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    assert bi.random_ints(r1, 6, 9) == JB.random_ints(r2, 6, 9)
    p = bi.one_hot_pow(bi.limbs_from_numpy(np.array([0, 3, 9], np.uint32),
                                           "cpu"), 5)
    assert p.tolist() == [[1, 0, 0, 0, 0], [0, 0, 0, 1, 0], [0] * 5]


# ---------------------------------------------------------------------------
# arith: every primitive against its JAX namesake, widths 8 and 16
# ---------------------------------------------------------------------------

def _shifts(n, w, seed):
    rnd = random.Random(seed)
    base = [-w - 1, -w, -1, 0, 1, w, w + 1]
    return np.asarray((base + [rnd.randint(-w - 1, w + 1)
                               for _ in range(n)])[:n], np.int32)


UNARY = ["prec", "is_zero", "is_pow"]
BINARY = ["add", "sub", "lt", "ge", "eq"]
WITH_INT = ["shift", "sub_pow", "ge_pow", "gt_pow", "eq_pow", "neg_mod_pow",
            "mask_below", "take_limb", "add_scalar", "sub_scalar"]


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("name", UNARY + BINARY + WITH_INT)
def test_arith_matches_jax(name, w):
    ua, va = _pair(w, w)
    (ju, tu), (jv, tv) = _both(ua), _both(va)
    n = _shifts(len(ua), w, w + len(name))
    if name in ("add_scalar", "sub_scalar"):
        n = np.abs(n) % 7                                  # small d < B
    if name == "neg_mod_pow":                              # needs 0 < u < B^L
        n = np.asarray([max(int(JA.prec(r)), int(k)) for r, k in
                        zip(ua, np.abs(n))], np.int32)
    jf, tf = getattr(JA, name), getattr(A, name)
    if name in UNARY:
        _eq(jax.vmap(jf)(ju), tf(tu))
    elif name in BINARY:
        _eq(jax.vmap(jf)(ju, jv), tf(tu, tv))
    else:
        _eq(jax.vmap(jf)(ju, jnp.asarray(n)), tf(tu, torch.from_numpy(n)))
        if name in ("shift", "mask_below", "sub_pow", "take_limb"):
            for k in (-w - 1, -3, 0, 2, w + 1):           # Python-int form
                want = jax.vmap(lambda r: jf(r, k))(ju)
                _eq(want, tf(tu, k))


@pytest.mark.parametrize("w", [8, 16])
def test_carry_scan_matches_jax(w):
    rnd = np.random.default_rng(w)
    gen = rnd.integers(0, 2, (12, w)).astype(np.int32)
    prop = rnd.integers(0, 2, (12, w)).astype(np.int32)
    gen[0], prop[0] = 0, 1                                 # full ripple
    gen[0, 0] = 1
    _eq(JA.carry_scan(jnp.asarray(gen), jnp.asarray(prop)),
        A.carry_scan(torch.from_numpy(gen), torch.from_numpy(prop)))


def test_ceil_log2_exhaustive():
    n = np.arange(1, 2 ** 18 + 1, dtype=np.int32)
    got = A.ceil_log2(torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JA.ceil_log2(
        jnp.asarray(n))))
    np.testing.assert_array_equal(
        got, [int(k - 1).bit_length() for k in n])


def test_initial_w0_edges_match_jax():
    V = [B, B + 1, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, B * B - 1, 0, 1,
         3 * B + 12345, 40000 * B]
    got = S._initial_w0(torch.tensor(V, dtype=torch.int64))
    want = JS._initial_w0(jnp.asarray(np.asarray(V, np.uint32)))
    for g, wnt in zip(got, want):
        _eq(wnt, g)
    for vv, d0, d1, d2 in zip(V, *(t.tolist() for t in got)):
        if vv >= B:                                        # floor(B^3 / V)
            assert d0 + B * d1 + B * B * d2 == B ** 3 // vv
    assert [t[0].item() for t in got] == [0, 0, 1]         # V = B: d2 = 1

