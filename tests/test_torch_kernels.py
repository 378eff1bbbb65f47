"""The plain versions of the port's kernels (`repro_torch.kernels`)
against the JAX package's `impl="blocked"` compositions, bit for bit.

On the CPU the port's dispatch (`kernels/ops.py`) runs the plain
versions; the JAX suite holds `impl="blocked"` bit-identical to the
Pallas kernels (tests/test_fused.py, tests/test_grid_fused.py), which
makes it the reference here.  The CUDA kernels are held to these same
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
Tolerance: exact equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.kernels import ops as JK
from repro_torch.core import bigint as bi
from repro_torch.kernels import bigmul, fused as F, ops as K

B = bi.BASE


def _cpu(xs, w):
    return bi.limbs_from_numpy(JB.batch_from_ints(xs, w), "cpu")


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64),
                                  torch_out.numpy().astype(np.int64))


@pytest.mark.parametrize("wo", [63, 64, 65, 128])
def test_mul_batch_matches_jax_blocked(wo):
    """out_width around the JAX product's block edges; random and
    all-0xFFFF operands (tests/test_kernels.py truncation edges)."""
    rnd = random.Random(wo)
    wu = wv = 130
    xs = [rnd.randint(0, B ** wu - 1) for _ in range(3)] + [B ** wu - 1, 0]
    ys = [rnd.randint(0, B ** wv - 1) for _ in range(3)] + [B ** wv - 1, 7]
    got = K.mul_batch(_cpu(xs, wu), _cpu(ys, wv), wo)
    want = JK.mul_batch_jit(jnp.asarray(JB.batch_from_ints(xs, wu)),
                            jnp.asarray(JB.batch_from_ints(ys, wv)), wo,
                            impl="blocked")
    _eq(want, got)
    for x, y, row in zip(xs, ys, bi.limbs_to_numpy(got)):
        assert bi.to_int(row) == (x * y) % B ** wo


def test_mul_single_and_mulmod():
    rnd = random.Random(3)
    x, y = rnd.randint(0, B ** 20 - 1), rnd.randint(0, B ** 9 - 1)
    got = K.mul(_cpu([x], 20)[0], _cpu([y], 9)[0], 40)
    assert bi.to_int(bi.limbs_to_numpy(got)) == x * y
    L = torch.tensor([0, 5, 40], dtype=torch.int32)
    r = K.mulmod(_cpu([x] * 3, 20), _cpu([y] * 3, 9), L, 40)
    assert bi.batch_to_ints(r) == [(x * y) % B ** k for k in (0, 5, 40)]


def _states(win, seed):
    """tests/test_fused.py:114-142: random iterates, scalars spanning
    the Refine ranges, inactive lanes, zero/all-0xFFFF edges."""
    rnd = random.Random(seed)
    w_full, batch = 16, 8
    vs = [B ** w_full - 1, 0] + [rnd.randint(0, B ** w_full - 1)
                                 for _ in range(batch - 2)]
    ws = [B ** win - 1, 0] + [rnd.randint(0, B ** win - 1)
                              for _ in range(batch - 2)]
    cols = dict(
        l=[rnd.randint(2, 5) for _ in range(batch)],
        m=[rnd.randint(0, 3) for _ in range(batch)],
        h=[rnd.randint(1, 2 * win - 1) for _ in range(batch)],
        s=[rnd.randint(0, 2) for _ in range(batch)])
    act = [i % 3 != 0 for i in range(batch)]
    return JB.batch_from_ints(vs, w_full), JB.batch_from_ints(ws, w_full), \
        cols, act


@pytest.mark.parametrize("win", [8, 16])
def test_fused_step_matches_jax_blocked(win):
    v, w, cols, act = _states(win, win)
    g = 2
    fn = jax.jit(jax.vmap(
        lambda vv, ww, hh, mm, ll, sc, aa: JK.fused_step(
            vv, ww, h=hh, m=mm, l=ll, s=sc, active=aa, g=g, win=win,
            impl="blocked")))
    jc = {k: jnp.asarray(c, jnp.int32) for k, c in cols.items()}
    want = fn(jnp.asarray(v), jnp.asarray(w), jc["h"], jc["m"], jc["l"],
              jc["s"], jnp.asarray(act))
    tc = {k: torch.tensor(c, dtype=torch.int32) for k, c in cols.items()}
    got = K.fused_step(bi.limbs_from_numpy(v, "cpu"),
                       bi.limbs_from_numpy(w, "cpu"), h=tc["h"], m=tc["m"],
                       l=tc["l"], s=tc["s"], active=torch.tensor(act), g=g,
                       win=win)
    _eq(want, got)
    # inactive lanes come back untouched
    assert torch.equal(got[~torch.tensor(act)],
                       bi.limbs_from_numpy(w, "cpu")[~torch.tensor(act)])


@pytest.mark.parametrize("w", [8, 20])
def test_fused_correct_matches_jax_blocked(w):
    rnd = random.Random(w)
    us = [rnd.randint(0, B ** w - 1) for _ in range(6)] + [B ** w - 1, 9]
    vs = [rnd.randint(1, B ** (w // 2)) for _ in range(6)] + [B ** w - 1, 0]
    # si near the true shifted inverse, off by a little either way
    hs = [-(-u.bit_length() // 16) for u in us]          # prec(u)
    sis = [(B ** h // v + rnd.randint(-1, 1)) % B ** w if v else 0
           for h, v in zip(hs, vs)]
    u, v, si = (JB.batch_from_ints(x, w) for x in (us, vs, sis))
    fn = jax.jit(jax.vmap(lambda a, b, c, d: JK.fused_correct(
        a, b, c, h=d, impl="blocked")))
    jq, jr = fn(jnp.asarray(u), jnp.asarray(v), jnp.asarray(si),
                jnp.asarray(hs, jnp.int32))
    tq, tr = K.fused_correct(bi.limbs_from_numpy(u, "cpu"),
                             bi.limbs_from_numpy(v, "cpu"),
                             bi.limbs_from_numpy(si, "cpu"),
                             h=torch.tensor(hs, dtype=torch.int32))
    _eq(jq, tq)
    _eq(jr, tr)
    assert bi.batch_to_ints(tq)[-1] == 0 and bi.batch_to_ints(tr)[-1] == 9


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs the plain version: CPU tensors raise
    before any build or launch."""
    z = torch.zeros(2, 16, dtype=torch.int32)
    c = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bigmul.mul_batch_cuda(z, z, 32)
    with pytest.raises(ValueError, match="CUDA"):
        F.step_cuda(z, z, h=c, m=c, l=c, s=c, active=c.bool(), g=2, win=16)
    with pytest.raises(ValueError, match="CUDA"):
        F.correct_cuda(z, z, z, h=c)
    with pytest.raises(ValueError, match="device"):
        K.mul_batch(z.to("meta"), z.to("meta"), 8)
