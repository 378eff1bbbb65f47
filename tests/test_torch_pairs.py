"""The plain versions of the port's pair-product kernel
(`repro_torch.kernels.bigmul.mul_pairs_reference`,
`mulmod_pairs_reference`) against the JAX package's `mul_pallas` and
`mulmod_pallas`, the single-instance Pallas kernel (run here in
interpret mode, as tests/test_kernels.py runs it), bit for bit.

The plain product's tile is 128 limbs and the JAX kernel's 128
sub-digits (64 limbs), so l_max runs at and around the edges of both.
Operands are numpy-seeded; the JAX kernel runs vmapped over the batch
of 4.  On the CPU `mul_pairs` and `mulmod_pairs` run their plain
versions (the card kernel's schedule is emulated in
tests/test_torch_pairs_digits.py).  Tolerance: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.kernels import bigmul as JBM
from repro_torch.core import bigint as bi
from repro_torch.kernels import bigmul, ops as K


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
T = K.BLOCK_T
WU, WV = 3 * T + 5, 2 * T + 3        # ragged in both tilings


def _operands(seed, batch=4, wu=WU, wv=WV, ones=False):
    """numpy-seeded limbs; lane 0 all-0xFFFF in both operands, lane 1 a
    zero u, or every lane all-0xFFFF with `ones`."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, B, (batch, wu), dtype=np.uint32)
    v = rng.integers(0, B, (batch, wv), dtype=np.uint32)
    if ones:
        u[:], v[:] = B - 1, B - 1
    else:
        u[0], v[0], u[1] = B - 1, B - 1, 0
    return u, v


def _both(u, v):
    return (jnp.asarray(u), jnp.asarray(v),
            bi.limbs_from_numpy(u, "cpu"), bi.limbs_from_numpy(v, "cpu"))


def _ints(a):
    return [JB.to_int(row) for row in np.asarray(a)]


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out).astype(np.int64),
                                  torch_out.numpy().astype(np.int64))


@pytest.mark.parametrize("l_max", [1, 63, 64, 65, 127, 128, 129, 192, 255,
                                   256, 257, 300])
def test_mulmod_pairs_matches_mulmod_pallas(l_max):
    u, v = _operands(l_max)
    ju, jv, tu, tv = _both(u, v)
    want = jax.vmap(lambda a, b: JBM.mulmod_pallas(a, b, l_max, WU + 2))(
        ju, jv)
    got = bigmul.mulmod_pairs_reference(tu, tv, l_max, WU + 2)
    _eq(want, got)
    assert torch.equal(bigmul.mulmod_pairs(tu, tv, l_max, WU + 2), got)
    assert _ints(got) == [(x * y) % B ** l_max
                          for x, y in zip(_ints(u), _ints(v))]


@pytest.mark.parametrize("wu,wv,wo", [(WU, WV, WU + WV), (WU, WV, 200),
                                      (20, 18, 40), (T, T, T + 1)])
def test_mul_pairs_matches_mul_pallas(wu, wv, wo):
    u, v = _operands(wu + wo, wu=wu, wv=wv)
    ju, jv, tu, tv = _both(u, v)
    want = jax.vmap(lambda a, b: JBM.mul_pallas(a, b, wo))(ju, jv)
    got = bigmul.mul_pairs_reference(tu, tv, wo)
    _eq(want, got)
    assert torch.equal(bigmul.mul_pairs(tu, tv, wo), got)
    assert torch.equal(K.mul_plain(tu, tv, wo), got)


@pytest.mark.parametrize("l_max", [T, 2 * T])
def test_mulmod_pairs_all_ones_at_tile_edges(l_max):
    """Carry chains across the pruning boundary: every limb 0xFFFF, l_max
    exactly at a tile edge."""
    u, v = _operands(0, wu=2 * T + 2, wv=2 * T + 2, ones=True)
    ju, jv, tu, tv = _both(u, v)
    want = jax.vmap(lambda a, b: JBM.mulmod_pallas(a, b, l_max,
                                                   2 * T + 4))(ju, jv)
    got = bigmul.mulmod_pairs_reference(tu, tv, l_max, 2 * T + 4)
    _eq(want, got)
    x = B ** (2 * T + 2) - 1
    assert _ints(got) == [(x * x) % B ** l_max] * 4


def test_pair_sums_prune_and_overlap():
    """The raw diagonal sums: diagonal d holds exactly the pairs
    i + j = d, pruning keeps the low diagonals unchanged, and the
    overlap-add of the pruned sums gives the close product."""
    u, v = _operands(7)
    tu, tv = bi.limbs_from_numpy(u, "cpu"), bi.limbs_from_numpy(v, "cpu")
    full = K.pair_sums_plain(tu, tv, 10 ** 6)
    nu, nv = -(-WU // T), -(-WV // T)
    assert full.shape == (4, nu + nv - 1, 2 * T)
    pruned = K.pair_sums_plain(tu, tv, 2)
    assert torch.equal(pruned, full[:, :2])
    uf = torch.nn.functional.pad(tu.long(), (0, nu * T - WU))
    vf = torch.nn.functional.pad(tv.long(), (0, nv * T - WV))
    d = 2                                     # pairs (0, 2), (1, 1), (2, 0)
    want = torch.zeros(4, 2 * T, dtype=torch.int64)
    for i in range(3):
        a, b = uf[:, i * T:(i + 1) * T], vf[:, (d - i) * T:(d - i + 1) * T]
        for c in range(T):
            want[:, c:c + T] += a[:, c:c + 1] * b
    assert torch.equal(full[:, d], want)
    assert torch.equal(K.columns_from_pairs(pruned, 2 * T),
                       bigmul.mulmod_pairs_reference(tu, tv, 2 * T, 2 * T))


def test_pairs_wrapper_refuses_cpu_tensors():
    u = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bigmul.mulmod_pairs_cuda(u, u, 8, 16)
