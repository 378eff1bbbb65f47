"""The port's batched division (`repro_torch.core.shinv`) and its
service against the JAX package's `divmod_batch(impl="blocked")` and
Python's divmod.

JAX runs once per (m, windowed) on one batch of 16 lanes (module-scoped
fixture; every new JAX shape compiles again) and the port's sub-batches
of 1, 5 and 16 are compared with the matching rows.  Lanes are
independent, so a sub-batch must reproduce its rows bit for bit.
"""

import ast
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bigint as JB
from repro.core import shinv as JS
from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import fused as F
from repro_torch.obs import costmodel as CM
from repro_torch.serving import errors as E
from repro_torch.serving.bigint_service import BigintDivisionService


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
CASES = [(4, True), (4, False), (26, True)]


def _operands(m, batch, seed):
    """tests/test_fused.py:_operands edges (all-0xFFFF, v = B^k, u = 0,
    tiny) plus zero-divisor, one-limb-divisor and u < v lanes."""
    rnd = random.Random(seed)
    us = [rnd.randint(0, B ** m - 1) for _ in range(batch)]
    vs = [rnd.randint(1, B ** rnd.randint(1, m) - 1) for _ in range(batch)]
    edges = [(B ** m - 1, B ** (m // 2) - 1), (B ** m - 1, B ** m - 1),
             (rnd.randint(0, B ** m - 1), B ** (m // 2)), (0, 1),
             (B ** (m // 2), B ** m - 1), (5, 7), (us[6], 0),
             (B ** m - 1, 0xFFFF), (us[8], 3), (12345, B ** m - 1),
             (us[10], 0)]
    for i, (uu, vv) in enumerate(edges):
        us[i], vs[i] = uu, vv
    return us, vs


@pytest.fixture(scope="module")
def jax_runs():
    """JAX divmod_batch(impl="blocked") once per (m, windowed)."""
    out = {}
    for m, windowed in CASES:
        us, vs = _operands(m, 16, m)
        q, r = JS.divmod_batch(jnp.asarray(JB.batch_from_ints(us, m)),
                               jnp.asarray(JB.batch_from_ints(vs, m)),
                               impl="blocked", windowed=windowed)
        out[m, windowed] = (us, vs, np.asarray(q), np.asarray(r))
    return out


@pytest.mark.parametrize("batch", [1, 5, 16])
@pytest.mark.parametrize("m,windowed", CASES)
def test_divmod_batch_matches_jax(jax_runs, m, windowed, batch):
    us, vs, jq, jr = jax_runs[m, windowed]
    lo = 16 - batch if batch == 5 else 0          # a middle slice too
    us, vs = us[lo:lo + batch], vs[lo:lo + batch]
    q, r = S.divmod_batch(bi.limbs_from_numpy(bi.batch_from_ints(us, m),
                                              "cpu"),
                          bi.limbs_from_numpy(bi.batch_from_ints(vs, m),
                                              "cpu"), windowed=windowed)
    np.testing.assert_array_equal(bi.limbs_to_numpy(q), jq[lo:lo + batch])
    np.testing.assert_array_equal(bi.limbs_to_numpy(r), jr[lo:lo + batch])
    for x, y, qq, rr in zip(us, vs, bi.batch_to_ints(q), bi.batch_to_ints(r)):
        assert (qq, rr) == (divmod(x, y) if y else (0, x)), (x, y)


def test_shinv_batch_matches_jax_with_zero_divisor():
    w = 12
    vs = [0, 0, 37, B ** 5 - 1, B ** 3, 1]
    hs = [6, 9, 6, 8, 7, 4]
    v = JB.batch_from_ints(vs, w)
    want = np.asarray(JS.shinv_batch(jnp.asarray(v),
                                     jnp.asarray(hs, jnp.int32),
                                     iters_max=4, impl="blocked"))
    got = S.shinv_batch(bi.limbs_from_numpy(v, "cpu"),
                        torch.tensor(hs, dtype=torch.int32), 4)
    np.testing.assert_array_equal(bi.limbs_to_numpy(got), want)
    ints = bi.batch_to_ints(got)
    assert ints[0] == ints[1] == 0
    for x, h, si in zip(vs[2:], hs[2:], ints[2:]):
        assert si - B ** h // x in (0, 1)            # Theorem 2: + lambda


@pytest.mark.parametrize("m", [4, 26])
def test_dispatches_per_divmod(monkeypatch, m):
    """2 step stages per Refine iteration + 1 finalization: the launch
    count the kernels give on the card, counted here at the dispatch."""
    calls = []
    for name in ("powdiff_reference", "update_reference",
                 "correct_reference"):
        orig = getattr(F, name)

        def counted(*a, _o=orig, _n=name, **k):
            calls.append(_n)
            return _o(*a, **k)
        monkeypatch.setattr(F, name, counted)
    z = torch.ones(2, m, dtype=torch.int32)
    S.divmod_batch(z, z)
    assert len(calls) == CM.divmod_launches(m) == 2 * CM.refine_iters(m) + 1
    assert calls.count("correct_reference") == 1
    assert [CM.refine_iters(k) for k in (2048, 4096, 8192, 16384)] == \
        [13, 14, 15, 16]
    assert [CM.divmod_launches(k) for k in (2048, 4096, 8192, 16384)] == \
        [27, 29, 31, 33]
    assert CM.refine_iters(m) == JS.refine_iters(m)


def test_service_exact_splitting_and_empty():
    svc = BigintDivisionService(m_limbs=4, batch_buckets=(2, 4),
                                device="cpu")
    rnd = random.Random(11)
    us = [rnd.randint(0, B ** 4 - 1) for _ in range(9)]
    vs = [rnd.randint(0, B ** rnd.randint(1, 4) - 1) for _ in range(9)]
    vs[3] = 0
    qs, rs = svc.divide(us, vs)                  # 9 > 4: splits 4+4+1
    assert list(zip(qs, rs)) == [divmod(x, y) if y else (0, x)
                                 for x, y in zip(us, vs)]
    assert svc.divide([], []) == ([], [])
    st = svc.stats()
    assert st["requests"] == {"divmod": 1} and st["items"] == {"divmod": 9}
    assert (st["rows_true"], st["rows_padded"]) == (9, 10)
    assert st["bucket_seconds"]["divmod/b4"]["count"] == 2
    with pytest.raises(E.OperandRangeError):
        svc.divide([B ** 4], [1])
    with pytest.raises(E.OperandTypeError):
        svc.divide([1.0], [1])
    with pytest.raises(E.InvalidRequest):
        svc.divide([1, 2], [1])


def test_cuda_request_raises_without_a_card():
    """Asking for the card where there is none raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BigintDivisionService(m_limbs=4)
    with pytest.raises((RuntimeError, AssertionError)):
        bi.limbs_from_numpy(np.zeros((1, 4), np.uint32), "cuda")


def test_port_imports_no_jax():
    """No module of repro_torch, nor chip_smoke.py, imports jax or the
    JAX package."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for nm in names:
                assert nm.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (f, nm)
