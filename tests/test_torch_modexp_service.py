"""The port's `ModArithService` on the CPU: exact against Python's `%`
and `pow` and against the port's own core functions, request
validation, the LRU context cache and its counters.  (The JAX
`ModArithService` raises at bucket compile on this tree's jax, so the
service is held to Python ints and the port's core, not to it.)"""

import random
import sys
import threading

import pytest
import torch

from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.serving import errors as E
from repro_torch.serving.modexp_service import ModArithService


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
M = 4


def _svc(**kw):
    kw.setdefault("batch_buckets", (2, 4))
    kw.setdefault("e_limbs", 2)
    return ModArithService(m_limbs=M, device="cpu", **kw)


def test_endpoints_exact_with_interleaved_moduli_and_splitting():
    svc = _svc()
    rnd = random.Random(4)
    v1, v2 = rnd.randint(B ** (M - 1), B ** M - 1), 0xFFFF
    xs = [rnd.randint(0, B ** (2 * M) - 1) for _ in range(9)]
    xs[0] = B ** (2 * M) - 1
    a = [rnd.randint(0, B ** M - 1) for _ in range(6)]
    b = [rnd.randint(0, B ** M - 1) for _ in range(6)]
    e = [rnd.randint(0, B ** 2 - 1) for _ in range(6)]
    e[0] = 0
    for v in (v1, v2, v1, v2):
        assert svc.reduce(xs, v) == [x % v for x in xs]     # 9 > 4: splits
        assert svc.modmul(a, b, v) == [x * y % v for x, y in zip(a, b)]
        assert svc.modexp(a, e, v) == [pow(x, y, v) for x, y in zip(a, e)]
    st = svc.stats()
    assert st["ctx_cache"]["misses"] == 2 and st["ctx_cache"]["hits"] == 10
    assert st["ctx_cache"]["evictions"] == 0 and st["ctx_cache"]["size"] == 2
    assert st["requests"] == {"reduce": 4, "modmul": 4, "modexp": 4}
    assert st["items"]["reduce"] == 36
    # rows: reduce 4 + 4 + 2 (9 = 4 + 4 + 1, the last padded to bucket 2),
    # modmul and modexp 4 + 2 each, four times
    assert (st["rows_true"], st["rows_padded"]) == (4 * 21, 4 * 22)
    assert st["bucket_seconds"]["reduce/b4"]["count"] == 8


def test_service_matches_core_functions():
    """The service's answers are the port's `*_shared` functions' on the
    padded bucket, row for row."""
    svc = _svc(window_bits=2)
    v = 0xFFFF0001
    a, e = [5, 7, 0xFFFFFFFF], [0xFFFF, 2, 0]
    got = svc.modexp(a, e, v)
    ctx = MA.barrett_precompute(bi.limbs_from_numpy(bi.from_int(v, M), "cpu"))
    core = MA.modexp_shared(
        ctx, bi.limbs_from_numpy(bi.batch_from_ints(a + [0], M), "cpu"),
        bi.limbs_from_numpy(bi.batch_from_ints(e + [0], 2), "cpu"),
        window_bits=2)
    assert got == bi.batch_to_ints(core)[:3] == [pow(x, y, v)
                                                 for x, y in zip(a, e)]


def test_empty_requests_do_nothing():
    svc = _svc()
    assert svc.reduce([], 7) == [] and svc.modmul([], [], 7) == []
    assert svc.modexp([], [], 7) == []
    st = svc.stats()
    assert st["requests"] == {} and st["ctx_cache"]["misses"] == 0


@pytest.mark.parametrize("call,err", [
    (lambda s: s.reduce([1], 0), E.InvalidRequest),
    (lambda s: s.reduce([1], -5), E.InvalidRequest),
    (lambda s: s.reduce([1], B ** M), E.OperandRangeError),
    (lambda s: s.reduce([1], True), E.OperandTypeError),
    (lambda s: s.reduce([1], 7.0), E.OperandTypeError),
    (lambda s: s.reduce([B ** (2 * M)], 7), E.OperandRangeError),
    (lambda s: s.reduce([-1], 7), E.OperandRangeError),
    (lambda s: s.modmul([1, 2], [3], 7), E.InvalidRequest),
    (lambda s: s.modmul([B ** M], [3], 7), E.OperandRangeError),
    (lambda s: s.modmul([1.5], [3], 7), E.OperandTypeError),
    (lambda s: s.modexp([2], [B ** 2], 7), E.OperandRangeError),
    (lambda s: s.modexp([2], [False], 7), E.OperandTypeError),
    (lambda s: s.validate("divmod", ([1],)), E.InvalidRequest),
    (lambda s: s.validate("modmul", ([1],)), E.InvalidRequest),
])
def test_validation_errors(call, err):
    svc = _svc()
    with pytest.raises(err):
        call(svc)
    assert svc.stats()["ctx_cache"]["misses"] == 0     # nothing computed


def test_validation_keeps_builtin_exception_types():
    svc = _svc()
    with pytest.raises(OverflowError):
        svc.reduce([B ** (2 * M)], 7)
    with pytest.raises(TypeError):
        svc.modmul(["3"], [3], 7)
    with pytest.raises(ValueError, match="modulus must be positive"):
        svc.modexp([2], [3], 0)
    assert svc.validate("modexp", ([2, 3], [4, 5]), 9) == 2


def test_lru_eviction_and_counts():
    svc = _svc(max_cached_moduli=2)
    for v in (7, 11, 7, 13, 11, 7):
        assert svc.reduce([100], v) == [100 % v]
    # 7 miss, 11 miss, 7 hit, 13 miss (evicts 11), 11 miss (evicts 7),
    # 7 miss (evicts 13)
    c = svc.stats()["ctx_cache"]
    assert (c["hits"], c["misses"], c["evictions"], c["size"]) == (1, 5, 3, 2)
    assert c["hit_rate"] == pytest.approx(1 / 6)
    assert list(svc._ctxs) == [11, 7]


def test_bad_window_raises_on_modexp():
    svc = _svc(window_bits=3)
    with pytest.raises(ValueError, match="window_bits must divide"):
        svc.modexp([2], [3], 7)


def test_concurrent_requests_precompute_each_modulus_once():
    """Eight threads against two moduli: each context is computed once
    and every answer is exact."""
    svc = _svc()
    errors, results = [], {}
    switch = sys.getswitchinterval()

    def work(i):
        v = (7, 65521)[i % 2]
        try:
            results[i] = (v, svc.modmul([i + 2, 3], [5, i], v))
        except Exception as exc:               # recorded, asserted below
            errors.append(exc)

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, (v, got) in results.items():
        assert got == [(i + 2) * 5 % v, 3 * i % v]
    c = svc.stats()["ctx_cache"]
    assert (c["misses"], c["hits"]) == (2, 6)


def test_cuda_service_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ModArithService(m_limbs=4)
