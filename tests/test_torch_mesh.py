"""The sharded services on the CPU: `launch/mesh.py`,
`serving/batching.py:ShardedExecutable` and both services under `mesh=`
over 2- and 4-shard host meshes, against the unsharded services,
Python ints and, in a subprocess, the JAX services on a 2-device host
mesh (`XLA_FLAGS=--xla_force_host_platform_device_count=2`).

On the CPU every shard runs the plain versions; the same path on the
card (one graph and stream per shard) is in tests/test_torch_cuda.py.
"""

import json
import os
import random
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import bigint as jbi
from repro.core import modarith as JMA
from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.launch import mesh as MS
from repro_torch.obs import report as R
from repro_torch.serving import batching as BT
from repro_torch.serving.bigint_service import BigintDivisionService
from repro_torch.serving.modexp_service import ModArithService

B = bi.BASE
SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are
    small, and the test workers share the host's cores (at the default
    of one thread per core, torch spends three times the CPU time on
    these tests for a third less wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(rnd, n, m):
    us = [rnd.randrange(B ** m) for _ in range(n)]
    vs = [rnd.randrange(1, B ** rnd.randint(1, m)) for _ in range(n)]
    us[0], vs[0] = B ** m - 1, B ** m - 1
    vs[1] = 0                                 # divmod(u, 0) = (0, u)
    return us, vs


def _divmod(u, v):
    return divmod(u, v) if v else (0, u)


def test_mesh_layouts():
    shape, axes, n = MS.make_production_mesh()
    assert (shape, axes, n) == ((16, 16), ("data", "model"), 256)
    assert MS.make_production_mesh(multi_pod=True)[2] == 512
    mesh = MS.make_host_mesh(4)
    assert mesh.size == 4 and mesh.distinct == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        MS.DeviceMesh((torch.device("cpu"),) * 2, (3,), ("data",))
    with pytest.raises(ValueError):
        MS.mesh_of([])


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_division_service(shards):
    """A request split across buckets (8 + 4) and each bucket across
    the shards: equal to the unsharded service and to Python."""
    rnd = random.Random(shards)
    m = 4
    us, vs = _pairs(rnd, 11, m)
    kw = dict(batch_buckets=(4, 8), impl="blocked")
    plain = BigintDivisionService(m, device="cpu", **kw)
    svc = BigintDivisionService(m, mesh=MS.make_host_mesh(shards), **kw)
    got = svc.divide(us, vs)
    assert got == plain.divide(us, vs)
    assert list(zip(*got)) == [_divmod(u, v) for u, v in zip(us, vs)]
    snap = svc.snapshot()
    assert snap["shards"] == shards
    for b in (4, 8):
        assert snap["buckets"][b]["static"]["divmod"]["shards"] == shards
    rows = R.measured_vs_model(snap)
    assert [r["shards"] for r in rows] == [shards, shards]
    assert all(r["match"] for r in rows)
    assert "shards" in R.render_measured_vs_model(snap)
    assert svc.stats()["rows_true"] == 11


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_modular_service(shards):
    """reduce, modmul and modexp through a mesh against two interleaved
    moduli: equal to the unsharded service and to Python; one
    precompute per modulus."""
    rnd = random.Random(10 + shards)
    m = 3
    kw = dict(e_limbs=1, batch_buckets=(4, 8), impl="blocked")
    plain = ModArithService(m, device="cpu", **kw)
    svc = ModArithService(m, mesh=MS.make_host_mesh(shards), **kw)
    moduli = [rnd.randrange(2, B ** m) | 1, rnd.randrange(2, B ** 2)]
    for v in moduli + moduli:
        xs = [rnd.randrange(B ** (2 * m)) for _ in range(11)]
        a = [rnd.randrange(B ** m) for _ in range(5)]
        b = [rnd.randrange(B ** m) for _ in range(5)]
        e = [rnd.randrange(B) for _ in range(5)]
        for op, cols, want in (
                ("reduce", (xs,), [x % v for x in xs]),
                ("modmul", (a, b), [x * y % v for x, y in zip(a, b)]),
                ("modexp", (a, e), [pow(x, y, v) for x, y in zip(a, e)])):
            got = getattr(svc, op)(*cols, v)
            assert got == want, op
            assert got == getattr(plain, op)(*cols, v), op
    st = svc.stats()["ctx_cache"]
    assert (st["misses"], st["hits"]) == (2, 10)
    snap = svc.snapshot()
    assert snap["shards"] == shards
    assert {op for b in (4, 8) for op in snap["buckets"][b]["static"]} \
        == {"reduce", "modmul", "modexp"}
    assert all(r["match"] for r in R.measured_vs_model(snap))


def test_one_precompute_per_modulus_and_eviction(monkeypatch):
    """The precompute runs once per modulus (plus the build's warm-up on
    the fill), on the mesh's first device; an eviction drops the
    modulus's every copy and a later request precomputes again."""
    calls = []
    real = MA.barrett_precompute

    def counted(v, **kw):
        calls.append(int(v[0]))
        return real(v, **kw)
    monkeypatch.setattr(MA, "barrett_precompute", counted)
    mesh = MS.mesh_of(["cpu"] * 2)
    svc = ModArithService(2, e_limbs=1, batch_buckets=(2,), impl="blocked",
                          max_cached_moduli=1, mesh=mesh)
    v1, v2 = 65537, 1000003
    for v in (v1, v1, v2, v1):
        assert svc.reduce([123456789, 7], v) == [123456789 % v, 7]
    st = svc.stats()["ctx_cache"]
    assert (st["misses"], st["hits"], st["evictions"], st["size"]) == \
        (3, 1, 2, 1)
    assert len(calls) == 1 + 3                # the build's warm-up + 3
    assert list(svc.contexts(v1)) == [torch.device("cpu")]


@pytest.mark.parametrize("service", ["division", "modular"])
@pytest.mark.parametrize("buckets,shards", [((6,), 4), ((4, 6), 4),
                                            ((3,), 2)])
def test_bucket_not_divisible_raises(service, buckets, shards):
    mesh = MS.make_host_mesh(shards)
    cls = BigintDivisionService if service == "division" \
        else ModArithService
    with pytest.raises(ValueError, match="equal shards"):
        cls(4, batch_buckets=buckets, mesh=mesh)


def test_sharded_executable_splits_and_replicates():
    """Batched arguments split on rows in mesh order, a {device: tensor}
    argument gives each shard its own device's copy, outputs gather in
    row order; a call of the wrong row count raises."""
    seen = []

    def fn(c, x):
        seen.append((tuple(x[:, 0].tolist()), float(c)))
        return x * c, x + c
    fill = lambda dev, rows: (torch.ones((), device=dev),
                              torch.zeros(rows, 2, device=dev))
    mesh = MS.make_host_mesh(3)
    exe = BT.sharded(fn, fill, BT.kernel_plan("blocked"), device=None,
                     mesh=mesh, bucket=6, batched=(1,))
    assert isinstance(exe, BT.ShardedExecutable) and exe.rows == 2
    assert exe.static["shards"] == 3
    seen.clear()
    x = torch.arange(12.).reshape(6, 2)
    a, b = exe({torch.device("cpu"): torch.tensor(2.)}, x)
    assert torch.equal(a, x * 2) and torch.equal(b, x + 2)
    assert seen == [((0., 2.), 2.), ((4., 6.), 2.), ((8., 10.), 2.)]
    with pytest.raises(ValueError, match="rows"):
        exe(torch.tensor(2.), x[:4])
    assert BT.resolve_impl(None) == "cuda_fused"


def test_precompute_windowed_matches_jax():
    """barrett_precompute(windowed=False) against JAX's: the same mu
    (and the same as the windowed one)."""
    rnd = random.Random(3)
    m = 4
    jax_pre = jax.jit(partial(JMA.barrett_precompute, impl="blocked",
                              windowed=False))
    for v in (rnd.randrange(B ** (m - 1), B ** m), 3, B ** 2 + 1):
        j = jax_pre(jnp.asarray(jbi.from_int(v, m)))
        t = bi.limbs_from_numpy(bi.from_int(v, m), "cpu")
        p = MA.barrett_precompute(t, impl="blocked", windowed=False)
        w = MA.barrett_precompute(t, impl="blocked")
        assert np.array_equal(bi.limbs_to_numpy(p.mu), np.asarray(j.mu))
        assert torch.equal(p.mu, w.mu) and int(p.k) == int(j.k)


JAX_SCRIPT = r"""
import json, sys
from repro.launch.mesh import make_host_mesh
from repro.serving.bigint_service import BigintDivisionService
from repro.serving.modexp_service import ModArithService
req = json.loads(sys.stdin.read())
mesh = make_host_mesh((2, 1))
div = BigintDivisionService(8, mesh=mesh, impl="blocked",
                            batch_buckets=(4,), capture_profiles=False)
mod = ModArithService(4, mesh=mesh, impl="blocked", e_limbs=1,
                      batch_buckets=(4,), capture_profiles=False)
out = {"divmod": div.divide(req["us"], req["vs"])}
for op, cols, v in req["mod"]:
    out.setdefault(op, []).append(getattr(mod, op)(*cols, v))
print("JAX_OUT " + json.dumps(out))
"""


def _mesh_requests(seed):
    rnd = random.Random(seed)
    us, vs = _pairs(rnd, 6, 8)
    mod = []
    for v in (rnd.randrange(2, B ** 4) | 1, rnd.randrange(2, B ** 2)):
        xs = [rnd.randrange(B ** 8) for _ in range(5)]
        a = [rnd.randrange(B ** 4) for _ in range(3)]
        b = [rnd.randrange(B ** 4) for _ in range(3)]
        e = [rnd.randrange(B) for _ in range(3)]
        mod += [("reduce", [xs], v), ("modmul", [a, b], v),
                ("modexp", [a, e], v)]
    return {"us": us, "vs": vs, "mod": mod}


def test_sharded_services_match_jax_mesh():
    """The port's 2-shard services and the JAX services on a 2-device
    host mesh answer the same seeded requests alike."""
    req = _mesh_requests(5)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT],
                       input=json.dumps(req), env=env, capture_output=True,
                       text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JAX_OUT ")]
    assert r.returncode == 0 and line, r.stderr[-2000:]
    jax_out = json.loads(line[0][len("JAX_OUT "):])

    mesh = MS.make_host_mesh(2)
    div = BigintDivisionService(8, mesh=mesh, impl="blocked",
                                batch_buckets=(4,))
    mod = ModArithService(4, mesh=mesh, impl="blocked", e_limbs=1,
                          batch_buckets=(4,))
    q, rem = div.divide(req["us"], req["vs"])
    assert [q, rem] == jax_out["divmod"]
    assert list(zip(q, rem)) == [_divmod(u, v)
                                 for u, v in zip(req["us"], req["vs"])]
    got = {}
    for op, cols, v in req["mod"]:
        got.setdefault(op, []).append(getattr(mod, op)(*cols, v))
    assert got == {k: v for k, v in jax_out.items() if k != "divmod"}
