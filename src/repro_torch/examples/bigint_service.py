"""End to end: a batched multi-precision division service on the port,
unsharded and through a 2-shard mesh.

The serving shape of the paper's workload: a stream of independent
(u, v) division requests at one precision, batched into bucket
executables (a CUDA graph each on the card) and, under a mesh, split
over its shards.  Exactness is verified per response.

Run:  python -m repro_torch.examples.bigint_service [--device cpu]
(with PYTHONPATH=src from the repository root)
"""

import numpy as np
import torch

from repro_torch.core import bigint as bi
from repro_torch.examples.common import parse_device
from repro_torch.launch import mesh as MS
from repro_torch.obs import report
from repro_torch.obs.telemetry import timer
from repro_torch.serving.bigint_service import BigintDivisionService

M_LIMBS = 256                     # 4096-bit service
BATCHES = 5
BATCH = 64


def two_shards(dev) -> MS.DeviceMesh:
    """Two shards: two cards where there are, else the one device twice
    (each shard its own graph and stream)."""
    if dev.type == "cpu":
        return MS.make_host_mesh(2)
    if torch.cuda.device_count() >= 2:
        return MS.make_device_mesh(2)
    return MS.mesh_of([dev, dev])


def serve(svc, rng, label: str) -> None:
    print(f"{label}: {M_LIMBS * 16}-bit, batch {BATCH}")
    total = 0.0
    for step in range(BATCHES):
        us = [bi._rand_big(rng, 0, bi.BASE ** (M_LIMBS - 2))
              for _ in range(BATCH)]
        vs = [bi._rand_big(rng, 1, bi.BASE ** (M_LIMBS // 2))
              for _ in range(BATCH)]
        with timer() as t:
            q, r = svc.divide(us, vs)
        ok = all(u == qq * vv + rr and 0 <= rr < vv
                 for u, vv, qq, rr in zip(us, vs, q, r))
        assert ok
        if step > 0:              # skip the bucket's build in the average
            total += t.seconds
        print(f"  batch {step}: {t.seconds * 1e3:7.1f} ms  exact={ok}")
    print(f"steady-state: {BATCH * (BATCHES - 1) / total:.0f} divisions/s")


def main(argv=None) -> None:
    dev = parse_device(__doc__, argv).device
    rng = np.random.default_rng(42)
    svc = BigintDivisionService(m_limbs=M_LIMBS, batch_buckets=(64,),
                                device=dev)
    serve(svc, rng, f"bigint division service on {dev}")

    mesh = two_shards(dev)
    sharded = BigintDivisionService(m_limbs=M_LIMBS, batch_buckets=(64,),
                                    mesh=mesh)
    serve(sharded, rng, f"the same service over {mesh.size} shards "
          f"({', '.join(str(d) for d in mesh.devices)})")

    # -- observability: runtime counters + measured-vs-model snapshot ---
    for s in (svc, sharded):
        st = s.stats()
        print(f"\nrequests={st['requests']}  "
              f"pad_waste={st['pad_waste']:.3f}  "
              f"compiles={st['bucket_compiles']} "
              f"reuses={st['bucket_reuses']}")
        print(report.render_measured_vs_model(s.snapshot()))


if __name__ == "__main__":
    main()
