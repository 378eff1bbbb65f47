"""Dry run of the paper's own workload on the production layout: batched
whole-shifted-inverse division, instances sharded flat over every shard
of the layout (the paper's Num Insts axis over the data x model axes).
The port of `repro/launch/bigint_dryrun.py`.

    python -m repro_torch.launch.bigint_dryrun [--limbs 512]
        [--insts 4096] [--multi-pod] [--shards N] [--device cuda|cpu]
        [--out PATH]

Under pure batch sharding every shard runs the same program on insts /
shards rows and nothing crosses between shards, so the dry run builds
ONE shard's divmod executable (`serving/batching.py:Executable`: on the
card the eager warm-up, the CUDA graph's capture and instantiation)
and replays it once on seeded rows.  The record has the JAX dry run's
keys:

  compile_s       the executable's build (warm-up + capture +
                  instantiate on the card; one eager call on the CPU)
  memory          peak_bytes_est: the graph's pool plus the static
                  inputs and outputs (on the CPU the inputs and outputs
                  alone, counted from their shapes)
  roofline        per shard, from the paper's multiplication cost model
                  (`obs/costmodel.py:divmod_work`, every operand at its
                  full window) over the H100's peaks (`obs/roofline.py`)

and the port's: the shard count and rows, `launches` (the replay's,
per shard, beside `costmodel.divmod_launches` and the set-up's
`prologue_launches`), whether every row's
answer equals Python's divmod (`exact`), the replay's time and the
device.  The default output is JAX's, under `results/`, which git
ignores.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from functools import partial

import numpy as np
import torch

from repro_torch.core import bigint as bi
from repro_torch.core import shinv as S
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.obs import costmodel as CM
from repro_torch.obs import roofline as RL
from repro_torch.serving import batching as BT

DEFAULT_OUT = "results/dryrun/bigint_div.json"


def shard_rows(m: int, rows: int):
    """(us, vs) of one shard: full-width dividends and divisors of
    random length (at least one limb), from numpy seed 0."""
    rng = np.random.default_rng(0)
    us = bi.random_ints(rng, rows, m, exact_prec=True)
    vs = [max(v, 1) for v in bi.random_ints(rng, rows, m)]
    return us, vs


def run(limbs: int, insts: int, *, multi_pod: bool = False,
        shards: int | None = None, device="cuda") -> dict:
    """The dry-run record of one shard of `insts` divisions of `limbs`
    limbs over the production layout (or `shards` shards), under the
    default impl (cuda_fused; JAX's dry run takes its default too)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run on 'cuda' needs a CUDA device; "
                           "pass --device cpu for the plain versions")
    impl = BT.resolve_impl(None)
    shape, axes, n = make_production_mesh(multi_pod=multi_pod)
    shards = shards or n
    if insts % shards:
        raise ValueError(f"{insts} instances do not split into {shards} "
                         f"equal shards")
    rows = insts // shards
    S.check_width(device, limbs, impl)
    us, vs = shard_rows(limbs, rows)
    u = bi.limbs_from_numpy(bi.batch_from_ints(us, limbs), "cpu")
    v = bi.limbs_from_numpy(bi.batch_from_ints(vs, limbs), "cpu")
    fill = (torch.zeros_like(u, device=device),
            torch.zeros_like(v, device=device))
    fill[1][:, 0] = 1                         # the services' fill: v = 1

    t0 = time.perf_counter()
    exe = BT.Executable(partial(S.divmod_batch, impl=impl), fill,
                        BT.kernel_plan(impl))
    compile_s = time.perf_counter() - t0

    with build.recording() as rec:
        t0 = time.perf_counter()
        q, r = exe(u, v)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        replay_s = time.perf_counter() - t0
    qs, rs = bi.batch_to_ints(q), bi.batch_to_ints(r)
    exact = all((qq, rr) == divmod(uu, vv)
                for qq, rr, uu, vv in zip(qs, rs, us, vs))

    io_bytes = 4 * rows * limbs * 4          # u, v in; q, r out
    work = CM.divmod_work(limbs, rows, impl)
    terms = RL.roofline_terms(work)
    return {
        "arch": "bigint-div (paper workload)",
        "bits": limbs * 16, "insts": insts,
        "mesh": "multi" if multi_pod else "single",
        "status": "ok" if exact else "inexact",
        "compile_s": round(compile_s, 3),
        "memory": {"peak_bytes_est": (exe.memory_bytes or 0) + io_bytes},
        "roofline": terms,
        "mesh_shape": dict(zip(axes, shape)),
        "shards": shards, "rows_per_shard": rows, "impl": impl,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "launches": {"per_shard": sum(rec.values()),
                     "model": CM.divmod_launches(limbs, impl),
                     "prologue": CM.prologue_launches(impl),
                     "by_kernel": dict(rec)},
        "launch_work": [list(w) for w in work],
        "exact": exact,
        "replay_s": replay_s,
        "capture_s": exe.capture_seconds,
        "instantiate_s": exe.instantiate_seconds,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--limbs", type=int, default=512)    # 2^13 bits
    ap.add_argument("--insts", type=int, default=4096)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--shards", type=int, default=None,
                    help="shard count (default: the production layout's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rec = run(args.limbs, args.insts, multi_pod=args.multi_pod,
              shards=args.shards, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in rec if k != "launch_work"},
                     indent=1))
    if not rec["exact"]:
        raise SystemExit("dry run: a shard's answer differs from divmod")
    return rec


if __name__ == "__main__":
    main()
