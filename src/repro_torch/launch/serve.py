"""Serving launcher CLI, the port of `repro/launch/serve.py`: two services.

  LM decode demo (reduced config, greedy sampling):
    python -m repro_torch.launch.serve --arch smollm-135m --tokens 32

  Batched big-integer division service (the paper's workload):
    python -m repro_torch.launch.serve --bigint --limbs 256 --batch 64

Both run on the card unless `--device cpu` asks for the CPU.  The LM
path runs every registered arch, as JAX's does: whisper decodes over the
zero cross cache `init_cache` gives (no encoder pass).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import transformer as T


def serve_lm(args) -> list[list[int]]:
    """Greedy decode of args.tokens steps at batch args.batch from token
    0, over random weights (seed 0) of the reduced config.  Returns each
    step's tokens."""
    cfg = configs.get_config(args.arch).reduced()
    model = T.init_params(cfg, 0, args.device)
    cache = T.init_cache(cfg, args.batch, args.tokens + 8, args.device)
    tok = torch.zeros((args.batch,), dtype=torch.long, device=args.device)
    out = []
    t0 = time.perf_counter()
    for i in range(args.tokens):
        logits, cache = T.forward_decode(model, cache, {"token": tok}, i)
        tok = logits[:, : cfg.vocab].argmax(-1)
        out.append(tok.tolist())
    dt = time.perf_counter() - t0
    print(f"decoded {args.tokens} tokens x batch {args.batch} in "
          f"{dt*1e3:.0f} ms ({args.tokens*args.batch/dt:.0f} tok/s) on "
          f"{args.device.type}")
    print("sample:", [x[0] for x in out[:16]])
    return out


def serve_bigint(args) -> None:
    from repro_torch.core import bigint as bi
    from repro_torch.serving.bigint_service import BigintDivisionService
    svc = BigintDivisionService(m_limbs=args.limbs, device=args.device)
    rng = np.random.default_rng(0)
    us = [bi._rand_big(rng, 0, bi.BASE ** (args.limbs - 2))
          for _ in range(args.batch)]
    vs = [bi._rand_big(rng, 1, bi.BASE ** (args.limbs // 2))
          for _ in range(args.batch)]
    svc.divide(us[:4], vs[:4])            # warm
    t0 = time.perf_counter()
    q, r = svc.divide(us, vs)
    dt = time.perf_counter() - t0
    if not all(u == qq * vv + rr and 0 <= rr < vv
               for u, vv, qq, rr in zip(us, vs, q, r)):
        raise AssertionError("a division is not exact")
    print(f"divided {args.batch} x {args.limbs*16}-bit ints in "
          f"{dt*1e3:.0f} ms ({args.batch/dt:.0f} div/s) on "
          f"{args.device.type}, all exact")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m",
                    choices=configs.list_archs())
    ap.add_argument("--bigint", action="store_true")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--limbs", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    if args.bigint:
        serve_bigint(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
