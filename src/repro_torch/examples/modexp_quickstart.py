"""Modular arithmetic quickstart on the port: one cached shifted
inverse, many division-free reductions.

Run:  python -m repro_torch.examples.modexp_quickstart [--device cpu]
(with PYTHONPATH=src from the repository root)
"""

import numpy as np

from repro_torch.core import bigint as bi
from repro_torch.core import modarith as MA
from repro_torch.examples.common import parse_device
from repro_torch.serving.modexp_service import ModArithService


def main(argv=None) -> None:
    dev = parse_device(__doc__, argv).device

    # -- 1. the shifted inverse IS a Barrett constant -------------------
    M = 64                                # 64 limbs x 16 bit = 1024 bits
    rng = np.random.default_rng(0)
    v = bi._rand_big(rng, bi.BASE ** (M - 1), bi.BASE ** M) | 1

    ctx = MA.barrett_precompute(bi.limbs_from_numpy(bi.from_int(v, M),
                                                    dev))
    print(f"context for a {v.bit_length()}-bit modulus on {dev}: "
          f"mu = shinv_{MA.barrett_h(M)}(v), prec {int(ctx.k)} limbs")

    # every reduction after this point is two truncated multiplications
    x = bi._rand_big(rng, 0, bi.BASE ** (2 * M))
    r = bi.batch_to_ints(MA.barrett_reduce(
        ctx, bi.limbs_from_numpy(bi.batch_from_ints([x], 2 * M), dev)))[0]
    assert r == x % v
    print(f"2048-bit x mod v exact: r has {r.bit_length()} bits")

    # -- 2. modexp: the ladder amortizes ONE shinv over ~2 bits
    #       reductions ----------------------------------------------------
    a, e = bi._rand_big(rng, 0, v), int(rng.integers(1, 2 ** 60))
    got = bi.batch_to_ints(MA.modexp(
        ctx, bi.limbs_from_numpy(bi.batch_from_ints([a], M), dev),
        bi.limbs_from_numpy(bi.batch_from_ints([e], 4), dev)))[0]
    assert got == pow(a, e, v)
    print(f"a^e mod v exact for a 60-bit exponent "
          f"(~{2 * e.bit_length()} division-free reductions)")

    # -- 3. the serving layer: per-modulus context cache + batching -----
    svc = ModArithService(m_limbs=M, e_limbs=4, batch_buckets=(8,),
                          device=dev)
    avs = [bi._rand_big(rng, 0, v) for _ in range(8)]
    evs = [int(rng.integers(0, 2 ** 48)) for _ in range(8)]
    out = svc.modexp(avs, evs, v)         # first call: precompute + serve
    assert out == [pow(ai, ei, v) for ai, ei in zip(avs, evs)]
    out = svc.modexp(avs, evs, v)         # second call: cache hit
    assert out == [pow(ai, ei, v) for ai, ei in zip(avs, evs)]
    print(f"served 2x8 modexp requests; context cache "
          f"hits={svc.ctx_hits} misses={svc.ctx_misses}")


if __name__ == "__main__":
    main()
