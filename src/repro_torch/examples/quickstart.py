"""Quickstart: the paper's algorithm on the port, then a peek inside.

Run:  python -m repro_torch.examples.quickstart [--device cpu]
(with PYTHONPATH=src from the repository root)
"""

import numpy as np

from repro_torch.core import bigint as bi
from repro_torch.core import pyref as R
from repro_torch.core import shinv as S
from repro_torch.examples.common import parse_device
from repro_torch.obs import costmodel as CM


def main(argv=None) -> None:
    dev = parse_device(__doc__, argv).device

    # -- 1. exact division of 4096-bit integers -------------------------
    M = 256                               # 256 limbs x 16 bit = 4096 bits
    rng = np.random.default_rng(0)
    u = bi._rand_big(rng, 0, bi.BASE ** M)
    v = bi._rand_big(rng, 1, bi.BASE ** (M // 2))

    q, r = S.divmod_batch(
        bi.limbs_from_numpy(bi.batch_from_ints([u], M), dev),
        bi.limbs_from_numpy(bi.batch_from_ints([v], M), dev))
    q, r = bi.batch_to_ints(q)[0], bi.batch_to_ints(r)[0]
    assert (q, r) == divmod(u, v)
    print(f"4096-bit division exact on {dev}: q has {q.bit_length()} "
          f"bits, r has {r.bit_length()} bits")

    # -- 2. the whole shifted inverse itself (Theorem 2) ----------------
    w = R.shinv(27183, 15, 10)            # paper Example 1, base 10
    print(f"shinv_15(27183) = {w} (paper: 36787698193)")
    assert w in (10 ** 15 // 27183, 10 ** 15 // 27183 + 1)

    # -- 3. the cost model: how many full multiplications? --------------
    c = R.CostCounter()
    R.divmod_shinv(u, v, bi.BASE, c)
    n = c.n_full_mults(M) + sum(1 for rec in c.records
                                if rec.where == "div-u*shinv"
                                and rec.prec_out > M)
    print(f"full multiplications used: {n} (paper Sec 2.3 predicts "
          f"{CM.DIV_FULL_MULTS_MIN}-{CM.DIV_FULL_MULTS_MAX})")
    print(f"work in units of one full MxM product: "
          f"{c.full_mult_equivalents(M):.2f}")
    print(f"kernel launches of one batched divmod on the card: "
          f"{CM.divmod_launches(M) + CM.prologue_launches()} (1 set-up + "
          f"2 x {CM.refine_iters(M)} Refine iterations + 1)")


if __name__ == "__main__":
    main()
