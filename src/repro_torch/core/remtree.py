"""Bernstein's remainder tree on the card: the descent half of batch GCD.

Batch GCD (Heninger et al., "Mining Your Ps and Qs", USENIX Security
2012; Bernstein, "How to find smooth parts of integers", 2004) finds
RSA moduli that share a prime.  It multiplies the moduli up a product
tree, then walks a remainder tree down it: at each node X, with R the
parent's remainder, R_child = R mod X^2.

A level here is one batched division.  With X of M/4 limbs per node,
the divisor X^2 fits M/2 limbs and the parent's remainder, below the
parent's square, fits M: so the level divides at bucket width M, and
the next level down at M/2.  Rows are nodes in tree order, so the two
children of parent row j are rows 2j and 2j + 1.

`remainder_level` does one level: the square (`kernels/ops.py:mul_batch`;
under cuda_fused the batched product kernel), the hand-off (the
parent's remainders narrowed or zero-padded to M, one copy per child)
and `core/shinv.py:divmod_batch` at M.  `descend` runs the levels from
the top down with nothing read back between them, so one bucket
executable (`serving/batching.py:Executable`) captures the whole
descent as one CUDA graph.

Spans (`obs/telemetry.py:scope`, device marks under a capture):
`remtree` over a descent, and per level `remtree/square` (the square
and its widening to M) and `remtree/handoff`, beside the division's own
`divmod` spans.  `impl` picks the rung of the impl registry as
everywhere in the port.
"""

from __future__ import annotations

import torch

from . import shinv as S
from repro_torch.kernels import ops as K
from repro_torch.obs import telemetry as T


def _fit(x: torch.Tensor, width: int) -> torch.Tensor:
    """x's rows at `width` limbs: narrowed (the limbs dropped must be
    zero for the value to survive) or zero-padded."""
    if x.shape[1] >= width:
        return x[:, :width]
    return torch.nn.functional.pad(x, (0, width - x.shape[1]))


def remainder_level(r_parent: torch.Tensor, x: torch.Tensor,
                    impl: str | None = None):
    """One level of the descent: (q, r) with u = q X^2 + r, 0 <= r < X^2,
    for each node, u its parent's remainder.

    x: (n, M/4) int32 limbs, the level's n nodes (n even, each X >= 1:
    a product of leaves; divmod(u, 0) = (0, u) would not fit M/2 limbs
    in general); r_parent: (n/2, w) limbs, row j the remainder of the
    parent of rows 2j and 2j + 1, any width w whose limbs from M up are
    zero.  Returns q at M
    limbs (the bucket's) and r at M/2 (X^2 < B^(M/2)), the width the
    next level's nodes square to."""
    n, quarter = x.shape
    m = 4 * quarter
    if n % 2 or r_parent.shape[0] * 2 != n:
        raise ValueError(f"{r_parent.shape[0]} parent remainders for {n} "
                         f"nodes: expected one for every two")
    with T.scope("remtree/square"):
        v = _fit(K.mul_batch(x, x, m // 2, impl), m)
    with T.scope("remtree/handoff"):
        u = _fit(r_parent, m).repeat_interleave(2, dim=0)
    q, r = S.divmod_batch(u, v, impl=impl)
    return q, r[:, :m // 2]


def descend(r_top: torch.Tensor, xs, impl: str | None = None) -> tuple:
    """The remainder tree's descent through the levels `xs`, top down:
    xs[i] holds level i's nodes, (n * 2^i, M / (4 * 2^i)) limbs, and
    r_top the n remainders above level 0.  Each level's remainders are
    the next level's dividends, on the device.

    Returns (q_0, r_0, q_1, r_1, ...): each level's quotients at its
    bucket width and remainders at the next level's (`remainder_level`).
    Batch GCD reads the remainders; the quotients come with them as the
    division gives them, so that each division can be held to
    u = q X^2 + r."""
    out = []
    r = r_top
    with T.scope("remtree"):
        for x in xs:
            q, r = remainder_level(r, x, impl)
            out += [q, r]
    return tuple(out)
