"""Plain Python-int remainder tree: the reference `core/remtree.py` is
held to.  Python ints only; nothing of torch, the port's kernels or JAX.

The product tree multiplies the leaves in pairs, level by level; the
remainder tree walks down it with R_child = R_parent mod X_child^2
(Bernstein 2004; the batch-GCD descent of Heninger et al. 2012)."""

from __future__ import annotations


def node_product(leaves) -> int:
    """The product of a node's leaves: its X in the product tree."""
    out = 1
    for x in leaves:
        out *= x
    return out


def product_level(nodes) -> list[int]:
    """The level above `nodes` (an even count): products of pairs."""
    return [nodes[i] * nodes[i + 1] for i in range(0, len(nodes), 2)]


def square(x: int) -> int:
    return x * x


def remainder_level(r_parent, nodes) -> list[tuple[int, int]]:
    """(q, r) = divmod(u, X^2) for every node X, u its parent's remainder
    (row j of r_parent above nodes 2j and 2j + 1); divmod(u, 0) = (0, u)
    as the port divides."""
    out = []
    for i, x in enumerate(nodes):
        u, v = r_parent[i // 2], square(x)
        out.append(divmod(u, v) if v else (0, u))
    return out


def descend(r_top, levels) -> list[list[tuple[int, int]]]:
    """Each level's [(q, r)] from the top down: levels[i] lists level i's
    nodes, twice as many as the level above, and r_top the remainders
    above level 0."""
    out, r = [], list(r_top)
    for nodes in levels:
        qr = remainder_level(r, nodes)
        out.append(qr)
        r = [rem for _, rem in qr]
    return out
