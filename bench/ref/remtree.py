"""Plain Python-int remainder tree for the `remtree` cells: a copy of
`repro_torch/core/remtree_ref.py` (the product of a node's leaves, the
square, the chain R_child = R_parent mod X_child^2), and the divisions
on root-to-leaf paths that the runner checks.  Only the standard
library."""

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


def path_divisions(r_top: dict, leaves: dict, lanes, divisor=square) -> dict:
    """{(level, lane): (q, r)}: the division of each node on the checked
    paths, u the remainder of its parent's division in this same chain,
    divmod(u, divisor(X)).

    r_top maps a row p above level 0 to its remainder, leaves maps p to
    the leaves under it in order; lanes[i] holds the level-i nodes on
    the paths, each with its parent in lanes[i - 1].  Node j of level i
    lies under row j >> (i + 1), and is the product of its share of that
    row's leaves.  `divisor` is the square for batch GCD's tree; the
    control passes X itself, the plain remainder tree's divisor."""
    out: dict = {}
    for i, level in enumerate(lanes):
        for j in sorted(level):
            p = j >> (i + 1)
            per = len(leaves[p]) >> (i + 1)
            k = j - (p << (i + 1))
            v = divisor(node_product(leaves[p][k * per:(k + 1) * per]))
            u = r_top[p] if i == 0 else out[(i - 1, j >> 1)][1]
            out[(i, j)] = divmod(u, v) if v else (0, u)
    return out
