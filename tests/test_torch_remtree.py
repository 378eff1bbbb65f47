"""The batch-GCD remainder descent (`core/remtree.py`) against the plain
Python-int remainder tree (`core/remtree_ref.py`), seeded.

On the CPU: a 3-level descent (M = 32 -> 8 limbs) under the blocked
impl, eager and through a bucket executable; one level on edge lanes
(R = X^2 - 1, X = B^j - 1, X^2 a power of B, u < v, R = 0, u of all M
limbs); and the descent's dispatches tied to the cost model's launches.
The tests marked `cuda` skip without a card; on the card they run one
full level at 2^16 bits x 65,536 under cuda_fused against cuda_batched
and the reference, and a descent through the executable's graph:

    PYTHONPATH=src python -m pytest tests/test_torch_remtree.py -q
"""

from __future__ import annotations

import random

import pytest
import torch

from repro_torch.core import bigint as bi
from repro_torch.core import remtree as RT
from repro_torch.core import remtree_ref as REF
from repro_torch.core import shinv as S
from repro_torch.kernels import build, ops as K
from repro_torch.obs import costmodel as CM
from repro_torch.serving import batching as BT

B = bi.BASE


def _t(xs, m, dev="cpu"):
    return bi.limbs_from_numpy(bi.batch_from_ints(xs, m), dev)


def _odd_top(rnd, limbs):
    """An odd number of exactly `limbs` limbs with its top bit set."""
    bits = 16 * limbs
    return rnd.getrandbits(bits) | 1 | (1 << (bits - 1))


def _tree(rnd, m, top_nodes, levels, leaf_limbs):
    """(r_top, nodes): a product tree over odd leaves whose level i (from
    the top) has top_nodes * 2^i nodes of m / 2^(i+2) limbs, and the
    remainders above it, uniform below the parent's square."""
    bottom = top_nodes * 2 ** (levels - 1)
    per_node = (m // 2 ** (levels + 1)) // leaf_limbs
    nodes = [_odd_top(rnd, leaf_limbs) for _ in range(bottom * per_node)]
    while len(nodes) > bottom:
        nodes = REF.product_level(nodes)
    tree = [nodes]
    for _ in range(levels):
        tree.insert(0, REF.product_level(tree[0]))
    parents = tree.pop(0)
    r_top = [rnd.randrange(REF.square(x)) for x in parents]
    return r_top, tree


def _limbs_tree(r_top, tree, m):
    return (_t(r_top, m),
            [_t(level, m // 2 ** (i + 2)) for i, level in enumerate(tree)])


def _check(got, want, m):
    """descend's flat (q, r) per level against the reference's."""
    assert len(got) == 2 * len(want)
    for i, qr in enumerate(want):
        q, r = got[2 * i], got[2 * i + 1]
        assert q.shape[1] == m // 2 ** i and r.shape[1] == m // 2 ** (i + 1)
        assert bi.batch_to_ints(q) == [a for a, _ in qr], i
        assert bi.batch_to_ints(r) == [b for _, b in qr], i


@pytest.mark.parametrize("through", ["eager", "executable"])
def test_descend_matches_reference(through):
    rnd = random.Random(29)
    m, levels = 32, 3
    r_top, tree = _tree(rnd, m, top_nodes=4, levels=levels, leaf_limbs=2)
    r_t, xs = _limbs_tree(r_top, tree, m)
    if through == "eager":
        got = RT.descend(r_t, xs, impl="blocked")
    else:
        exe = BT.Executable(lambda r, *x: RT.descend(r, x, impl="blocked"),
                            (torch.zeros_like(r_t), *map(torch.ones_like,
                                                          xs)),
                            BT.kernel_plan("blocked"))
        got = exe(r_t, *xs)
    _check(got, REF.descend(r_top, tree), m)


@pytest.mark.parametrize("m", [16, 32])
def test_level_on_edge_lanes(m):
    """One level on lanes at the edges: each row of r_parent is the
    dividend of two nodes."""
    rnd = random.Random(m)
    j = m // 4
    full = B ** m - 1
    xs_big = [_odd_top(rnd, j) for _ in range(4)]
    cases = [
        (REF.square(xs_big[0]) - 1, xs_big[0], xs_big[1]),  # R = X^2 - 1
        (rnd.randrange(full), B ** j - 1, B ** j - 1),       # X = B^j - 1
        (full, B ** j - 1, B ** (j - 1)),                    # u all M limbs
        (rnd.randrange(full), B ** (j - 1), B),              # X^2 = B^k
        (12345, xs_big[2], 1),                               # u < v; X = 1
        (0, xs_big[3], B ** j - 1),                          # R = 0
        (full, 1, 3),                                        # q of M limbs
        (REF.square(B ** j - 1) - 1, B ** j - 1, xs_big[1]),
    ]
    r_parent = [u for u, _, _ in cases]
    nodes = [x for _, a, b in cases for x in (a, b)]
    q, r = RT.remainder_level(_t(r_parent, m), _t(nodes, j), impl="blocked")
    want = REF.remainder_level(r_parent, nodes)
    assert bi.batch_to_ints(q) == [a for a, _ in want]
    assert bi.batch_to_ints(r) == [b for _, b in want]
    assert max(REF.square(x) for x in nodes) < B ** (m // 2)


def test_descent_dispatches_match_the_cost_model(monkeypatch):
    """Under cuda_fused each level is one square (`mul_batch`), one
    division set-up, refine_iters(M) Refine steps and one finalization:
    `costmodel.divmod_launches` + `prologue_launches` + one product's
    launches per level, counted here at the dispatch points the card's
    launches are made from."""
    impl = "cuda_fused"
    per = {"prologue": CM.prologue_launches(impl),
           "step": CM.step_launches(impl),
           "correct": CM.FUSED_CORRECT_LAUNCHES,
           "mul": CM.mul_launches(impl)}
    seen = dict.fromkeys(per, 0)

    def counted(name, fn):
        def wrapped(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(S, "prologue_plain",
                        counted("prologue", S.prologue_plain))
    monkeypatch.setattr(K, "fused_step", counted("step", K.fused_step))
    monkeypatch.setattr(K, "fused_correct",
                        counted("correct", K.fused_correct))
    monkeypatch.setattr(K, "mul_batch", counted("mul", K.mul_batch))
    rnd = random.Random(3)
    m, levels = 64, 3
    r_top, tree = _tree(rnd, m, top_nodes=2, levels=levels, leaf_limbs=2)
    got = RT.descend(*_limbs_tree(r_top, tree, m), impl=impl)
    _check(got, REF.descend(r_top, tree), m)
    widths = [m // 2 ** i for i in range(levels)]
    assert seen["mul"] == levels and seen["prologue"] == levels
    assert seen["step"] == sum(CM.refine_iters(w) for w in widths)
    launches = sum(per[k] * n for k, n in seen.items())
    assert launches == sum(CM.divmod_launches(w, impl)
                           + CM.prologue_launches(impl)
                           + CM.mul_launches(impl) for w in widths)


def test_level_refuses_unpaired_parents():
    x = torch.ones(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        RT.remainder_level(torch.zeros(3, 8, dtype=torch.int32), x)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _random_limbs(gen, n, width, dev):
    return torch.randint(0, B, (n, width), generator=gen, device=dev,
                         dtype=torch.int32)


@pytest.mark.cuda
def test_full_level_on_card(dev):
    """2^16 bits x 65,536 nodes under cuda_fused: 64 sampled lanes (32
    parents with both children) equal cuda_batched's and the Python
    reference's; the level's launches equal the cost model's."""
    m, n = 4096, 65536
    gen = torch.Generator(device=dev)
    gen.manual_seed(2 ** 31 + 29)
    x = _random_limbs(gen, n, m // 4, dev)
    x[:, 0] |= 1
    x[:, -1] |= 0x8000
    r_parent = _random_limbs(gen, n // 2, m, dev)
    r_parent[:, -1] = 0                      # below every parent's square
    r_parent[0] = B - 1                      # u of all M limbs
    build.reset_launch_counts()
    q, r = RT.remainder_level(r_parent, x, impl="cuda_fused")
    torch.cuda.synchronize()
    got = build.launch_counts()
    assert sum(got.values()) == (CM.divmod_launches(m) + CM.prologue_launches()
                                 + CM.mul_launches()), got
    parents = sorted(random.Random(7).sample(range(1, n // 2), 31)) + [0]
    lanes = [c for p in sorted(parents) for c in (2 * p, 2 * p + 1)]
    at = torch.tensor(lanes, device=dev)
    pt = torch.tensor(sorted(parents), device=dev)
    qb, rb = RT.remainder_level(r_parent[pt], x[at], impl="cuda_batched")
    assert torch.equal(q[at], qb) and torch.equal(r[at], rb)
    want = REF.remainder_level(bi.batch_to_ints(r_parent[pt]),
                               bi.batch_to_ints(x[at]))
    assert bi.batch_to_ints(q[at]) == [a for a, _ in want]
    assert bi.batch_to_ints(r[at]) == [b for _, b in want]


@pytest.mark.cuda
def test_descent_graph_on_card(dev):
    """A 3-level descent (2,048 -> 512 limbs) through one bucket
    executable: its replay equals the eager call and the reference, and
    the graph records the cost model's launches."""
    rnd = random.Random(11)
    m, levels = 2048, 3
    r_top, tree = _tree(rnd, m, top_nodes=8, levels=levels, leaf_limbs=64)
    r_t, xs = _limbs_tree(r_top, tree, m)
    r_t, xs = r_t.to(dev), [x.to(dev) for x in xs]
    fn = lambda r, *x: RT.descend(r, x, impl="cuda_fused")
    exe = BT.Executable(fn, (torch.zeros_like(r_t),
                             *map(torch.ones_like, xs)),
                        BT.kernel_plan("cuda_fused"))
    got = exe(r_t, *xs)
    eager = fn(r_t, *xs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    _check([t.cpu() for t in got], REF.descend(r_top, tree), m)
    assert sum(exe.launches.values()) == sum(
        CM.divmod_launches(m // 2 ** i) + CM.prologue_launches()
        + CM.mul_launches() for i in range(levels))
    assert exe.launches.get("mul_batch") == levels
