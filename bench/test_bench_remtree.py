"""CPU tests of the `remtree` runner and what it reads: a 3-level tiny
copy of `batchgcd-ahead` (M = 32 -> 8 limbs) comes out correct, its
control and faults planted in the square and in the division come out
not correct; a window shorter than its kept calls checks every call; the reference copy equals the port's; the remainders above
the top are drawn below their bound from the seed; the squares'
yardstick; and the readers of the remainder tree's spans and of the
product kernel's roofline on synthetic traces."""

from __future__ import annotations

import json
import random
import time
from pathlib import Path

import pytest
import torch

from bench.harness import base
from bench.harness import main as M
from bench.harness import spec as SP
from bench.harness import trace as TR
from bench.ref import remtree as RREF
from bench.yardstick import costmodel as Y
from bench.yardstick import roofline as RL
from bench.yardstick import squares as SQ
from repro_torch.obs import telemetry as T

ROOT = Path(__file__).resolve().parents[1]
CELL = "batchgcd-ahead"
MS = 1_000_000


@pytest.fixture(scope="module")
def tree_root(tmp_path_factory):
    """A checkout-shaped directory whose batchgcd configuration is cut to
    3 levels of 4, 8 and 16 nodes (M = 32, 16, 8) and whose mix checks
    every bottom node's path."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tree")
    spec = SP.load(ROOT)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    work = {w["name"]: w for w in spec["workloads"]}[CELL]
    cfg_file = {c["name"]: c for c in spec["configs"]}[work["config"]]["file"]
    cfg = json.loads((ROOT / cfg_file).read_text())
    cfg.update(m_limbs=32, instances=4, levels=3)
    (root / cfg_file).parent.mkdir(parents=True)
    (root / cfg_file).write_text(json.dumps(cfg))
    tr_file = Path("bench") / "traffic" / f"{work['traffic']}.json"
    tr = json.loads((ROOT / tr_file).read_text())
    tr.update(pool_batches=2, check_calls=2, check_lanes=16)
    (root / tr_file).parent.mkdir(parents=True)
    (root / tr_file).write_text(json.dumps(tr))
    return root


def run_tree(root, seed=2 ** 33 + 5, control=False):
    return M.run_cell(SP.cell(root, CELL), seed, 2.0, False,
                      torch.device("cpu"), time.perf_counter(),
                      control=control)


def test_three_level_run_is_correct(tree_root):
    out = run_tree(tree_root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["attempted"] % (4 + 8 + 16) == 0
    # two calls, each 16 paths down 3 levels: 4 + 8 + 16 divisions
    assert out["checked"] == {"checked_divisions": 2 * 28}


def test_short_window_checks_every_call(tree_root, tmp_path):
    """A window that runs fewer calls than `check_calls` checks each of
    them and counts none unchecked."""
    import shutil
    root = tmp_path / "root"
    shutil.copytree(tree_root, root)
    tr_file = root / "bench" / "traffic" / "remtree-ahead.json"
    tr_file.write_text(json.dumps(dict(json.loads(tr_file.read_text()),
                                       check_calls=10 ** 6)))
    out = M.run_cell(SP.cell(root, CELL), 2 ** 33 + 5, 0.5, False,
                     torch.device("cpu"), time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["checks"]["unchecked_calls"]["value"] == 0
    calls = out["attempted"] // 28
    assert out["checked"] == {"checked_divisions": calls * 28}


@pytest.mark.parametrize("seed", [1, 2 ** 40 + 3])
def test_three_level_control_is_not_correct(tree_root, seed):
    out = run_tree(tree_root, seed=seed, control=True)
    assert not out["correct"], out["checks"]
    assert out["checks"]["wrong_divisions"]["value"] > 0


def _alter(out):
    q = out[0].clone() if isinstance(out, tuple) else out.clone()
    q[0, 0] ^= 1
    return (q,) + tuple(out[1:]) if isinstance(out, tuple) else q


@pytest.mark.parametrize("where", ["square", "division"])
def test_planted_fault_is_not_correct(tree_root, monkeypatch, where):
    """A fault in lane 0 of the product (the squares and the tree the
    set-up builds) or of the division's quotient is seen."""
    from repro_torch.core import shinv
    from repro_torch.kernels import ops
    mod, name = (ops, "mul_batch") if where == "square" \
        else (shinv, "divmod_batch")
    orig = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: _alter(orig(*a, **k)))
    out = run_tree(tree_root)
    assert not out["correct"], out["checks"]


def test_fault_in_the_remainder_is_not_correct(tree_root, monkeypatch):
    from repro_torch.core import shinv
    orig = shinv.divmod_batch

    def wrong_r(*a, **k):
        q, r = orig(*a, **k)
        r = r.clone()
        r[-1, 0] ^= 1
        return q, r

    monkeypatch.setattr(shinv, "divmod_batch", wrong_r)
    assert not run_tree(tree_root)["correct"]


# ---------------------------------------------------------------------------
# the reference, the operands and the yardstick
# ---------------------------------------------------------------------------

def test_reference_copy_equals_the_ports():
    from repro_torch.core import remtree_ref as PORT
    rnd = random.Random(5)
    leaves = [rnd.getrandbits(64) | 1 | 1 << 63 for _ in range(32)]
    tree = [leaves]
    while len(tree[0]) > 2:
        tree.insert(0, RREF.product_level(tree[0]))
    assert tree[0] == PORT.product_level(tree[1])
    parents = RREF.product_level(tree[0])
    r_top = [rnd.randrange(RREF.square(x)) for x in parents]
    want = PORT.descend(r_top, tree)
    assert RREF.descend(r_top, tree) == want
    # the paths' divisions rebuild each node from its leaves
    lanes = [{0}, {0, 1}, {1, 2}, {3, 5}, {6, 10}]
    div = RREF.path_divisions({0: r_top[0]}, {0: leaves}, lanes)
    assert div == {(i, j): want[i][j] for i, js in enumerate(lanes)
                   for j in js}
    plain = RREF.path_divisions({0: r_top[0]}, {0: leaves}, lanes,
                                divisor=lambda x: x)
    assert plain[(0, 0)] == divmod(r_top[0], tree[0][0])


def test_remainders_above_the_top_are_below_their_bound():
    from bench.runners import remtree as R
    gen = torch.Generator().manual_seed(3)
    rnd = random.Random(4)
    xs = [rnd.getrandbits(120) | 1 << 119 for _ in range(60)] + [1, 2, 65536]
    bound = torch.tensor([[(x >> 16 * i) & 0xFFFF for i in range(8)]
                          for x in xs], dtype=torch.int32)
    r = R.uniform_below(torch, bound, gen)
    got = [sum(int(v) << 16 * i for i, v in enumerate(row))
           for row in r.tolist()]
    assert all(0 <= g < x for g, x in zip(got, xs))
    assert got[-3] == 0 and got[-2] in (0, 1)
    assert len(set(got[:60])) == 60
    again = R.uniform_below(torch, bound, torch.Generator().manual_seed(3))
    assert torch.equal(r, again)


def test_level_shapes_stop_at_eight_limbs():
    from bench.runners import remtree as R
    cfg = json.loads((ROOT / "bench/configs/batchgcd-rsa1024.json")
                     .read_text())
    assert R.level_shapes(cfg) == [(16384, 16384), (8192, 32768),
                                   (4096, 65536), (2048, 131072)]
    assert sum(m * 16 * n for m, n in R.level_shapes(cfg)) == 4 * 2 ** 32
    assert R.level_shapes(dict(cfg, m_limbs=8, instances=4)) == [(8, 4)]
    assert R.level_shapes(dict(cfg, m_limbs=32, instances=4, levels=3)) \
        == [(32, 4), (16, 8), (8, 16)]


def test_squares_yardstick():
    # p(p + 1)/2 distinct products at each node's own length, X read
    # and X^2 written
    assert SQ.squares_needed([3, 3, 2], 16) == (15, 3 * 4 * (4 + 8))
    for p in range(1, 9):
        pairs = {(min(i, j), max(i, j)) for i in range(p) for j in range(p)}
        assert SQ.square_lane_products(p) == len(pairs)
        assert 2 * SQ.square_lane_products(p) - p \
            == Y.cut_products(p, p, 2 * p)          # the a x b count
    # the least time of one descent's squares at 2^18..2^15 bits
    shapes = [(16384, 16384), (8192, 32768), (4096, 65536), (2048, 131072)]
    work = [SQ.squares_needed([m // 4] * n, m) for m, n in shapes]
    products = sum(w[0] for w in work)
    assert products == sum(n * (m // 4) * (m // 4 + 1) // 2
                           for m, n in shapes)
    assert RL.bound(products, sum(w[1] for w in work))[1] == "operations"


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _descent(t0: int, call: int, ids) -> list:
    """One replay's spans from t0 (ns): two levels, each a 3-ms square,
    a 1-ms hand-off and a 40-ms division."""
    out: list = []

    def span(name, a, b, parent):
        sid = next(ids)
        out.append(T.Span(name, t0 + a * MS, t0 + b * MS, parent, call, sid,
                          True))
        return sid

    root = span("remtree", 0, 88, None)
    for k in range(2):
        t = 44 * k
        span("remtree/square", t, t + 3, root)
        span("remtree/handoff", t + 3, t + 4, root)
        span("divmod", t + 4, t + 44, root)
    return out


@pytest.fixture
def logged(monkeypatch):
    ids = iter(range(1, 1000))
    spans = (_descent(0, 1, ids) + _descent(200 * MS, 2, ids)
             + _descent(300 * MS, 3, ids))
    monkeypatch.setattr(T, "span_log", lambda: list(spans))
    return base.Run(trace=TR.Trace(start=150 * MS, end=500 * MS))


@pytest.mark.parametrize("name,want", [("square_ms_per_call", 6.0),
                                       ("handoff_ms_per_call", 2.0)])
def test_span_readers(logged, monkeypatch, name, want):
    read = SP.reader(name)
    assert read(logged) == pytest.approx(want)
    logged.trace = TR.Trace(start=500 * MS, end=600 * MS)
    assert read(logged) is None                       # outside the window
    assert read(base.Run()) is None                   # untraced
    monkeypatch.setattr(T, "span_log", lambda: [
        s for s in _descent(200 * MS, 2, iter(range(9)))
        if s.name == "divmod"])                       # no remtree spans
    assert read(base.Run(trace=TR.Trace(start=0, end=10 ** 12))) is None


def test_mul_roofline_reader():
    read = SP.reader("mul_roofline_pct")
    tr = TR.Trace(start=0, end=10 * MS, device=[
        ("void mul_batch_kernel(int const*, int const*)", "kernel", MS,
         3 * MS),
        ("void correct_kernel(int const*)", "kernel", 3 * MS, 9 * MS)])
    run = base.Run(trace=tr)
    assert read(run) is None                          # no squares counted
    run.square_work = (2 ** 30, 2 ** 20)
    want = 100 * RL.bound(2 ** 30, 2 ** 20)[0] / 2e-3
    assert read(run) == pytest.approx(want)
    run.trace = TR.Trace(start=0, end=10 * MS)
    assert read(run) is None                          # no product kernel
