"""CPU tests of the benchmark harness: every cell resolves to its files,
the traffic is the seed's, the reference holds on edge lanes, the
controls and planted faults come out not correct, nothing the benchmark
runs loads JAX or the JAX package, and `run.py` without a card measures
nothing.  A tiny copy of each configuration runs the whole harness on
the CPU with the port's plain versions (no card is looked for there)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.harness import spec as SP
from bench.harness import traffic as TF
from bench.harness import main as M
from bench.ref import reference as REF

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
B = REF.BASE

# tiny sizes of each configuration and mix, for the CPU
TINY_CONFIG = dict(m_limbs=8, instances=4, working_width=16,
                   operands={"u_limbs": [6, 6], "v_limbs": [2, 4]})
TINY_TRAFFIC = dict(pool_batches=4, check_calls=3, check_lanes=4)
CELLS = [w["name"] for w in SP.load(ROOT)["workloads"]]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout-shaped directory: BENCHMARK.json as it stands, each
    configuration and traffic file cut to CPU sizes."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("tiny")
    (root / "bench" / "configs").mkdir(parents=True)
    (root / "bench" / "traffic").mkdir(parents=True)
    spec = SP.load(ROOT)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY_CONFIG)
        (root / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        tr = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        tr.update(TINY_TRAFFIC)
        (root / "bench" / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tr))
    return root


def run_tiny(root, workload, seed=2 ** 31 + 11, seconds=0.4, control=False):
    import time
    return M.run_cell(SP.cell(root, workload), seed, seconds, False,
                      torch.device("cpu"), time.perf_counter(),
                      control=control)


# ---------------------------------------------------------------------------
# the spec resolves
# ---------------------------------------------------------------------------

def test_every_cell_resolves_to_its_files():
    spec = SP.load(ROOT)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        cell = SP.cell(ROOT, w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(SP.runner(cell.traffic["entry"]))
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(SP.reader(m["name"])), m["name"]
        for m in cell.per_layer:
            assert m["moves"] in names, (w["name"], m["name"])
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in spec["workloads"])


def test_benchmark_json_names_and_bounds():
    spec = SP.load(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench"]
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert len(n) <= 64 and n.replace("_", "a").replace(".", "a") \
            .replace("-", "a").isalnum(), n


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

def test_division_traffic_is_the_seeds():
    cfg = {"m_limbs": 32, "operands": {"u_limbs": [30, 30],
                                       "v_limbs": [2, 16]}}
    cpu = torch.device("cpu")

    def pool(seed):
        u, v, lu, lv = TF.division_pool(torch, cfg, 5, 8, seed, cpu)
        return u.reshape(-1, 32).numpy(), v.reshape(-1, 32).numpy(), lu, lv

    u1, v1, lu1, lv1 = pool(7)
    u2, v2, _, _ = pool(7)
    u3, v3, lu3, lv3 = pool(2 ** 31 + 7)
    assert np.array_equal(u1, u2) and np.array_equal(v1, v2)
    assert not np.array_equal(u1, u3) and not np.array_equal(v1, v3)
    lens = lambda a: [REF.prec(x) for x in REF.ints_from_limbs(a)]
    assert lens(u1) == [30] * 40 and lens(v1) == lv1.reshape(-1).tolist()
    # every batch holds one length from each of the 8 slices of [2, 16]
    for row in (lv1, lv3):
        assert all(sorted(b)[0] == 2 and sorted(b)[-1] >= 15 for b in row)
    assert not np.array_equal(lv1, lv3)
    assert not np.array_equal(TF.call_order(64, 7), TF.call_order(64, 8))


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 64])
def test_reference_on_edge_lanes(m):
    top = B ** m - 1
    lanes = [(top, top), (top, B ** (m // 2) - 1), (top, B ** (m // 2)),
             (12345, B ** 3), (top, 1), (0, 7), (top, 0), (5, 0)]
    for u, v in lanes:
        q, r = REF.divmod_ref(u, v)
        if v == 0:
            assert (q, r) == (0, u)
        else:
            assert u == q * v + r and 0 <= r < v
    us, vs = zip(*lanes)
    qs, rs = zip(*(REF.divmod_ref(u, v) for u, v in lanes))
    assert REF.wrong_divisions(us, vs, qs, rs) == 0
    assert REF.wrong_divisions(us, vs, (qs[0] + 1,) + qs[1:], rs) == 1
    back = REF.ints_from_limbs(REF.limbs_from_ints(list(us), m))
    assert back == list(us)


# ---------------------------------------------------------------------------
# controls and faults come out not correct
# ---------------------------------------------------------------------------

def test_division_control_fails():
    rnd = np.random.default_rng(3)
    us = [int(x) for x in rnd.integers(1, 2 ** 62, size=300)]
    vs = [int(x) for x in rnd.integers(2 ** 17, 2 ** 40, size=300)]
    got = [REF.divmod_uncorrected(u, v) for u, v in zip(us, vs)]
    assert REF.wrong_divisions(us, vs, *zip(*got)) > 0
    assert REF.divmod_uncorrected(5, 0) == (0, 5)


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(tiny_root, workload):
    outs = [run_tiny(tiny_root, workload, seed=s, control=True)
            for s in (1, 2, 3)]
    assert not any(o["correct"] for o in outs), [o["checks"] for o in outs]


@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_is_correct(tiny_root, workload):
    out = run_tiny(tiny_root, workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {
        m["name"] for m in SP.cell(tiny_root, workload).end_to_end}
    assert list(out)[-1] == "checks"
    assert all(v > 0 for v in out["checked"].values())


def _alter(out):
    """The answer of lane 0 changed where it is produced."""
    if isinstance(out, tuple):
        q = out[0].clone()
        q[0, 0] ^= 1
        return (q,) + tuple(out[1:])
    out = out.clone()
    out[0, 0] ^= 1
    return out


def _half(out):
    """The second half of the batch left out (zeros)."""
    def cut(t):
        t = t.clone()
        t[t.shape[0] // 2:] = 0
        return t
    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


@pytest.mark.parametrize("fault", [_alter, _half])
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, workload,
                                     fault):
    from repro_torch.core import shinv
    orig = shinv.divmod_batch
    monkeypatch.setattr(shinv, "divmod_batch",
                        lambda *a, **k: fault(orig(*a, **k)))
    out = run_tiny(tiny_root, workload)
    assert not out["correct"], out["checks"]


# ---------------------------------------------------------------------------
# what the benchmark loads, and a machine without a card
# ---------------------------------------------------------------------------

def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        found = _imports(path) & {"jax", "jaxlib", "flax", "repro"}
        assert not found, (path, found)
    for path in (BENCH / "ref").rglob("*.py"):
        assert _imports(path) <= {"__future__", "numpy"}, path


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench.harness import spec as SP, main as M\n"
        f"for w in {CELLS!r}:\n"
        f"    M.run_cell(SP.cell(__import__('pathlib').Path({str(tiny_root)!r}),"
        " w), 5, 0.2, False, torch.device('cpu'), time.perf_counter())\n"
        "print(M.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_measures_nothing():
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(ROOT)}
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("traffic", [
    {"entry": "bucket", "loop": "closed", "batch": 3,
     "pool_batches": 3, "check_calls": 2, "check_lanes": 2},
    {"entry": "bucket", "loop": "ahead", "batch": 5,
     "pool_batches": 1, "check_calls": 4, "check_lanes": 5}])
def test_other_mixes_run_from_data_alone(tiny_root, tmp_path, traffic):
    """A mix a later change adds as a data file alone runs, and is
    checked, through the same runner."""
    import shutil
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    spec = SP.load(root)
    spec["workloads"].append({"name": "extra",
                              "config": spec["configs"][0]["name"],
                              "traffic": "extra", "chips": 1, "why": "t"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "bench" / "traffic" / "extra.json").write_text(
        json.dumps(traffic))
    out = run_tiny(root, "extra")
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and "setup_s" in out["metrics"]
