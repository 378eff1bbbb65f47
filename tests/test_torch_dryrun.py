"""The port's dry run of the paper's workload
(`repro_torch/launch/bigint_dryrun.py`) on the CPU: one shard of the
production layout, its record's keys against the record the JAX dry run
writes (`repro/launch/bigint_dryrun.py`, read from its source: running
it compiles for 256 host devices), exact answers, the cost model's
launches and roofline.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import bigint_dryrun as DR
from repro_torch.obs import costmodel as CM
from repro_torch.obs import roofline as RL

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its tensors are
    small, and the test workers share the host's cores (at the default
    of one thread per core, torch spends three times the CPU time on
    these tests for a third less wall time)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record_keys() -> dict:
    """{key: sorted sub-keys, or None} of the `rec = {...}` the JAX dry
    run's main() writes: its dict literals and the roofline's key
    tuple."""
    tree = ast.parse((SRC / "repro" / "launch" /
                      "bigint_dryrun.py").read_text())
    rec = next(node.value for node in ast.walk(tree)
               if isinstance(node, ast.Assign)
               and getattr(node.targets[0], "id", None) == "rec")
    out = {}
    for k, v in zip(rec.keys, rec.values):
        sub = None
        if isinstance(v, ast.Dict):
            sub = sorted(x.value for x in v.keys)
        elif isinstance(v, ast.DictComp):
            sub = sorted(e.value for e in v.generators[0].iter.elts)
        out[k.value] = sub
    return out


def test_dryrun_record_has_the_jax_keys(tmp_path):
    """The CLI as a module at --device cpu: the record file has every key
    (and sub-key) of the JAX dry run's record."""
    out = tmp_path / "bigint_div.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch."
                        "bigint_dryrun", "--device", "cpu", "--limbs", "32",
                        "--insts", "16", "--shards", "4", "--out", str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    ours = json.loads(out.read_text())
    theirs = _jax_record_keys()
    assert set(theirs) == {"arch", "bits", "insts", "mesh", "status",
                           "compile_s", "memory", "roofline"}
    for k, sub in theirs.items():
        assert k in ours, k
        assert (sorted(ours[k]) if isinstance(ours[k], dict) else None) \
            == sub, k
    assert ours["status"] == "ok" and ours["exact"]
    assert (ours["bits"], ours["insts"], ours["mesh"]) == (512, 16,
                                                          "single")
    assert ours["shards"] == 4 and ours["rows_per_shard"] == 4
    assert ours["roofline"]["bottleneck"] in ("compute", "memory")


@pytest.mark.parametrize("limbs,insts,shards,multi_pod",
                         [(32, 16, 4, False), (9, 1024, None, True)])
def test_dryrun_shard_is_exact_with_the_model(limbs, insts, shards,
                                              multi_pod):
    rec = DR.run(limbs, insts, shards=shards, multi_pod=multi_pod,
                 device="cpu")
    rows = insts // (shards or (512 if multi_pod else 256))
    assert rec["rows_per_shard"] == rows and rec["exact"]
    assert rec["mesh"] == ("multi" if multi_pod else "single")
    assert rec["launches"]["model"] == CM.divmod_launches(limbs)
    assert rec["launches"]["per_shard"] == 0        # nothing launches
    work = CM.divmod_work(limbs, rows)
    assert rec["roofline"] == RL.roofline_terms(work)
    assert rec["launch_work"] == [list(w) for w in work]
    assert len(work) == CM.divmod_launches(limbs)
    assert rec["memory"]["peak_bytes_est"] == 4 * rows * limbs * 4


def test_dryrun_rejects_an_uneven_split():
    with pytest.raises(ValueError, match="equal shards"):
        DR.run(8, 10, shards=4, device="cpu")
