"""The LM dry run and its cost walk: `repro_torch/utils/op_costs.py`
(products counted exactly through a loop, a collapsed loop and its
backward, a cache write billed at its window, `roofline_terms` against
JAX's `hlo_costs.roofline_terms` on one hand-built `Costs`) and
`repro_torch/launch/dryrun.py` (a data-only mesh of 2 halves a cell's
per-device products, and its billed gradient all-reduce equals what the
2-rank gloo DDP step sends; the CLI's record carries JAX's keys, and
`launch/reanalyze.py` re-derives it; JAX's own multi-pod cell).
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from _torch_dist import SRC, run_ranks
from repro.utils import hlo_costs as JH
from repro_torch import configs as C
from repro_torch.configs import ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MS
from repro_torch.models import transformer as T
from repro_torch.utils import loops
from repro_torch.utils import op_costs as OC

# the record keys of repro/launch/dryrun.py:lower_cell that the port
# keeps (it has no XLA: no lower_s/compile_s/analyze_s or xla_cost)
JAX_KEYS = {"arch", "shape", "mesh", "mesh_shape", "status", "memory",
            "roofline", "trip_counts", "model_flops_per_dev",
            "useful_ratio"}
JAX_TRAIN_KEYS = {"microbatches", "opt_state_dtype", "grad_accum_dtype"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_bytes_est"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_looped_product_counted_exactly():
    """JAX's test_hlo_parser_exact_on_scan: five 32x64 @ 64x64 products."""
    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x

    with FakeTensorMode():
        c = OC.analyze(f, torch.empty(32, 64), torch.empty(5, 64, 64))
    assert c.dot_flops == 5 * 2 * 32 * 64 * 64


def test_collapsed_loop_counts_every_step_and_its_backward():
    """A `steps` loop walked once under collapse counts as many products
    as the whole loop, forward and backward; so does a scan nested in a
    loop whose body runs the backward (the microbatch loop)."""
    def f(x, w):
        ys = []
        for t in loops.steps(x.shape[0], "scan"):
            ys.append(x[t] @ w)
        return torch.autograd.grad(torch.stack(ys).sum(), w)

    def g(x, w):
        for _i in loops.steps(3, "outer"):
            f(x, w)

    with FakeTensorMode():
        x = torch.empty(16, 8, 32)
        w = torch.empty(32, 32, requires_grad=True)
        full = OC.analyze(f, x, w)
        once = OC.analyze(f, x, w, collapse=True)
        nested_full = OC.analyze(g, x, w)
        nested = OC.analyze(g, x, w, collapse=True)
    assert once.trip_counts == {"scan": 16} and not full.trip_counts
    assert once.dot_flops == full.dot_flops == 16 * 2 * (2 * 8 * 32 * 32)
    assert nested.trip_counts == {"outer": 3, "scan": 16}
    assert nested.dot_flops == nested_full.dot_flops == 3 * full.dot_flops
    assert loops.steps(4, "x") == range(4)        # no walk: a plain range


@pytest.mark.parametrize("also", [None, "before", "after"])
def test_collapsed_loop_bills_each_steps_slice_gradient(also):
    """Each step's gradient of a slice x[:, t] of a stream from outside
    the loop is added into the stream's gradient by the autograd engine:
    the collapsed walk bills those additions as the whole walk counts
    them (bytes within 1%), also where the stream is read outside the
    loop before it or after it (the engine then adds the loop's gradient
    itself, in either order)."""
    def f(x, w):
        u = x * 2
        tot = (u * 3).sum() if also == "before" else 0
        ys = []
        for t in loops.steps(x.shape[1], "scan"):
            ys.append((u[:, t] @ w).sum())
        tot = tot + torch.stack(ys).sum()
        if also == "after":
            tot = tot + (u * 3).sum()
        return torch.autograd.grad(tot, (x, w))

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, 64, generator=gen, requires_grad=True)
    w = torch.randn(64, 64, generator=gen, requires_grad=True)
    full = OC.analyze(f, x, w)
    once = OC.analyze(f, x, w, collapse=True)
    assert once.dot_flops == full.dot_flops
    assert once.bytes_accessed == pytest.approx(full.bytes_accessed,
                                                rel=1e-2)
    # without the billing, the 31 additions of (4, 32, 64) float32 are
    # missing: more than 30% of the bytes
    adds = 31 * 3 * x.numel() * 4
    assert adds > 0.3 * full.bytes_accessed


def test_collapsed_mamba_train_walk_matches_the_whole_walk():
    """Reduced jamba-1.5-large-398b's train gradient at 64 positions
    (one Mamba and one attention layer): the walk that runs the Mamba
    scan once counts the products of the whole walk exactly and its
    bytes within 2%."""
    from repro_torch.train.step import make_grad_fn
    cfg = C.get_config("jamba-1.5-large-398b").reduced()

    def walk(collapse):
        with FakeTensorMode():
            model = T.init_params(cfg, 0, "cpu")
            batch = {"tokens": torch.zeros((2, 64), dtype=torch.long),
                     "labels": torch.zeros((2, 64), dtype=torch.long)}
            return OC.analyze(make_grad_fn(cfg), model, batch,
                              collapse=collapse)

    full, once = walk(False), walk(True)
    assert once.trip_counts == {"mamba_scan": 64}
    assert once.dot_flops == full.dot_flops
    assert once.bytes_accessed == pytest.approx(full.bytes_accessed,
                                                rel=2e-2)


def test_cache_write_billed_at_its_window():
    """JAX's dynamic-update-slice rule: writing one position of a
    decode cache moves the window twice, not the cache."""
    cache = torch.zeros(2, 4096, 4, 64)
    new = torch.ones(2, 1, 4, 64)

    def write(pos):
        cache[:, pos:pos + 1] = new

    c = OC.analyze(write, 17)
    assert c.bytes_accessed == 2 * new.numel() * 4
    assert c.elem_flops == 0 and c.dot_flops == 0


def test_roofline_terms_match_jax_on_hand_built_costs():
    info = [("all-reduce", 1e6, 16), ("all-gather", 2e6, 8),
            ("reduce-scatter", 3e5, 4), ("all-to-all", 4e5, 16),
            ("collective-permute", 5e5, 2), ("all-reduce", 7e5, 1),
            ("all-gather", 1e5, 0)]
    per_kind = {}
    for kind, size, _g in info:
        per_kind[kind] = per_kind.get(kind, 0.0) + size
    jc = JH.Costs(dot_flops=3e12, elem_flops=1e9, bytes_accessed=5e10,
                  collective_bytes=dict(per_kind), collective_info=info)
    pc = OC.Costs(dot_flops=3e12, elem_flops=1e9, bytes_accessed=5e10,
                  collective_bytes=dict(per_kind),
                  collective_info=list(info))
    want, got = JH.roofline_terms(jc), OC.roofline_terms(pc)
    assert got["wire_bytes"] == want["wire_bytes"]
    assert got["per_kind"] == want["per_kind"]
    assert got["collective_bytes"] == want["collective_bytes"]
    assert got["compute_s"] == 3e12 / 989e12
    assert got["memory_s"] == 5e10 / 3.35e12
    # groups of at most a host's 8 cards ride NVLink, larger ones the
    # network
    nv = sum(w for (k, s, g), w in zip(info, (
        2 * 1e6 * 15 / 16, 2e6 * 7 / 8, 3e5 * 3 / 4, 4e5, 5e5, 0, 1e5))
        if g <= 8)
    net = 2 * 1e6 * 15 / 16 + 4e5
    assert got["collective_s"] == pytest.approx(nv / 450e9 + net / 50e9)


DDP_WALK = r"""
import json, sys
import numpy as np, torch
from repro_torch import configs as C
from repro_torch.data.synthetic import DataConfig, SyntheticStream
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import comm
from repro_torch.train.ddp_shardmap import init_error_buffers, make_ddp_train_step
from repro_torch.utils import loops
from repro_torch.utils import op_costs as OC
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
comm.init_group(rank, world, port, "cpu")
cfg = C.get_config("smollm-135m").reduced()
ocfg = adamw.AdamWConfig()
model = T.init_params(cfg, 0, "cpu")
opt = adamw.init_state(dict(model.named_parameters()), ocfg)
step = make_ddp_train_step(cfg, ocfg, compress=False)
batch = {k: torch.from_numpy(v).long() for k, v in SyntheticStream(
    DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)).batch(0).items()}
costs = OC.analyze(step, model, opt, init_error_buffers(model), batch)
np.savez(out + f"/rank{rank}.npz", costs=json.dumps(costs.to_json()),
         sent=step.stats.bytes)
torch.distributed.destroy_process_group()
"""


def test_data_parallel_cell_halves_products_and_bills_ddp_bytes(tmp_path):
    """A reduced dense train cell (4 x 64) on a data-only mesh of 2: half
    the 1-device cell's products per device, and its billed gradient
    all-reduce (and the loss's) equals what the 2-rank gloo DDP step
    sends, as the walk counts its collectives."""
    cfg = C.get_config("smollm-135m").reduced()
    shape = ShapeCell("train_4x64", 64, 4, "train")
    recs = {n: D.lower_cell(cfg.name, shape.name, False, cfg=cfg,
                            shape=shape,
                            mesh=MS.abstract_mesh((n,), ("data",)))
            for n in (1, 2)}
    assert recs[1]["roofline"]["dot_flops"] == \
        2 * recs[2]["roofline"]["dot_flops"]
    assert recs[1]["roofline"]["per_kind"] == {}
    billed = recs[2]["roofline"]["per_kind"]["all-reduce"]
    ranks = run_ranks(DDP_WALK, 2, tmp_path)
    for r in ranks:
        sent = OC.Costs.from_json(json.loads(str(r["costs"])))
        assert sent.collective_bytes == {"all-reduce": billed}
        assert billed == int(r["sent"])
        assert [g for _k, _s, g, _c in sent.collective_info] == [2]


def test_pinned_train_step_is_the_train_step():
    """make_train_step(param_shardings=) under a mesh is the train step
    bit for bit; it pins every accumulator leaf: the zeros, each of the
    2 microbatches' sums and the mean."""
    from repro_torch.launch import specs as SP
    from repro_torch.models import sharding as S
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = C.get_config("smollm-135m").reduced()
    mesh = MS.abstract_mesh((2,), ("data",))
    p_spec = SP.param_shardings(cfg, mesh, SP.param_shapes(cfg))
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=gen)
             for k in ("tokens", "labels")}
    pins, out = [], []
    for shardings in (None, p_spec):
        model = T.init_params(cfg, 0, "cpu")
        step = make_train_step(cfg, ocfg, microbatches=2,
                               param_shardings=shardings)
        with S.use_mesh(mesh), S.observe(
                lambda x, spec, role: pins.append((role, spec))):
            _m, _o, metrics = step(
                model, adamw.init_state(dict(model.named_parameters()),
                                        ocfg), batch)
        out.append((float(metrics["loss"]),
                    [p.detach().clone() for p in model.parameters()]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    names = [k for k, _p in T.init_params(cfg, 0, "cpu").named_parameters()]
    want = [f"grad_layout:{k}" for k in names] \
        + 2 * [f"grad:{k}" for k in names] \
        + [f"grad_layout:{k}" for k in names]
    pins = [(r, spec) for r, spec in pins if r.startswith("grad")]
    assert [r for r, _s in pins] == want
    assert all(spec == p_spec[r.split(":", 1)[1]] for r, spec in pins)


def test_microbatch_pin_bills_each_microbatch():
    """The dry run walks the train step's own microbatch loop: on a
    data-only mesh of 2, 2 microbatches bill the gradient all-reduce
    twice (at the accumulator's pin), against once for 1 microbatch, the
    loss's 4 bytes once; the products are the same."""
    cfg = C.get_config("smollm-135m").reduced()
    shape = ShapeCell("train_4x64", 64, 4, "train")
    mesh = MS.abstract_mesh((2,), ("data",))
    recs = {mb: D.lower_cell(cfg.name, shape.name, False, cfg=cfg,
                             shape=shape, mesh=mesh, mb_override=mb)
            for mb in (1, 2)}
    ar = {mb: r["roofline"]["per_kind"]["all-reduce"]
          for mb, r in recs.items()}
    assert ar[2] - 4 == 2 * (ar[1] - 4)
    assert recs[2]["trip_counts"]["microbatches"] == 2
    assert recs[1]["roofline"]["dot_flops"] == \
        recs[2]["roofline"]["dot_flops"]


def test_dryrun_cli_record_and_reanalyze(tmp_path):
    """JAX's own test cell (qwen2-0.5b decode_32k on the multi-pod mesh)
    through the CLI: status ok, JAX's keys, peak under the card's 80 GB,
    three roofline terms > 0; reanalyze re-derives the same roofline;
    a long_500k cell of a full-attention arch is skipped as JAX skips
    it."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "decode_32k", "--mesh", "multi",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    path = tmp_path / "qwen2-0.5b__decode_32k__multi.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec
    assert JAX_KEYS <= set(rec) and set(rec["memory"]) == MEMORY
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["memory"]["peak_bytes_est"] < 80e9
    rl = rec["roofline"]
    assert rl["compute_s"] > 0 and rl["memory_s"] > 0 \
        and rl["collective_s"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    before = rec["roofline"]
    rec["roofline"] = {}
    path.write_text(json.dumps(rec))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.reanalyze",
                        "--dir", str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert "1 records updated" in r.stdout, r.stderr[-2000:]
    assert json.loads(path.read_text())["roofline"] == before
    skipped = D.lower_cell("smollm-135m", "long_500k", False)
    assert skipped["status"] == "skipped" and "sub-quadratic" in \
        skipped["reason"]


def test_train_cell_record_keys():
    """A train cell on the single pod: JAX's train keys, its microbatch
    count in trip_counts, arguments = outputs + inputs (donated)."""
    rec = D.lower_cell("smollm-135m", "train_4k", False)
    assert rec["status"] == "ok"
    assert (JAX_KEYS | JAX_TRAIN_KEYS) <= set(rec)
    assert rec["microbatches"] == rec["trip_counts"]["microbatches"] == 4
    assert rec["trip_counts"]["layer_units"] == 30
    assert rec["opt_state_dtype"] == "float32"
    assert rec["grad_accum_dtype"] == "float32"
    m = rec["memory"]
    assert m["alias_bytes"] == m["output_bytes"] - 12
    assert m["peak_bytes_est"] == m["argument_bytes"] + m["temp_bytes"] + 12
    assert rec["roofline"]["per_kind"]["all-reduce"] > 0
