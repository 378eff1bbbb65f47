"""Multi-pod dry run of the LM: every (arch x shape x mesh) cell's
per-device memory, cost and roofline, the port of
`repro/launch/dryrun.py`.

JAX lowers and compiles each cell for 256 or 512 host devices and
reads XLA's memory analysis and optimized HLO.  The port has no XLA,
so a cell is one device's program of the production mesh, run once on
fake tensors (`FakeTensorMode`: nothing is allocated) under the cost
walk (`utils/op_costs.py`).  For each cell this:
  1. builds the production layout (16x16 "data","model"; multi-pod
     adds a leading "pod"=2 axis) as an abstract mesh,
  2. takes every parameter's, optimizer leaf's and input's spec
     (`launch/specs.py`, held against JAX's exactly); the argument
     bytes are their local shard sizes, exact,
  3. runs the step at the device's local widths (`local_config`: head,
     kv-head, d_ff, expert, d_inner and vocab counts divided by the
     "model" axis where JAX's layout shards them) and its local batch
     (the global batch over the batch axes); a train step's gradients
     through the train step's own `make_accum_grad_fn`, its microbatch
     loop walked once and counted the microbatch count times; two and
     three repeat units of layers extrapolated to the arch's depth
     (JAX's layer-scan trip count),
  4. bills the collectives the layout implies (`_Bill`): at each
     `constrain` point, by its role, the layout change JAX's constraint
     makes there; at the accumulator's pin each microbatch's gradient
     reduction; from the specs FSDP's gathers, ZeRO-1's parameter
     gather and the loss,
  5. records memory (arguments exact, temporaries from the live fake
     storage of the walk), the roofline terms with the H100's constants
     (`op_costs.roofline_terms`) and the walk's costs beside the record
     (gzip JSON, for `launch/reanalyze.py`).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun

It allocates nothing on any device, so it takes no --device.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs import SHAPES, cell_applicable
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import abstract_production_mesh, crosses_hosts
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train.step import make_accum_grad_fn
from repro_torch.utils import op_costs as OC

ROOFLINE_KEYS = ("compute_s", "memory_s", "collective_s", "dot_flops",
                 "elem_flops", "bytes", "collective_bytes", "wire_bytes",
                 "bottleneck", "per_kind")


def microbatch_policy(cfg, shape, mesh) -> int:
    """Grad-accumulation factor chosen so activation memory fits 16GB
    HBM (JAX's rule, unchanged: 16 GB is a TPU v5e chip's; the H100 has
    80).  The per-microbatch batch MUST stay divisible by the total
    data-parallel degree, otherwise the batch dim cannot shard and
    every device would redundantly compute the whole microbatch."""
    if shape.kind != "train":
        return 1
    dp = mesh.sizes["data"] * mesh.sizes.get("pod", 1)
    tokens = shape.global_batch * shape.seq_len
    if cfg.d_model >= 12000:
        per_mb = 65536
    elif cfg.d_model >= 6144:
        per_mb = 131072
    else:
        per_mb = 262144
    mb = max(1, tokens // per_mb)
    mb = min(mb, shape.global_batch // dp)    # keep batch shardable
    while mb > 1 and (shape.global_batch % mb
                      or (shape.global_batch // mb) % dp):
        mb -= 1
    return max(mb, 1)


def _model_size(mesh) -> int:
    return mesh.sizes.get("model", 1)


def local_config(cfg, mesh):
    """cfg at one device's widths: each width JAX's layout shards on
    "model" divided by its size where it divides (query heads, and kv
    heads with them; d_ff; experts, else the expert d_ff; Mamba's
    d_inner; the padded vocab).  RWKV's heads stay whole: its time mix
    derives the head size from d_model."""
    m = _model_size(mesh)
    if m == 1:
        return cfg
    def div(n):
        return n // m if n % m == 0 and n >= m else n

    kw = {"d_ff": div(cfg.d_ff)}
    if cfg.family != "ssm" and cfg.n_heads % m == 0:
        h = cfg.n_heads // m
        kv = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else \
            max(1, h // (cfg.n_heads // cfg.n_kv_heads))
        kw.update(n_heads=h, n_kv_heads=kv if h % kv == 0 else 1)
    if cfg.n_experts:
        if cfg.n_experts % m == 0:
            kw["n_experts"] = cfg.n_experts // m
            kw["moe_top_k"] = min(cfg.moe_top_k, kw["n_experts"])
        else:
            kw["moe_d_ff"] = div(cfg.moe_d_ff)
    if cfg.mamba_d_inner:
        kw["mamba_d_inner"] = div(cfg.mamba_d_inner)
    vp = T.vocab_padded(cfg)
    if vp % m == 0:
        kw["vocab"] = vp // m
    return dataclasses.replace(cfg, **kw)


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


class _Bill:
    """The collectives the layout implies, billed to the running walk:
    `__call__` observes `constrain` and the accumulator's pin, keyed on
    the report's role (`models/sharding.py:ROLES`; the pin's
    "grad_layout:<name>" and "grad:<name>"); the rest are called by the
    cell."""

    def __init__(self, cfg, mesh, pshapes, p_spec, train: bool):
        self.cfg, self.mesh, self.train = cfg, mesh, train
        self.pshapes, self.p_spec = pshapes, p_spec
        self.m = _model_size(mesh)
        self.pins = 0

    def group(self, axes):
        axes = tuple(a for a in axes if a in self.mesh.axis_names)
        if not axes:
            return 1, False
        return (math.prod(self.mesh.sizes[a] for a in axes),
                crosses_hosts(self.mesh, axes))

    def over(self, kind, nbytes, axes, times=1):
        g, crosses = self.group(axes)
        if g > 1:
            for _ in range(times):
                OC.bill(kind, nbytes, g, crosses)

    def _sharded(self, name) -> bool:
        spec = self.p_spec.get(name, ())
        return any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in spec)

    def _data_axes(self, name) -> tuple:
        """The batch axes that shard parameter `name` (FSDP)."""
        ba = _batch_axes(self.mesh)
        return tuple(a for e in self.p_spec[name] if e is not None
                     for a in (e if isinstance(e, tuple) else (e,))
                     if a in ba)

    def _local(self, name) -> int:
        """Bytes of one shard of parameter `name`."""
        sd = self.pshapes[name]
        return math.prod(S.shard_shape(sd.shape, self.p_spec[name],
                                       self.mesh)) * sd.dtype.itemsize

    def reduce_grad(self, name):
        """One reduction of `name`'s gradient over the batch axes into
        its parameter's layout: reduce-scattered over the axes that shard
        it (FSDP), all-reduced over the others."""
        local, data_axes = self._local(name), self._data_axes(name)
        full = local * math.prod(self.mesh.sizes[a] for a in data_axes)
        if data_axes:
            self.over("reduce-scatter", full, data_axes)
        self.over("all-reduce", local, tuple(
            a for a in _batch_axes(self.mesh) if a not in data_axes))

    def __call__(self, x, spec, role):
        """A report: x at one device's widths, spec as `spec_for` gives
        it there (a pin: the parameter's spec)."""
        if role.startswith(("grad_layout:", "grad:")):
            # JAX's pin of the microbatch accumulator: it is kept in its
            # parameter's layout, and each microbatch's gradient is
            # reduced into it
            kind, name = role.split(":", 1)
            sd = self.pshapes[name]
            OC.relayout(x, self._local(name) // sd.dtype.itemsize
                        * x.element_size())
            if kind == "grad":
                self.pins += 1
                self.reduce_grad(name)
            return
        if self.m == 1:
            return
        cfg, m = self.cfg, self.m
        nbytes = x.numel() * x.element_size()
        both = 2 if self.train else 1       # forward, and its transpose
        if role == "embed":
            # a gather from the vocab-sharded table: partial rows
            if not (cfg.embed_stub and cfg.family != "encdec") \
                    and self._sharded("embed"):
                self.over("all-reduce", nbytes, ("model",))
        elif role in ("q", "k", "v"):
            heads = cfg.n_heads if role == "q" else cfg.n_kv_heads
            if heads % m and (heads * x.shape[-1]) % m == 0:
                # column-sharded projection, heads replicated: gathered
                full = nbytes * heads // x.shape[2]
                self.over("all-gather", full, ("model",))
                if self.train:
                    self.over("reduce-scatter", full, ("model",))
        elif role in ("mlp_in", "mlp_gate"):
            pass                            # column-parallel: no exchange
        elif role == "mlp_out":
            # the row-parallel output's partial sums
            if cfg.d_ff % m == 0:
                self.over("all-reduce", nbytes, ("model",), both)
        elif role == "timemix_out":
            if cfg.d_model % m == 0:
                self.over("all-reduce", nbytes, ("model",), both)
        elif role in ("channelmix_hidden", "mamba_inner"):
            # the (B, S, D) output of a product over the sharded width
            width = cfg.d_ff if role == "channelmix_hidden" else \
                (cfg.mamba_d_inner or 2 * cfg.d_model)
            if width % m == 0:
                d = nbytes * cfg.d_model // x.shape[-1]
                self.over("all-reduce", d, ("model",), both)
        elif role in ("moe_dispatch", "moe_out"):
            if cfg.n_experts % m == 0:        # tokens to experts and back
                self.over("all-to-all", nbytes, ("model",), both)
            elif role == "moe_out" and cfg.moe_d_ff % m == 0:
                self.over("all-reduce", nbytes, ("model",), both)
        elif role == "residual":
            # sequence-sharded residual: the next layer gathers it
            self.over("all-gather", nbytes, ("model",))
            if self.train:
                self.over("reduce-scatter", nbytes, ("model",))
        else:
            raise ValueError(f"no bill for the role {role!r}")

    def gradients(self, o_spec, mb: int):
        """Each gradient's reduction where no pin billed it (one
        microbatch: no accumulator), FSDP's parameter gathers per
        microbatch (forward and backward); per step: ZeRO-1's gather of
        the updated parameters, the loss."""
        for name in self.pshapes:
            if not self.pins:
                self.reduce_grad(name)
            local, data_axes = self._local(name), self._data_axes(name)
            if data_axes:
                full = local * math.prod(self.mesh.sizes[a]
                                         for a in data_axes)
                self.over("all-gather", full, data_axes, 2 * mb)
            elif any(e == "data" for e in o_spec["m"][name]):
                self.over("all-gather", local, ("data",))
        self.over("all-reduce", 4, _batch_axes(self.mesh))   # the loss


def _local_bytes(avals, spec_tree, mesh) -> int:
    """Sum of one shard's bytes over matching trees of ShapeDtypes and
    specs."""
    if isinstance(avals, SP.ShapeDtype):
        shp = S.shard_shape(avals.shape, spec_tree, mesh)
        return math.prod(shp) * avals.dtype.itemsize
    if isinstance(avals, dict):
        return sum(_local_bytes(avals[k], spec_tree[k], mesh) for k in avals)
    return sum(_local_bytes(a, s, mesh) for a, s in zip(avals, spec_tree))


def _rows(n: int, spec_entry, mesh) -> int:
    return n // S.spec_size(spec_entry, mesh)


def _fake_batch(cfg, kind, b, s, dtype):
    """A step's inputs at b rows (fake tensors under the caller's
    mode)."""
    batch = {}
    if kind == "decode":
        if cfg.embed_stub and cfg.family != "encdec":
            batch["embed"] = torch.empty((b, cfg.d_model), dtype=dtype)
        else:
            batch["token"] = torch.zeros((b,), dtype=torch.long)
        return batch
    if cfg.embed_stub and cfg.family != "encdec":
        batch["embeds"] = torch.empty((b, s, cfg.d_model), dtype=dtype)
    else:
        batch["tokens"] = torch.zeros((b, s), dtype=torch.long)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.empty((b, cfg.enc_seq, cfg.d_model),
                                          dtype=dtype)
    if kind == "train":
        batch["labels"] = torch.zeros((b, s), dtype=torch.long)
    return batch


def _walk_units(cfg, lcfg, shape, mesh, bill, rows, seq, cache_seq, mb,
                gdt, units: int) -> OC.Costs:
    """One step of the local model cut to `units` repeat units (and as
    many encoder layers), walked on fake tensors: a train step's
    gradients through `make_accum_grad_fn` over `mb` microbatches of
    `rows` rows, pinned to the parameters' specs (its microbatch loop,
    like the Mamba scan, walked once and counted `mb` times)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    plen = len(T.block_pattern(cfg))
    ucfg = dataclasses.replace(
        lcfg, n_layers=plen * units,
        n_enc_layers=units if cfg.n_enc_layers else 0)
    costs = OC.Costs()
    with FakeTensorMode():
        model = T.init_params(ucfg, 0, "cpu")
        batch = _fake_batch(ucfg, shape.kind, rows * mb, seq,
                            ucfg.compute_dtype)
        if shape.kind == "decode":
            cache = T.init_cache(ucfg, rows, cache_seq, "cpu")
        with S.use_mesh(mesh), S.observe(bill), \
                OC.walking(costs, collapse=True):
            if shape.kind == "train":
                make_accum_grad_fn(ucfg, mb, bill.p_spec, gdt)(model, batch)
            elif shape.kind == "prefill":
                with torch.no_grad():
                    T.forward_prefill(model, batch)
            else:
                with torch.no_grad():
                    T.forward_decode(model, cache, batch, cache_seq - 1)
    return costs


def _walk_update(pshapes, o_spec, mesh, opt_cfg, sdt) -> OC.Costs:
    """AdamW's update on one device's ZeRO-1 shards (fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    costs = OC.Costs()
    with FakeTensorMode():
        p, g, m, v = {}, {}, {}, {}
        for k, sd in pshapes.items():
            shp = S.shard_shape(sd.shape, o_spec["m"][k], mesh)
            p[k] = torch.empty(shp, dtype=sd.dtype)
            g[k] = torch.empty(shp, dtype=torch.float32)
            m[k] = torch.empty(shp, dtype=sdt)
            v[k] = torch.empty(shp, dtype=sdt)
        state = {"m": m, "v": v, "step": torch.zeros((), dtype=torch.int32)}
        with OC.walking(costs):
            adamw.apply_updates(p, g, state, opt_cfg)
    return costs


def roofline_record(record: dict, costs: OC.Costs) -> dict:
    """The record's roofline, trip counts and useful ratio from its
    costs, with the current constants (`launch/reanalyze.py` too)."""
    terms = OC.roofline_terms(costs)
    record["roofline"] = {k: terms[k] for k in ROOFLINE_KEYS}
    record["trip_counts"] = terms["trip_counts"]
    record["useful_ratio"] = record["model_flops_per_dev"] / max(
        terms["dot_flops"], 1.0)
    return record


def cell_layout(cfg, shape, mesh, opt_state_dtype=None,
                mb_override=None, pshapes=None) -> dict:
    """One cell's layout: the parameters' ShapeDtypes (`pshapes`, made
    unless given) and specs, the inputs' (and for a train cell the
    optimizer state's, its dtype, the microbatch count and the
    accumulator's dtype), and the argument bytes of one device: their
    local shards, summed."""
    pshapes = pshapes or SP.param_shapes(cfg)
    p_spec = SP.param_shardings(cfg, mesh, pshapes)
    avals, in_spec = SP.input_specs(cfg, shape, mesh)
    arg = _local_bytes(pshapes, p_spec, mesh) \
        + _local_bytes(avals, in_spec, mesh)
    lay = dict(params=pshapes, p_spec=p_spec, avals=avals, in_spec=in_spec,
               o_spec=None, microbatches=1, grad_accum_dtype=torch.float32)
    if shape.kind == "train":
        sdt = opt_state_dtype or (
            "bfloat16" if cfg.n_params() > 5e10 else "float32")
        st = getattr(torch, sdt)
        opt_shape = {m: {k: SP.ShapeDtype(x.shape, st)
                         for k, x in pshapes.items()} for m in ("m", "v")}
        opt_shape["step"] = SP.ShapeDtype((), torch.int32)
        lay["o_spec"] = SP.opt_state_shardings(cfg, mesh, opt_shape, p_spec)
        arg += _local_bytes(opt_shape, lay["o_spec"], mesh)
        lay.update(opt_shape=opt_shape, opt_state_dtype=sdt,
                   microbatches=mb_override
                   or microbatch_policy(cfg, shape, mesh),
                   grad_accum_dtype=torch.bfloat16
                   if os.environ.get("REPRO_BF16_GRADS") else torch.float32)
    lay["argument_bytes"] = arg
    return lay


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               opt_state_dtype: str | None = None,
               costs_path: str | None = None,
               mb_override: int | None = None, cfg=None, mesh=None,
               shape=None) -> dict:
    """The record of one cell.  cfg, mesh and shape stand in for the
    arch's config, the production mesh and SHAPES[shape_name] where
    given (tests, the one-card estimate)."""
    cfg = cfg or configs.get_config(arch)
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh = mesh or abstract_production_mesh(multi_pod=multi_pod)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "mesh_shape": mesh.sizes, "status": "?"}
    t0 = time.time()
    lay = cell_layout(cfg, shape, mesh, opt_state_dtype, mb_override)
    pshapes, p_spec, o_spec = lay["params"], lay["p_spec"], lay["o_spec"]
    avals, in_spec, arg = lay["avals"], lay["in_spec"], lay["argument_bytes"]
    train = shape.kind == "train"
    bill = _Bill(cfg, mesh, pshapes, p_spec, train)
    mb, gdt = lay["microbatches"], lay["grad_accum_dtype"]
    if train:
        record.update(microbatches=mb, opt_state_dtype=lay["opt_state_dtype"],
                      grad_accum_dtype=str(gdt).removeprefix("torch."))
        opt_cfg = adamw.AdamWConfig(state_dtype=lay["opt_state_dtype"])
        st = getattr(torch, lay["opt_state_dtype"])
        rows = _rows(shape.global_batch, in_spec["labels"][0], mesh) // mb
    elif shape.kind == "prefill":
        key = "tokens" if "tokens" in in_spec else "embeds"
        rows = _rows(shape.global_batch, in_spec[key][0], mesh)
    else:
        key = "token" if "token" in in_spec["batch"] else "embed"
        rows = _rows(shape.global_batch, in_spec["batch"][key][0], mesh)
    record["specs_s"] = round(time.time() - t0, 2)

    t1 = time.time()
    lcfg = local_config(cfg, mesh)
    cache_seq = shape.seq_len
    if shape.kind == "decode":
        seq_spec = [s.get("k", (None, None))[1]
                    for s in in_spec["cache"] if "k" in s]
        if seq_spec and seq_spec[0] is not None:
            cache_seq //= S.spec_size(seq_spec[0], mesh)
    reps = T.n_repeats(cfg)
    if cfg.n_enc_layers not in (0, reps):
        raise ValueError(f"{cfg.name}: the walk scales {cfg.n_enc_layers} "
                         f"encoder layers with {reps} decoder units")
    walk = dict(local_batch=rows, seq=shape.seq_len, layers=cfg.n_layers,
                units=reps, local_widths={
                    k: getattr(lcfg, k) for k in (
                        "n_heads", "n_kv_heads", "d_ff", "n_experts",
                        "moe_d_ff", "mamba_d_inner", "vocab")})
    args = (cfg, lcfg, shape, mesh, bill, rows, shape.seq_len, cache_seq,
            mb, gdt)
    # a model of R units walked whole where R <= 2; else 2 and 3 units,
    # extrapolated linearly (a unit's costs, and its growth of the peak:
    # what a unit leaves alive for the backward)
    lo = min(reps, 2)
    base = _walk_units(*args, lo)
    costs = OC.Costs(trip_counts=dict(base.trip_counts))
    costs.add(base)
    peak = base.peak_bytes
    if reps > lo:
        more = _walk_units(*args, lo + 1)
        costs.add(more, reps - lo)
        costs.add(base, -(reps - lo))
        peak += (reps - lo) * max(more.peak_bytes - base.peak_bytes, 0.0)
    costs.trip_counts["layer_units"] = reps
    if train:
        costs.trip_counts["microbatches"] = mb
        with OC.walking(costs):
            bill.gradients(o_spec, mb)
        upd = _walk_update(pshapes, o_spec, mesh, opt_cfg, st)
        costs.add(upd)
        peak += upd.peak_bytes
    costs.peak_bytes = peak
    if shape.kind == "decode":
        # attention over a sequence-sharded cache: partial softmax sums
        # and outputs reduced over the cache's sequence axis
        n_attn = sum(1 for mx, _ in T.layer_slots(cfg) if mx == "attn")
        if cache_seq != shape.seq_len:
            with OC.walking(costs):
                bill.over("all-reduce", n_attn * rows * lcfg.n_heads
                          * (cfg.head_dim + 2) * 4, ("data",))
    record["walk_s"] = round(time.time() - t1, 2)
    record["walk"] = walk

    vp = T.vocab_padded(cfg)
    m = _model_size(mesh)
    if train:
        out = arg - _local_bytes(avals, in_spec, mesh) + 3 * 4
        alias = out - 3 * 4
    else:
        b = shape.global_batch
        b_out = b // mesh.sizes["data"] if b % mesh.sizes["data"] == 0 else b
        logits = b_out * (vp // m if vp % m == 0 else vp) \
            * cfg.compute_dtype.itemsize
        alias = _local_bytes(avals["cache"], in_spec["cache"], mesh) \
            if shape.kind == "decode" else 0
        out = logits + alias
    record["memory"] = {
        "argument_bytes": arg, "output_bytes": out,
        "temp_bytes": int(peak), "alias_bytes": alias,
        "peak_bytes_est": arg + out + int(peak) - alias,
    }
    n_act = cfg.n_active_params()
    tokens = shape.global_batch * shape.seq_len \
        if shape.kind != "decode" else shape.global_batch
    model_flops = (6 if train else 2) * n_act * tokens
    record["model_flops_per_dev"] = model_flops / mesh.size
    roofline_record(record, costs)
    if costs_path:
        with gzip.open(costs_path, "wt") as f:
            json.dump(costs.to_json(), f)
    record["status"] = "ok"
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="override the per-cell grad-accumulation factor")
    args = ap.parse_args(argv)

    archs = configs.list_archs() if args.all or not args.arch \
        else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[cached ] {tag}")
                    continue
                try:
                    rec = lower_cell(arch, shape, mp,
                                     costs_path=path[:-5] + ".costs.json.gz",
                                     mb_override=args.microbatches)
                except Exception as e:              # noqa: BLE001
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()[-2000:]}
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                st = rec["status"]
                n_ok += st == "ok"
                n_skip += st == "skipped"
                n_fail += st == "error"
                extra = ""
                if st == "ok":
                    m = rec["memory"]["peak_bytes_est"] / 2**30
                    r = rec["roofline"]
                    extra = (f"peak={m:.2f}GiB bottleneck={r['bottleneck']}"
                             f" walk={rec['walk_s']}s")
                elif st == "error":
                    extra = rec["error"][:120]
                print(f"[{st:7s}] {tag} {extra}", flush=True)
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
