"""Parameter / optimizer-state / cache / input sharding rules and shape
stand-ins: the port of `repro/launch/specs.py`.

``input_specs(cfg, shape, mesh)`` returns (avals, specs) for every model
input of an (architecture x input-shape) cell: `ShapeDtype` stand-ins
(JAX's `ShapeDtypeStruct`), no allocation.  A spec is a tuple of
`models/sharding.py` entries (None, an axis name or a tuple of names),
JAX's `PartitionSpec`, on a `launch/mesh.py:DeviceMesh`.

Sharding policy (TP on "model", DP/FSDP on "data", DP on "pod"):
  * embeddings / lm head : vocab on "model"
  * attention q/o        : head dim on "model" (kv replicated if the
                           kv-head count does not divide the axis)
  * mlp / experts        : d_ff (and expert dim) on "model"
  * FSDP                 : params additionally sharded over "data" on
                           the first divisible dim (on by default for
                           archs > 8B params)
  * batch dims           : ("pod", "data"); when global_batch == 1
                           (long_500k) the KV-cache sequence dim takes
                           "data" instead (context parallelism)

JAX matches its rules on its own key paths (`blocks/slot0/attn/wq`,
`embed`, `experts`) and its own layout.  The port's names and layout
differ in two ways: its dense weights are `nn.Linear`s, (out, in) where
JAX's are (in, out), and it unrolls the layer scan, so its block leaves
and per-layer cache entries have no leading repeat axis.  So a port
leaf is mapped to its JAX path and layout (`jax_path`, the inverse of
`transformer.jax_name`), JAX's rule runs there unchanged, and the spec
comes back in the port's own layout: a column-parallel "last dim on
model" is dim 0 of a torch weight, and a cache entry's batch is its dim
0 (JAX's dim 1).  ZeRO-1 (`opt_state_shardings`) runs JAX's
`zero1_spec` in JAX's layout on each layer's own dims: where JAX's
picks the repeat axis (a stack of n_repeats layers that divides the
data axis), the port, which has no such axis, shards the layer's first
divisible dim instead, the same bytes per device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs import ModelConfig, ShapeCell
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import zero1_spec

FSDP_THRESHOLD = 8e9


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype with no storage: JAX's
    `ShapeDtypeStruct`."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


def _div(n: int, mesh, axis) -> bool:
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= mesh.sizes[a]
    else:
        if axis not in mesh.axis_names:
            return False
        size = mesh.sizes[axis]
    return n % size == 0 and n >= size


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else "data"


def param_spec(path: str, shape, cfg, mesh, fsdp: bool) -> tuple:
    """JAX's rule by parameter path substring, on JAX's path and layout.

    Leaves under blocks/enc_blocks carry a leading layer-repeat axis
    (scan stacking); the rule applies to the trailing dims and the
    repeat axis stays unsharded.
    """
    def has(*keys):
        return any(k in path for k in keys)

    stacked = has("blocks/")
    off = 1 if stacked else 0
    body = shape[off:]
    entries = [None] * len(body)
    if has("embed", "lm_head"):
        # (vocab_p, d) or (d, vocab_p): shard the vocab dim
        vdim = 0 if body[0] > body[-1] else len(body) - 1
        if len(body) == 2 and _div(body[vdim], mesh, "model"):
            entries[vdim] = "model"
    elif has("experts"):
        if _div(body[0], mesh, "model"):
            entries[0] = "model"          # expert parallelism
        elif len(body) >= 2 and _div(body[-1], mesh, "model"):
            entries[-1] = "model"
    elif has("/wq", "/wk", "/wv", "/wg", "/wi", "in_proj", "x_proj",
             "lora_a", "/wa", "/wr"):
        if len(body) == 2 and _div(body[-1], mesh, "model"):
            entries[-1] = "model"         # column parallel
    elif has("/wo", "out_proj", "dt_proj", "/wb", "lora_b"):
        if len(body) >= 2 and _div(body[0], mesh, "model"):
            entries[0] = "model"          # row parallel
    # norms, biases, scalars: replicated
    if fsdp:
        dsize = mesh.sizes["data"]
        for i, (e, n) in enumerate(zip(entries, body)):
            if e is None and n % dsize == 0 and n >= dsize:
                entries[i] = ("pod", "data") if "pod" in mesh.axis_names \
                    and n % (dsize * mesh.sizes["pod"]) == 0 else "data"
                break
    return tuple([None] * off + entries)


def jax_path(cfg, name: str) -> tuple[str, bool, bool]:
    """(JAX's "/"-joined key path, stacked, transposed) of the port's
    parameter `name`: a block leaf lies under JAX's repeat axis (layer
    i of `blocks` is slot i % len(pattern)), and a transposed leaf is
    an nn.Linear weight (or the untied lm_head)."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks"):
        leaf, transposed = T.jax_leaf(".".join(parts[2:]))
        if parts[0] == "blocks":
            slot = int(parts[1]) % len(T.block_pattern(cfg))
            prefix = f"/blocks/slot{slot}/"
        else:
            prefix = "/enc_blocks/"
        return prefix + leaf.replace(".", "/"), True, transposed
    if name == "lm_head.weight":
        return "/lm_head", False, True
    return "/" + name.replace(".", "/"), False, False


def _to_jax(spec, shape, transposed: bool):
    """A port leaf's spec and shape in JAX's layout (no repeat axis)."""
    if transposed:
        return tuple(reversed(spec)), tuple(reversed(shape))
    return tuple(spec), tuple(shape)


def leaf_spec(cfg, mesh, name: str, shape, fsdp: bool) -> tuple:
    """`param_spec` of the port's leaf `name` of `shape`, in the port's
    layout."""
    path, stacked, transposed = jax_path(cfg, name)
    jshape = _to_jax([None] * len(shape), shape, transposed)[1]
    spec = param_spec(path, ((1,) if stacked else ()) + jshape, cfg, mesh,
                      fsdp)
    return _to_jax(spec[1:] if stacked else spec, jshape, transposed)[0]


def param_shapes(cfg) -> dict:
    """{port name: ShapeDtype} of `init_params(cfg)`, built on fake
    tensors: nothing is allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        model = T.init_params(cfg, 0, "cpu")
        return {k: ShapeDtype(tuple(p.shape), p.dtype)
                for k, p in model.named_parameters()}


def _shape(x) -> tuple:
    return tuple(x.shape)


def param_shardings(cfg: ModelConfig, mesh, model) -> dict:
    """{port name: spec} for a model's parameters (an nn.Module, or a
    dict of tensors or ShapeDtypes by name)."""
    fsdp = cfg.n_params() > FSDP_THRESHOLD
    leaves = dict(model.named_parameters()) \
        if isinstance(model, torch.nn.Module) else model
    return {k: leaf_spec(cfg, mesh, k, _shape(x), fsdp)
            for k, x in leaves.items()}


def opt_state_shardings(cfg, mesh, opt_shape, p_shardings) -> dict:
    """ZeRO-1: optimizer m/v inherit the param spec (incl. FSDP), then
    `zero1_spec` in JAX's layout on each leaf's own dims."""
    def z1(name, x):
        transposed = jax_path(cfg, name)[2]
        spec, shape = _to_jax(p_shardings[name], _shape(x), transposed)
        return _to_jax(zero1_spec(spec, shape, mesh), shape, transposed)[0]

    out = {m: {k: z1(k, x) for k, x in opt_shape[m].items()}
           for m in ("m", "v")}
    out["step"] = ()
    return out


def cache_shardings(cfg: ModelConfig, mesh, cache_shape,
                    global_batch: int) -> list:
    """Decode-cache sharding, one dict of specs per layer.  Batch (dim 0)
    shards on ("pod","data") when divisible; otherwise a long sequence
    dim (attn KV, dim 1) takes "data" -- context parallelism for the
    long_500k cell.  One trailing head/channel dim shards on "model"
    where divisible.  (JAX's leaves carry the repeat axis first: its
    dims 1 and 2.)"""
    batch_ok = _div(global_batch, mesh, _batch_axes(mesh))

    def rule(x):
        shape = _shape(x)
        entries = [None] * len(shape)
        if len(shape) < 1:
            return ()
        if batch_ok and _div(shape[0], mesh, _batch_axes(mesh)):
            entries[0] = _batch_axes(mesh)
        elif len(shape) >= 2 and shape[1] > 4096 \
                and _div(shape[1], mesh, "data"):
            entries[1] = "data"           # seq-sharded KV (context par.)
        for i in range(1, len(shape)):
            if entries[i] is None and _div(shape[i], mesh, "model"):
                entries[i] = "model"
                break
        return tuple(entries)

    return [{k: rule(x) for k, x in layer.items()} for layer in cache_shape]


def cache_shapes(cfg, batch: int, max_seq: int) -> list:
    """`init_cache`'s layout as ShapeDtypes (meta tensors: nothing is
    allocated)."""
    return [{k: ShapeDtype(tuple(x.shape), x.dtype) for k, x in st.items()}
            for st in T.init_cache(cfg, batch, max_seq, device="meta")]


# ---------------------------------------------------------------------------
# input avals + specs per cell
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeCell, mesh):
    """(avals, specs) for the step function of this cell.

    train:   {tokens|embeds, labels[, enc_embeds]}
    prefill: {tokens|embeds[, enc_embeds]}
    decode:  {"batch": {token|embed}, "cache": [per layer], "pos"}
    """
    b, s = shape.global_batch, shape.seq_len
    ba = _batch_axes(mesh)
    bspec = ba if _div(b, mesh, ba) else (
        "data" if _div(b, mesh, "data") else None)

    def tok(shp):
        return ShapeDtype(shp, torch.int32)

    def emb(shp):
        return ShapeDtype(shp, torch.bfloat16)

    if shape.kind in ("train", "prefill"):
        avals: dict = {}
        spec: dict = {}
        if cfg.embed_stub and cfg.family != "encdec":
            avals["embeds"] = emb((b, s, cfg.d_model))
            spec["embeds"] = (bspec, None, None)
        else:
            avals["tokens"] = tok((b, s))
            spec["tokens"] = (bspec, None)
        if cfg.family == "encdec":
            avals["enc_embeds"] = emb((b, cfg.enc_seq, cfg.d_model))
            spec["enc_embeds"] = (bspec, None, None)
        if shape.kind == "train":
            avals["labels"] = tok((b, s))
            spec["labels"] = (bspec, None)
        return avals, spec

    # decode: cache of seq_len, one new token
    cache_shape = cache_shapes(cfg, b, s)
    cache_spec = cache_shardings(cfg, mesh, cache_shape, b)
    if cfg.embed_stub and cfg.family != "encdec":
        step_in = {"embed": emb((b, cfg.d_model))}
        step_spec = {"embed": (bspec, None)}
    else:
        step_in = {"token": tok((b,))}
        step_spec = {"token": (bspec,)}
    avals = {"batch": step_in, "cache": cache_shape,
             "pos": ShapeDtype((), torch.int32)}
    spec = {"batch": step_spec, "cache": cache_spec, "pos": ()}
    return avals, spec
