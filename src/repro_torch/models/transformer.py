"""Model assembly for the decoder-only families: the port of
`repro/models/transformer.py` for serving (prefill and decode).

Families ported: dense and moe, decoder-only transformers (GQA,
RoPE/M-RoPE, MLP, MoE or MoE + dense residual).  The ssm (RWKV-6),
hybrid (Jamba) and encdec (Whisper) families, and training
(`forward_train`, the chunked cross-entropy), are not ported yet
(ROADMAP queue 1 item 5, slices 11 and 12): `Transformer` raises
NotImplementedError for those families.

Layout: JAX scans one repeat unit of `block_pattern(cfg)` over
parameters stacked on a leading repeat axis; the port unrolls the scan
into `blocks`, an `nn.ModuleList` of n_layers slots in pattern order
(layer r * len(pattern) + i is slot i of repeat r).  The KV cache is a
list of per-layer {"k", "v"} tensors of shape (B, S_max, Hkv, hd), in
bfloat16 whatever cfg.dtype is, as JAX keeps it.

Public API:
  init_params(cfg, seed, device)               -> Transformer
  params_from_jax(cfg, tree, device)           -> Transformer
  init_cache(cfg, batch, max_seq, device)      -> cache
  forward_prefill(model, batch)                -> last-token logits
  forward_decode(model, cache, batch, pos)     -> (logits, cache)

Entry points default to the card (`device="cuda"`); tests pass "cpu".
The vocab is padded to a multiple of 256: logits have vocab_padded(cfg)
columns, and a caller takes the first cfg.vocab.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import layers as L
from . import moe as MOE

PORTED_FAMILIES = ("dense", "moe")


def vocab_padded(cfg) -> int:
    return -(-cfg.vocab // 256) * 256


# ---------------------------------------------------------------------------
# repeating block pattern
# ---------------------------------------------------------------------------

def block_pattern(cfg) -> list[tuple[str, str]]:
    """[(mixer, ffn)] for one repeat unit."""
    if cfg.family == "ssm":
        return [("rwkv", "rwkv_cm")]
    if cfg.family == "hybrid" and cfg.layer_pattern:
        me = max(cfg.moe_every, 1)
        return [("attn" if c == "a" else "mamba",
                 ("moe" if cfg.n_experts and i % me == me - 1 else "mlp"))
                for i, c in enumerate(cfg.layer_pattern)]
    if cfg.n_experts:
        me = max(cfg.moe_every, 1)
        ffn_kind = "moe+mlp" if cfg.dense_residual else "moe"
        if me == 1:
            return [("attn", ffn_kind)]
        return [("attn", ffn_kind if i % me == me - 1 else "mlp")
                for i in range(me)]
    return [("attn", "mlp")]


def n_repeats(cfg) -> int:
    plen = len(block_pattern(cfg))
    assert cfg.n_layers % plen == 0, (cfg.name, cfg.n_layers, plen)
    return cfg.n_layers // plen


def layer_slots(cfg) -> list[tuple[str, str]]:
    """[(mixer, ffn)] of every layer, the pattern repeated."""
    return block_pattern(cfg) * n_repeats(cfg)


def _make_norm(cfg, device):
    cls = L.RMSNorm if cfg.norm == "rmsnorm" else L.LayerNorm
    return cls(cfg.d_model, cfg.param_dtype, device)


def _norm(cfg, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: ln1, the attention mixer, ln2 and its ffn (mlp, moe or
    moe + mlp)."""

    def __init__(self, cfg, ffn: str, gen: torch.Generator):
        super().__init__()
        self.ffn = ffn
        self.ln1 = _make_norm(cfg, gen.device)
        self.ln2 = _make_norm(cfg, gen.device)
        self.attn = L.Attention(cfg, gen)
        if ffn in ("moe", "moe+mlp"):
            self.moe = MOE.MoE(cfg, gen)
        if ffn in ("mlp", "moe+mlp"):
            self.mlp = L.MLP(cfg, gen)


class Transformer(nn.Module):
    """embed (vocab_padded, D), blocks, final_ln, and lm_head where the
    embeddings are not tied (the tied head is embed.T)."""

    def __init__(self, cfg, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet "
                "(ROADMAP queue 1 item 5, slice 11: the ssm/hybrid/encdec "
                "serve paths)")
        device = _device(device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        vp = vocab_padded(cfg)
        self.embed = L.param(L.embed_init(gen, vp, cfg.d_model,
                                          cfg.param_dtype))
        if not cfg.tie_embeddings:
            self.lm_head = L.linear(gen, cfg.d_model, vp, cfg.param_dtype)
        self.blocks = nn.ModuleList(Block(cfg, ffn, gen)
                                    for _, ffn in layer_slots(cfg))
        self.final_ln = _make_norm(cfg, device)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return device


def init_params(cfg, seed: int = 0, device="cuda") -> Transformer:
    """Random weights from `seed`, built on `device` by a generator
    there."""
    return Transformer(cfg, seed, device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes: no numpy bf16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _flat(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def jax_name(path: str) -> tuple[str, bool]:
    """The port's parameter name for a leaf of one JAX layer, and whether
    its array is transposed: an (in, out) dense weight `attn.wq` is
    `attn.wq.weight` of an nn.Linear (out, in), its bias `attn.bq` is
    `attn.wq.bias`; the MoE's stacked experts and float32 router keep
    JAX's layout (`moe.experts.wi` is `moe.wi`)."""
    parts = path.split(".")
    if parts[0] in ("attn", "mlp"):
        name = parts[1]
        if name.startswith("b"):
            return f"{parts[0]}.w{name[1:]}.bias", False
        return f"{parts[0]}.{name}.weight", True
    if parts[0] == "moe" and parts[1] == "experts":
        return f"moe.{parts[2]}", False
    return path, False


def params_from_jax(cfg, tree: dict, device="cuda") -> Transformer:
    """A `Transformer` holding the JAX parameter pytree `tree` (its
    leaves numpy arrays: `jax.tree.map(np.asarray, params)`): the leading
    repeat axis of tree["blocks"] unstacked into layers, dense weights
    transposed into nn.Linear's layout, the router kept in float32, the
    tied head kept as embed.T.  Every parameter is loaded (strict)."""
    model = Transformer(cfg, 0, device)
    sd = {"embed": tree["embed"]}
    sd.update((f"final_ln.{k}", v) for k, v in tree["final_ln"].items())
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = tree["lm_head"].T
    plen = len(block_pattern(cfg))
    for path, leaf in _flat(tree["blocks"]):
        slot, rest = path.split(".", 1)
        name, transpose = jax_name(rest)
        for r in range(leaf.shape[0]):
            layer = r * plen + int(slot[len("slot"):])
            sd[f"blocks.{layer}.{name}"] = leaf[r].T if transpose \
                else leaf[r]
    model.load_state_dict({k: _tensor(v, device) for k, v in sd.items()},
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# block application (prefill)
# ---------------------------------------------------------------------------

def _ffn(lp: Block, h, cfg):
    """The layer's mlp, moe or moe + mlp on the normed h (the MoE's aux
    loss is a training term: dropped here)."""
    if lp.ffn == "mlp":
        return L.mlp(lp.mlp, h, cfg)
    f, _aux = MOE.moe_apply(lp.moe, h, cfg)
    if lp.ffn == "moe+mlp":
        f = f + L.mlp(lp.mlp, h, cfg)
    return f


def _apply_slot(lp: Block, x, cfg, positions):
    """One layer at prefill: the chunked online-softmax attention core
    (never the (S x S) score matrix), chunk cfg.attn_chunk."""
    h = _norm(cfg, lp.ln1, x)
    x = x + L.attn_chunked(lp.attn, h, cfg, positions, chunk=cfg.attn_chunk)
    return x + _ffn(lp, _norm(cfg, lp.ln2, x), cfg)


def _embed_inputs(model, batch, cfg):
    if cfg.embed_stub and "embeds" in batch:
        return batch["embeds"].to(cfg.compute_dtype)
    return model.embed[batch["tokens"]].to(cfg.compute_dtype)


def _backbone(model, x, cfg, positions):
    """Every layer in order, then the final norm."""
    for lp in model.blocks:
        x = _apply_slot(lp, x, cfg, positions)
    return _norm(cfg, model.final_ln, x)


def _logits(model, x, cfg):
    if cfg.tie_embeddings:
        return torch.nn.functional.linear(x, model.embed.to(x.dtype))
    return L.dense(x, model.lm_head)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_seq: int, device="cuda") -> list:
    """Decode state: one {"k", "v"} of (B, max_seq, Hkv, hd) zeros in
    bfloat16 per layer."""
    device = _device(device)
    shape = (batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
             "v": torch.zeros(shape, dtype=torch.bfloat16, device=device)}
            for _ in layer_slots(cfg)]


def _decode_slot(lp: Block, st: dict, x, cfg, pos: int):
    h = _norm(cfg, lp.ln1, x)
    a, st["k"], st["v"] = L.attn_decode(lp.attn, h, cfg, st["k"], st["v"],
                                        pos)
    x = x + a
    return x + _ffn(lp, _norm(cfg, lp.ln2, x), cfg)


def forward_decode(model, cache: list, batch: dict, pos: int):
    """One-token decode step at position `pos` (a Python int below the
    cache's S_max).  batch: {"token": (B,)} or, for embed_stub configs,
    {"embed": (B, D)}.  Writes the step's K and V into `cache` in place;
    returns (logits (B, vocab_padded), cache)."""
    cfg = model.cfg
    if cfg.embed_stub and "embed" in batch:
        x = batch["embed"][:, None].to(cfg.compute_dtype)
    else:
        x = model.embed[batch["token"][:, None]].to(cfg.compute_dtype)
    for lp, st in zip(model.blocks, cache):
        x = _decode_slot(lp, st, x, cfg, pos)
    x = _norm(cfg, model.final_ln, x)
    return _logits(model, x, cfg)[:, 0], cache


def forward_prefill(model, batch: dict):
    """Full-sequence prefill returning last-token logits (B,
    vocab_padded).  batch: {"tokens": (B, S)} or, for embed_stub configs,
    {"embeds": (B, S, D)}."""
    cfg = model.cfg
    x = _embed_inputs(model, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    x = _backbone(model, x, cfg, positions)
    return _logits(model, x[:, -1:], cfg)[:, 0]
