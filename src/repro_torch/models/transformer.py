"""Model assembly for training, prefill and decode: the port of
`repro/models/transformer.py` for every family.

Families:
  dense | moe  -- decoder-only transformer (GQA, RoPE/M-RoPE, MLP, MoE or
                  MoE + dense residual)
  ssm          -- RWKV-6 (attention-free: time mix and channel mix)
  hybrid       -- Jamba (Mamba and attention layers, MoE every other)
  encdec       -- Whisper (an encoder over frame embeddings, a causal
                  decoder with cross-attention)

Layout: JAX scans one repeat unit of `block_pattern(cfg)` over
parameters stacked on a leading repeat axis; the port unrolls the scan
into `blocks`, an `nn.ModuleList` of n_layers slots in pattern order
(layer r * len(pattern) + i is slot i of repeat r); whisper's encoder
layers are `enc_blocks`.  The decode cache is a list of per-layer dicts
holding the state `_slot_cache` gives the layer's mixer: "k"/"v" (B,
S_max, Hkv, hd) in bfloat16 for attention, whatever cfg.dtype is, as JAX
keeps it; "conv" (B, D_CONV - 1, di) in cfg.dtype and "ssm" (B, di,
D_STATE) in float32 for Mamba; "wkv" (B, H, hd, hd) in float32 and
"tm_x"/"cm_x" (B, D) in cfg.dtype for RWKV; and for whisper also
"ck"/"cv" (B, enc_seq, Hkv, hd) in bfloat16, the cross-attention's
encoder K and V.  `init_cache` makes them zeros, as JAX's does, and no
entry point fills ck/cv: `encode_cross` does, from the encoder over
given frames.

Training: `forward_train` is JAX's (attention unmasked-full below 2,048
positions and chunked from there, Mamba's scan, RWKV's chunked WKV
where S allows, the MoE aux term summed over layers, the loss ce + 0.01
aux), and its cross-entropy runs over CE_CHUNK-position chunks so the
(B, S, V) logits never exist at once.  `cfg.remat` recomputes each
layer and each CE chunk in the backward pass
(`torch.utils.checkpoint`, JAX's `jax.checkpoint`).  Parameters are
built with `requires_grad=False` (`layers.param`), so serving never
records a graph; the train step turns gradients on for the model it
trains (`train/step.py`).

Public API:
  init_params(cfg, seed, device)               -> Transformer
  first_layers(model, n)                       -> Transformer (shared)
  params_from_jax(cfg, tree, device)           -> Transformer
  state_from_jax(cfg, tree)                    -> {port name: array}
  forward_train(model, batch[, cfg])           -> (loss, {"ce", "aux"})
  init_cache(cfg, batch, max_seq, device)      -> cache
  encode_cross(model, cache, batch)            -> cache (ck/cv filled)
  forward_prefill(model, batch)                -> last-token logits
  forward_decode(model, cache, batch, pos)     -> (logits, cache)

Entry points default to the card (`device="cuda"`); tests pass "cpu".
The vocab is padded to a multiple of 256: logits have vocab_padded(cfg)
columns, and a caller takes the first cfg.vocab.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba as MAMBA
from . import moe as MOE
from . import rwkv as RWKV
from .sharding import constrain

PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
CE_CHUNK = 512
# JAX's train mode: the full (S x S) attention below this many positions
FULL_ATTN_MAX = 2048
# whisper's decoder position table (JAX's init_params)
POS_ROWS = 32768


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
    """One layer: ln1 and its mixer (`attn`, `mamba`, or RWKV's time mix
    `tm`), ln2 and its ffn (`mlp`, `moe`, both, or RWKV's channel mix
    `cm`); a whisper decoder layer (`cross`) adds ln_x and the
    cross-attention `xattn`."""

    def __init__(self, cfg, mixer: str, ffn: str, gen: torch.Generator,
                 cross: bool = False):
        super().__init__()
        self.mixer, self.ffn = mixer, ffn
        self.ln1 = _make_norm(cfg, gen.device)
        self.ln2 = _make_norm(cfg, gen.device)
        if mixer == "attn":
            self.attn = L.Attention(cfg, gen)
        elif mixer == "mamba":
            self.mamba = MAMBA.Mamba(cfg, gen)
        else:
            self.tm = RWKV.TimeMix(cfg, gen)
        if ffn in ("moe", "moe+mlp"):
            self.moe = MOE.MoE(cfg, gen)
        if ffn in ("mlp", "moe+mlp"):
            self.mlp = L.MLP(cfg, gen)
        if ffn == "rwkv_cm":
            self.cm = RWKV.ChannelMix(cfg, gen)
        if cross:
            self.xattn = L.Attention(cfg, gen)
            self.ln_x = _make_norm(cfg, gen.device)


class Transformer(nn.Module):
    """embed (vocab_padded, D), blocks, final_ln, and lm_head where the
    embeddings are not tied (the tied head is embed.T); for whisper also
    enc_blocks, enc_final_ln, pos_embed (POS_ROWS, D) and enc_pos_embed
    (enc_seq, D)."""

    def __init__(self, cfg, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
        device = _device(device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        vp = vocab_padded(cfg)
        self.embed = L.param(L.embed_init(gen, vp, cfg.d_model,
                                          cfg.param_dtype))
        if not cfg.tie_embeddings:
            self.lm_head = L.linear(gen, cfg.d_model, vp, cfg.param_dtype)
        cross = cfg.family == "encdec"
        self.blocks = nn.ModuleList(Block(cfg, mixer, ffn, gen, cross)
                                    for mixer, ffn in layer_slots(cfg))
        self.final_ln = _make_norm(cfg, device)
        if cross:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, "attn", "mlp", gen)
                for _ in range(cfg.n_enc_layers))
            self.enc_final_ln = _make_norm(cfg, device)
            self.pos_embed = L.param(L.embed_init(gen, POS_ROWS, cfg.d_model,
                                                  cfg.param_dtype))
            self.enc_pos_embed = L.param(L.embed_init(
                gen, cfg.enc_seq, cfg.d_model, cfg.param_dtype))


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


def first_layers(model: Transformer, n: int) -> Transformer:
    """The model's first n layers as a model of its own: the same modules
    (embedding, those blocks, final norm, head, the encoder), cfg's
    n_layers n.  n is a whole number of repeat units."""
    if n % len(block_pattern(model.cfg)) or not 0 < n <= len(model.blocks):
        raise ValueError(f"{model.cfg.name}: no model of its first {n} "
                         "layers")
    view = copy.copy(model)
    view._modules = dict(model._modules)    # the original's stays whole
    view.blocks = model.blocks[:n]
    view.cfg = dataclasses.replace(model.cfg, n_layers=n)
    return view


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


# the dense (in, out) weights of each layer kind, nn.Linears in the port
_LINEARS = {"tm": ("wr", "wk", "wv", "wg", "wo", "lora_a", "wa"),
            "cm": ("wk", "wv", "wr"),
            "mamba": ("in_proj", "x_proj", "dt_proj", "out_proj")}


def jax_name(path: str) -> tuple[str, bool]:
    """The port's parameter name for a leaf of one JAX layer, and whether
    its array is transposed: an (in, out) dense weight `attn.wq` is
    `attn.wq.weight` of an nn.Linear (out, in), its bias `attn.bq` is
    `attn.wq.bias` (likewise `xattn.*` and `mlp.*`); the dense weights of
    `tm`, `cm` and `mamba` (`_LINEARS`) are nn.Linears too, and their
    other leaves keep JAX's name and layout; the MoE's stacked experts
    and float32 router keep JAX's layout (`moe.experts.wi` is
    `moe.wi`)."""
    parts = path.split(".")
    if parts[0] in ("attn", "xattn", "mlp"):
        name = parts[1]
        if name.startswith("b"):
            return f"{parts[0]}.w{name[1:]}.bias", False
        return f"{parts[0]}.{name}.weight", True
    if parts[1] in _LINEARS.get(parts[0], ()):
        return f"{parts[0]}.{parts[1]}.weight", True
    if parts[0] == "moe" and parts[1] == "experts":
        return f"moe.{parts[2]}", False
    return path, False


def jax_leaf(name: str) -> tuple[str, bool]:
    """The inverse of `jax_name`: the JAX leaf ("."-joined path within
    one layer) of the port's parameter `name` within one layer, and
    whether the port's array is its transpose."""
    parts = name.split(".")
    if parts[0] in ("attn", "xattn", "mlp"):
        if parts[2] == "bias":
            return f"{parts[0]}.b{parts[1][1:]}", False
        return f"{parts[0]}.{parts[1]}", True
    if parts[1] in _LINEARS.get(parts[0], ()):
        return f"{parts[0]}.{parts[1]}", True
    if parts[0] == "moe" and parts[1] != "router":
        return f"moe.experts.{parts[1]}", False
    return name, False


def state_from_jax(cfg, tree: dict) -> dict:
    """The port's state dict, as numpy arrays, of a JAX pytree shaped like
    `init_params`' (parameters, or their gradients): the leading repeat
    axis of tree["blocks"] unstacked into layers (and whisper's
    tree["enc_blocks"], stacked over n_enc_layers, into enc_blocks),
    dense weights transposed into nn.Linear's (out, in) layout (`jax_name`),
    the tied head left as embed."""
    sd = {"embed": tree["embed"]}
    for top in ("final_ln", "enc_final_ln"):
        sd.update((f"{top}.{k}", v) for k, v in tree.get(top, {}).items())
    for top in ("pos_embed", "enc_pos_embed"):
        if top in tree:
            sd[top] = tree[top]
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
    for path, leaf in _flat(tree.get("enc_blocks", {})):
        name, transpose = jax_name(path)
        for i in range(leaf.shape[0]):
            sd[f"enc_blocks.{i}.{name}"] = leaf[i].T if transpose \
                else leaf[i]
    return sd


def params_from_jax(cfg, tree: dict, device="cuda") -> Transformer:
    """A `Transformer` holding the JAX parameter pytree `tree` (its
    leaves numpy arrays: `jax.tree.map(np.asarray, params)`), laid out
    by `state_from_jax`; the router and a_log stay float32.  Every
    parameter is loaded (strict)."""
    model = Transformer(cfg, 0, device)
    sd = state_from_jax(cfg, tree)
    model.load_state_dict({k: _tensor(v, device) for k, v in sd.items()},
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# block application (train / prefill)
# ---------------------------------------------------------------------------

def _ffn(lp: Block, h, cfg):
    """The layer's mlp, moe or moe + mlp on the normed h, and the MoE's
    aux load-balance term (None without a MoE).  RWKV's channel mix is
    the caller's: it carries a token."""
    if lp.ffn == "mlp":
        return L.mlp(lp.mlp, h, cfg), None
    f, aux = MOE.moe_apply(lp.moe, h, cfg)
    if lp.ffn == "moe+mlp":
        f = f + L.mlp(lp.mlp, h, cfg)
    return f, aux


def _apply_slot(lp: Block, x, cfg, positions, mode: str, enc_out=None):
    """One layer over the whole sequence; returns (x, the MoE's aux term
    or None).  Attention: at prefill, or in train mode from
    FULL_ATTN_MAX positions, the chunked online-softmax core (never the
    (S x S) score matrix), chunk cfg.attn_chunk; in train mode below
    that, the full core.  Mamba's
    scan; RWKV's time mix in its chunked form where S allows, its token
    shifts from zeros; whisper's cross-attention over enc_out."""
    h = _norm(cfg, lp.ln1, x)
    if lp.mixer == "attn":
        if mode == "prefill" or x.shape[1] >= FULL_ATTN_MAX:
            a = L.attn_chunked(lp.attn, h, cfg, positions,
                               chunk=cfg.attn_chunk)
        else:
            a = L.attn_full(lp.attn, h, cfg, positions)
    elif lp.mixer == "mamba":
        a, _ = MAMBA.mamba_apply(lp.mamba, h, cfg, mode="train")
    else:
        a, _ = RWKV.timemix_apply(lp.tm, h, None, cfg, mode="chunked")
    x = x + a
    h = _norm(cfg, lp.ln2, x)
    if lp.ffn == "rwkv_cm":
        f, aux = RWKV.channelmix_apply(lp.cm, h, None, cfg), None
    else:
        f, aux = _ffn(lp, h, cfg)
    x = x + f
    if enc_out is not None:
        hx = _norm(cfg, lp.ln_x, x)
        kv = L.encode_kv(lp.xattn, enc_out, cfg)
        x = x + L.cross_attention(lp.xattn, hx, kv, cfg)
    return x, aux


def _embed_inputs(model, batch, cfg):
    if cfg.embed_stub and "embeds" in batch:
        x = batch["embeds"].to(cfg.compute_dtype)
    else:
        x = model.embed[batch["tokens"]].to(cfg.compute_dtype)
    return constrain(x, "data", None, None, role="embed")


def _remat(on: bool, fn, *args):
    """fn(*args), recomputed in the backward pass where `on` (training
    under cfg.remat) and autograd records."""
    if on and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _enc_layer(lp: Block, x, cfg, positions):
    h = _norm(cfg, lp.ln1, x)
    x = x + L.attn_full(lp.attn, h, cfg, positions, causal=False)
    return x + L.mlp(lp.mlp, _norm(cfg, lp.ln2, x), cfg)


def _encode(model, batch, cfg=None, train: bool = False):
    """Whisper's encoder over batch["enc_embeds"] (B, S_enc, D), S_enc
    at most enc_seq: its positions added, non-causal attention, then
    enc_final_ln.  cfg: model.cfg unless given; `train` recomputes each
    layer in the backward pass where cfg.remat."""
    cfg = cfg or model.cfg
    x = batch["enc_embeds"].to(cfg.compute_dtype)
    b, s = x.shape[:2]
    x = x + model.enc_pos_embed[:s].to(x.dtype)[None]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    for lp in model.enc_blocks:
        x = _remat(train and cfg.remat, _enc_layer, lp, x, cfg, positions)
    return _norm(cfg, model.enc_final_ln, x)


def _backbone(model, x, cfg, positions, mode: str, enc_out=None):
    """Every layer in order (in train mode each recomputed in the
    backward pass where cfg.remat), then the final norm; returns (x, the
    layers' aux summed in float32).  Under cfg.seq_parallel the residual
    stream is constrained sequence-sharded on "model" before the first
    layer and after each repeat unit (JAX's scan boundary)."""
    aux = x.new_zeros((), dtype=torch.float32)
    remat = mode == "train" and cfg.remat
    plen = len(block_pattern(cfg))
    if cfg.seq_parallel:
        x = constrain(x, "data", "model", None, role="residual")
    for i, lp in enumerate(model.blocks):
        x, a = _remat(remat, _apply_slot, lp, x, cfg, positions, mode,
                      enc_out)
        if a is not None:
            aux = aux + a
        if cfg.seq_parallel and (i + 1) % plen == 0:
            x = constrain(x, "data", "model", None, role="residual")
    return _norm(cfg, model.final_ln, x), aux


def _logits(model, x, cfg):
    if cfg.tie_embeddings:
        return torch.nn.functional.linear(x, model.embed.to(x.dtype))
    return L.dense(x, model.lm_head)


def _ce_chunk(model, xi, li, cfg):
    """The summed CE of one chunk: logits in float32, the padded-vocab
    tail at -1e30, logsumexp minus the gold logit."""
    lg = _logits(model, xi, cfg).float()
    vmask = torch.arange(lg.shape[-1], device=lg.device) < cfg.vocab
    lg = torch.where(vmask, lg, -1e30)
    gold = lg.gather(-1, li[..., None])[..., 0]
    return (torch.logsumexp(lg, -1) - gold).sum()


def _chunked_ce(model, x, labels, cfg):
    """Mean CE over sequence chunks of CE_CHUNK positions (each chunk's
    logits recomputed in the backward pass where cfg.remat); the
    padded-vocab tail masked out."""
    b, s, _ = x.shape
    chunk = min(CE_CHUNK, s)
    if s % chunk:
        raise ValueError(f"{s} positions are no whole number of "
                         f"{chunk}-position CE chunks")
    labels = labels.long()
    tot = x.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        tot = tot + _remat(cfg.remat, _ce_chunk, model, x[:, i:i + chunk],
                           labels[:, i:i + chunk], cfg)
    return tot / (b * s)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(model, batch: dict, cfg=None):
    """The training loss of a batch: {"tokens": (B, S)} or, for
    embed_stub configs other than whisper, {"embeds": (B, S, D)};
    "labels" (B, S); whisper also {"enc_embeds": (B, S_enc, D)}.  S is a
    whole number of CE chunks.  cfg: model.cfg unless given (the same
    weights under another policy, e.g. remat).  Returns (loss, {"ce",
    "aux"}), float32 scalars, loss = ce + 0.01 * aux."""
    cfg = cfg or model.cfg
    x = _embed_inputs(model, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(model, batch, cfg, train=True)
        x = x + model.pos_embed[:s].to(x.dtype)[None]
    x, aux = _backbone(model, x, cfg, positions, "train", enc_out)
    ce = _chunked_ce(model, x, batch["labels"], cfg)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _slot_cache(cfg, mixer: str, batch_size: int, max_seq: int, device):
    """One layer's zero decode state (JAX's `_slot_cache`)."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    hd, bf16 = cfg.head_dim, torch.bfloat16
    if mixer == "attn":
        shape = (batch_size, max_seq, cfg.n_kv_heads, hd)
        st = {"k": zeros(shape, bf16), "v": zeros(shape, bf16)}
    elif mixer == "mamba":
        di = cfg.mamba_d_inner or 2 * cfg.d_model
        st = {"conv": zeros((batch_size, MAMBA.D_CONV - 1, di),
                            cfg.compute_dtype),
              "ssm": zeros((batch_size, di, MAMBA.D_STATE), torch.float32)}
    else:
        h, d = cfg.n_heads, cfg.d_model
        st = {"wkv": zeros((batch_size, h, d // h, d // h), torch.float32),
              "tm_x": zeros((batch_size, d), cfg.compute_dtype),
              "cm_x": zeros((batch_size, d), cfg.compute_dtype)}
    if cfg.family == "encdec":
        shape = (batch_size, cfg.enc_seq, cfg.n_kv_heads, hd)
        st["ck"], st["cv"] = zeros(shape, bf16), zeros(shape, bf16)
    return st


def init_cache(cfg, batch_size: int, max_seq: int, device="cuda") -> list:
    """Decode state: one dict of zeros per layer, as its mixer needs
    (module docstring)."""
    device = _device(device)
    return [_slot_cache(cfg, mixer, batch_size, max_seq, device)
            for mixer, _ in layer_slots(cfg)]


def encode_cross(model, cache: list, batch: dict) -> list:
    """Whisper: run the encoder over batch["enc_embeds"] (B, enc_seq, D)
    and write each decoder layer's cross-attention K and V of its output
    into the cache's ck/cv, in place, in their bfloat16."""
    enc_out = _encode(model, batch)
    for lp, st in zip(model.blocks, cache):
        k, v = L.encode_kv(lp.xattn, enc_out, model.cfg)
        st["ck"].copy_(k)
        st["cv"].copy_(v)
    return cache


def _decode_slot(lp: Block, st: dict, x, cfg, pos: int):
    """One layer, one position: the mixer's and the channel mix's state
    replaced in `st` (RWKV carries the normed h of ln1 and ln2)."""
    h = _norm(cfg, lp.ln1, x)
    if lp.mixer == "attn":
        a, st["k"], st["v"] = L.attn_decode(lp.attn, h, cfg, st["k"],
                                            st["v"], pos)
    elif lp.mixer == "mamba":
        a, ms = MAMBA.mamba_apply(lp.mamba, h, cfg, mode="decode",
                                  state={"conv": st["conv"],
                                         "ssm": st["ssm"]})
        st["conv"], st["ssm"] = ms["conv"], ms["ssm"]
    else:
        a, st["wkv"] = RWKV.timemix_apply(lp.tm, h, st["tm_x"], cfg,
                                          mode="decode", state=st["wkv"])
        st["tm_x"] = h[:, 0]
    x = x + a
    h = _norm(cfg, lp.ln2, x)
    if lp.ffn == "rwkv_cm":
        x = x + RWKV.channelmix_apply(lp.cm, h, st["cm_x"], cfg)
        st["cm_x"] = h[:, 0]
    else:
        x = x + _ffn(lp, h, cfg)[0]
    if cfg.family == "encdec":
        hx = _norm(cfg, lp.ln_x, x)
        x = x + L.cross_attention(lp.xattn, hx, (st["ck"], st["cv"]), cfg)
    return x


def forward_decode(model, cache: list, batch: dict, pos: int):
    """One-token decode step at position `pos` (a Python int below the
    cache's S_max where it has attention).  batch: {"token": (B,)} or,
    for embed_stub configs other than whisper, {"embed": (B, D)}.
    Updates `cache` in place (K and V written at `pos`, recurrent states
    replaced); returns (logits (B, vocab_padded), cache)."""
    cfg = model.cfg
    if cfg.embed_stub and "embed" in batch:
        x = batch["embed"][:, None].to(cfg.compute_dtype)
    else:
        x = model.embed[batch["token"][:, None]].to(cfg.compute_dtype)
    if cfg.family == "encdec":
        x = x + model.pos_embed[pos:pos + 1].to(x.dtype)[None]
    for lp, st in zip(model.blocks, cache):
        x = _decode_slot(lp, st, x, cfg, pos)
    x = _norm(cfg, model.final_ln, x)
    return _logits(model, x, cfg)[:, 0], cache


def forward_prefill(model, batch: dict):
    """Full-sequence prefill returning last-token logits (B,
    vocab_padded).  batch: {"tokens": (B, S)} or, for embed_stub configs
    other than whisper, {"embeds": (B, S, D)}; whisper also takes
    {"enc_embeds": (B, S_enc, D)}.  Like JAX's, it writes no decode
    state."""
    cfg = model.cfg
    x = _embed_inputs(model, batch, cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(model, batch)
        x = x + model.pos_embed[:s].to(x.dtype)[None]
    x, _aux = _backbone(model, x, cfg, positions, "prefill", enc_out)
    return _logits(model, x[:, -1:], cfg)[:, 0]
