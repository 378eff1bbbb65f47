"""Shared transformer building blocks: the port of `repro/models/layers.py`.

Conventions (as in the JAX module):
  * activations (B, S, D)
  * dtype policy: parameters in cfg.param_dtype, compute in cfg.dtype;
    every product casts its weight to the activation's dtype
  * norms, RoPE angles, softmax and the attention accumulators in float32

Each layer is an `nn.Module` holding its parameters (`Attention`, `MLP`,
`RMSNorm`, `LayerNorm`) and a function beside it that takes the module
where JAX takes its parameter dict (`attn_full(p, x, cfg, positions)`).
The dense projections are `nn.Linear`s whose (out, in) weight is a
transposed view of an (in, out) array, JAX's layout.  Parameters are
built on the generator's device with `requires_grad=False`, so serving
records no autograd graph; the train step turns gradients on for the
model it trains (`repro_torch/train/step.py`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .sharding import constrain


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(in_dim, out_dim) normal weights scaled by 1/sqrt(in_dim), drawn
    in float32 on the generator's device."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """Normal draws in float32 on the generator's device, scaled, then
    cast (JAX's `(normal(key, shape) * scale).astype(dtype)`)."""
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    return normal_init(gen, (vocab, dim), 0.02, dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def linear(gen: torch.Generator, in_dim: int, out_dim: int,
           dtype: torch.dtype, bias: bool = False) -> nn.Linear:
    """An `nn.Linear` whose weight is `dense_init`'s (in, out) array seen
    as (out, in): no copy; bias zeros, as JAX initialises it."""
    lin = nn.Linear(in_dim, out_dim, bias=bias, device="meta")
    lin.weight = param(dense_init(gen, in_dim, out_dim, dtype).t())
    if bias:
        lin.bias = param(torch.zeros(out_dim, dtype=dtype,
                                     device=gen.device))
    return lin


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """x @ W (+ b) in x's dtype; the bias is added after the product, as
    JAX adds it."""
    y = F.linear(x, lin.weight.to(x.dtype))
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = param(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x):
        return rmsnorm(self, x)


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype, device):
        super().__init__()
        self.scale = param(torch.ones(dim, dtype=dtype, device=device))
        self.bias = param(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x):
        return layernorm(self, x)


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p.scale.float() + p.bias.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim)


def _rotate(x, ang):
    """Rotate the two halves of x's head dim (not interleaved pairs) by
    ang (..., hd/2), in float32."""
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd), positions: (B, S) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)         # (hd/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections=(16, 24, 24), theta: float = 10000.0
                ) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): positions (3, B, S) for (t, h, w);
    the head_dim/2 frequency slots go to the 3 sections by index (slots
    past the sections' sum take section 0)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = rope_freqs(hd, theta, x.device)
    sec = [0] * half
    off = 0
    for i, s in enumerate(sections):
        for j in range(off, min(off + s, half)):
            sec[j] = i
        off += s
    sec = torch.tensor(sec, dtype=torch.long, device=positions.device)
    pos_sel = positions.index_select(0, sec)             # (half, B, S)
    return _rotate(x, pos_sel.movedim(0, -1).float() * freqs)


# ---------------------------------------------------------------------------
# attention (GQA), three execution paths
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq, wk, wv (with biases where cfg.qkv_bias) and wo; the three
    paths are `attn_full`, `attn_chunked` (prefill) and `attn_decode`."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cfg.param_dtype
        self.wq = linear(gen, d, cfg.n_heads * hd, dt, cfg.qkv_bias)
        self.wk = linear(gen, d, cfg.n_kv_heads * hd, dt, cfg.qkv_bias)
        self.wv = linear(gen, d, cfg.n_kv_heads * hd, dt, cfg.qkv_bias)
        self.wo = linear(gen, cfg.n_heads * hd, d, dt)


def _project_qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = dense(x, p.wq).reshape(b, s, cfg.n_heads, hd)
    k = dense(x, p.wk).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(x, p.wv).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.rope == "mrope":
        if positions.ndim == 2:               # text-only: t == h == w
            positions = positions.expand((3,) + positions.shape)
        q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    elif cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, "data", None, "model", None, role="q")
    k = constrain(k, "data", None, "model", None, role="k")
    v = constrain(v, "data", None, "model", None, role="v")
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Hkv,hd) -> (B,S,H,hd) by group replication."""
    b, s, hkv, hd = k.shape
    rep = n_heads // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, rep, hd) \
        .reshape(b, s, n_heads, hd)


def attn_core_full(q, k, v, causal: bool = True):
    """Materialized-scores attention core; q,k,v: (B,S,H,hd) (kv already
    head-repeated).  Short sequences."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = logits.softmax(-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attn_full(p, x, cfg, positions, causal: bool = True):
    q, k, v = _project_qkv(p, x, cfg, positions)
    k, v = _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)
    out = attn_core_full(q, k, v, causal)
    return dense(out.reshape(x.shape[0], x.shape[1], -1), p.wo)


def attn_core_chunked(q, k, v, chunk: int = 1024, causal: bool = True):
    """Flash-style online-softmax core over KV chunks, so the (S x S)
    score matrix is never materialized: JAX's `lax.scan` as a loop over
    chunks with the same -1e30 mask and (acc, m, l) recurrence.  The
    chunk is halved until it divides S.  q,k,v: (B,S,H,hd), kv already
    head-repeated."""
    b, s, h, hd = q.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    scale = 1.0 / math.sqrt(hd)
    q32 = q.float() * scale
    qpos = torch.arange(s, device=q.device)
    acc = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    for j in range(s // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", q32, kj)
        if causal:
            kpos = j * chunk + torch.arange(chunk, device=q.device)
            logits = logits.masked_fill(qpos[:, None] < kpos[None, :],
                                        -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        pj = torch.exp(logits - m_new[..., None])
        l = l * alpha + pj.sum(-1)
        acc = acc * alpha.transpose(1, 2)[..., None] \
            + torch.einsum("bhqk,bkhd->bqhd", pj, vj)
        m = m_new
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attn_chunked(p, x, cfg, positions, chunk: int = 1024,
                 causal: bool = True):
    q, k, v = _project_qkv(p, x, cfg, positions)
    k, v = _repeat_kv(k, cfg.n_heads), _repeat_kv(v, cfg.n_heads)
    out = attn_core_chunked(q, k, v, chunk, causal)
    return dense(out.reshape(x.shape[0], x.shape[1], -1), p.wo)


def attn_decode(p, x, cfg, cache_k, cache_v, pos: int):
    """Single-token decode against a (B, S_max, Hkv, hd) KV cache: writes
    this position's K and V into the caches in place (in the caches'
    dtype) and attends over all S_max slots, those past `pos` masked, in
    float32.  Returns (out, cache_k, cache_v)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
    kk = _repeat_kv(cache_k, cfg.n_heads)
    vv = _repeat_kv(cache_v, cfg.n_heads)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * scale
    smax = cache_k.shape[1]
    valid = torch.arange(smax, device=x.device) <= pos
    logits = logits.masked_fill(~valid, -1e30)
    probs = logits.softmax(-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv.float())
    out = out.to(x.dtype).reshape(b, 1, -1)
    return dense(out, p.wo), cache_k, cache_v


def cross_attention(p, x, enc_kv, cfg):
    """Decoder cross-attention (whisper) over the encoder's K and V
    (B, S_enc, Hkv, hd), unmasked, in float32.  As in JAX, the query and
    the encoder's K and V take no bias."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = F.linear(x, p.wq.weight.to(x.dtype)).reshape(b, s, cfg.n_heads, hd)
    k, v = (_repeat_kv(t, cfg.n_heads) for t in enc_kv)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v.float())
    return dense(out.to(x.dtype).reshape(b, s, -1), p.wo)


def encode_kv(p, enc_out, cfg):
    """The cross-attention's K and V of the encoder output (B, S_enc,
    D), each (B, S_enc, Hkv, hd) in enc_out's dtype."""
    b, s, _ = enc_out.shape
    shape = (b, s, cfg.n_kv_heads, cfg.head_dim)
    return tuple(F.linear(enc_out, w.weight.to(enc_out.dtype)).reshape(shape)
                 for w in (p.wk, p.wv))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """wi, wg (swiglu only) and wo."""

    def __init__(self, cfg, gen: torch.Generator,
                 d_ff: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.param_dtype
        self.wi = linear(gen, d, f, dt)
        if cfg.act == "swiglu":
            self.wg = linear(gen, d, f, dt)
        self.wo = linear(gen, f, d, dt)

    def forward(self, x):
        return mlp(self, x, self.cfg)


def activation(h, g, act: str):
    """The MLP's nonlinearity on the up projection h (g: swiglu's gate
    projection).  gelu is the tanh approximation, jax.nn.gelu's
    default."""
    if act == "swiglu":
        return F.silu(h) * g
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "relu2":                          # nemotron squared-ReLU
        return F.relu(h).square()
    raise ValueError(act)


def mlp(p, x, cfg):
    h = constrain(dense(x, p.wi), "data", None, "model", role="mlp_in")
    g = constrain(dense(x, p.wg), "data", None, "model",
                  role="mlp_gate") if cfg.act == "swiglu" else None
    return constrain(dense(activation(h, g, cfg.act), p.wo),
                     "data", None, None, role="mlp_out")


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; logits (B, S, V) cast to float32,
    labels (B, S) integers."""
    logits = logits.float()
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - gold).mean()
