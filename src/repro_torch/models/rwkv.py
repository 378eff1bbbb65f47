"""RWKV-6 "Finch" blocks: the port of `repro/models/rwkv.py`.

An attention-free time mix with a data-dependent decay, and a channel
mix.  The time mix runs three ways: the O(T) scan (`_wkv_scan`), the
chunked matmul-parallel form (`_wkv_chunked`, GLA-style: masked matmuls
within a chunk, a short scan across chunks), and the O(1) decode step
against a carried (B, H, hd, hd) state.  Which prefill form runs is
JAX's rule: the chunked one where S % 64 == 0 and S >= 128, else the
scan.

As in JAX, the decay's log, the WKV state and outputs and the group
norm run in float32 whatever cfg.dtype is.  The chunked form multiplies
by exp(-cum) and exp(cum - logw); it stays finite because the decays
sit near 1 (w0 = -6, small wb), so the init follows JAX's distributions
exactly.  Dense projections are `nn.Linear`s over JAX's (in, out)
arrays (`layers.linear`); the other leaves keep JAX's layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import dense, linear, normal_init, param
from .sharding import constrain

LORA_R = 32      # low-rank dims for the data-dependent pieces
DECAY_R = 64


class TimeMix(nn.Module):
    """mu (5, D) for r, k, v, w, g; lora_a (a Linear D -> 5 * LORA_R) and
    lora_b (5, LORA_R, D); wr, wk, wv, wg, wo; the decay bias w0 (D,),
    wa (a Linear D -> DECAY_R) and wb (DECAY_R, D); the bonus u (H, hd);
    ln_x (D,), the group norm's scale."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, h, dt = cfg.d_model, cfg.n_heads, cfg.param_dtype
        dev = gen.device
        self.mu = param(torch.full((5, d), 0.5, dtype=dt, device=dev))
        self.lora_a = linear(gen, d, LORA_R * 5, dt)
        self.lora_b = param(normal_init(gen, (5, LORA_R, d), 0.01, dt))
        self.wr = linear(gen, d, d, dt)
        self.wk = linear(gen, d, d, dt)
        self.wv = linear(gen, d, d, dt)
        self.wg = linear(gen, d, d, dt)
        self.wo = linear(gen, d, d, dt)
        self.w0 = param(torch.full((d,), -6.0, dtype=dt, device=dev))
        self.wa = linear(gen, d, DECAY_R, dt)
        self.wb = param(normal_init(gen, (DECAY_R, d), 0.01, dt))
        self.u = param(normal_init(gen, (h, d // h), 0.1, dt))
        self.ln_x = param(torch.ones(d, dtype=dt, device=dev))


class ChannelMix(nn.Module):
    """mu_k, mu_r (D,); wk (D -> F), wv (F -> D), wr (D -> D)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
        self.mu_k = param(torch.full((d,), 0.5, dtype=dt, device=gen.device))
        self.mu_r = param(torch.full((d,), 0.5, dtype=dt, device=gen.device))
        self.wk = linear(gen, d, f, dt)
        self.wv = linear(gen, f, d, dt)
        self.wr = linear(gen, d, d, dt)


def _shifted(x, x_prev_token):
    """x shifted one position right: zeros (prefill) or the carried
    token (decode) in front."""
    if x_prev_token is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev_token[:, None], x[:, :-1]], 1)


def _ddlerp(p, x, x_prev):
    """Data-dependent interpolation of x and shifted x (RWKV6): the five
    mixes r, k, v, w, g."""
    base = x + (x_prev - x) * p.mu[3].to(x.dtype)            # w-channel mix
    lora = torch.tanh(dense(base, p.lora_a))
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, 5, LORA_R)
    adj = torch.einsum("bsfr,frd->bsfd", lora.float(),
                       p.lora_b.float()).to(x.dtype)
    return [x + (x_prev - x) * (p.mu[i].to(x.dtype) + adj[:, :, i])
            for i in range(5)]


def _proj_rkvwg(p, x, x_prev, cfg):
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    b, s, _ = x.shape
    r = dense(xr, p.wr).reshape(b, s, h, hd)
    k = dense(xk, p.wk).reshape(b, s, h, hd)
    v = dense(xv, p.wv).reshape(b, s, h, hd)
    g = F.silu(dense(xg, p.wg))
    # data-dependent decay w in (0, 1): exp(-exp(.)), in float32
    wlog = p.w0.float() + torch.tanh(
        F.linear(xw.float(), p.wa.weight.float())) @ p.wb.float()
    w = torch.exp(-torch.exp(wlog)).reshape(b, s, h, hd)
    return r, k, v, w, g


def _wkv_scan(r, k, v, w, u):
    """Sequential WKV: state (B,H,hd,hd); out_t = r_t (S + u k_t v_t^T).
    A loop over S, in float32."""
    b, s, h, hd = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[..., :, None] * kv))
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(outs, 1)                              # (B,S,H,hd)


def _wkv_chunked(r, k, v, w, u, chunk: int = 64):
    """Chunked-parallel WKV (GLA-style): intra-chunk via masked matmuls
    with cumulative decay products; inter-chunk state via a loop of
    S/chunk steps."""
    b, s, h, hd = r.shape
    n = s // chunk
    rc, kc, vc, wc = (t.float().reshape(b, n, chunk, h, hd)
                      for t in (r, k, v, w))
    logw = torch.log(wc.clamp_min(1e-30))
    cum = torch.cumsum(logw, 2)                   # inclusive within chunk
    total = cum[:, :, -1]                         # (B,N,H,hd)

    # intra-chunk: out_t += r_t * prod_{j<t} decays * k_j v_j
    ri = rc * torch.exp(cum - logw)               # r_t * exp(cum_{t-1})
    ki = kc * torch.exp(-cum)                     # k_j * exp(-cum_j)
    att = torch.einsum("bnchd,bnjhd->bnhcj", ri, ki)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=r.device).tril(-1)
    att = torch.where(tri, att, 0.0)
    intra = torch.einsum("bnhcj,bnjhd->bnchd", att, vc)
    bonus = torch.einsum("bnchd,bnchd->bnch", rc * u, kc)
    intra = intra + bonus[..., None] * vc

    # inter-chunk: carry state across chunks
    kdec = kc * torch.exp(total[:, :, None] - cum)  # decay to chunk end
    kv_chunk = torch.einsum("bnchd,bnche->bnhde", kdec, vc)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    states = []                                   # state entering chunk n
    for i in range(n):
        states.append(state)
        state = state * torch.exp(total[:, i])[..., None] + kv_chunk[:, i]
    states = torch.stack(states, 1)
    rdec = rc * torch.exp(cum - logw)             # decay from chunk start
    inter = torch.einsum("bnchd,bnhde->bnche", rdec, states)
    return (intra + inter).reshape(b, s, h, hd)


def timemix_apply(p, x, x_prev_token, cfg, mode: str = "chunked",
                  state=None):
    """mode: 'scan' | 'chunked' (prefill) | 'decode' (S = 1, state
    (B, H, hd, hd) float32).  Returns (y, new state; None but in
    decode)."""
    b, s, d = x.shape
    h, hd = cfg.n_heads, d // cfg.n_heads
    r, k, v, w, g = _proj_rkvwg(p, x, _shifted(x, x_prev_token), cfg)
    u = p.u.float()

    if mode == "decode":
        rt, kt, vt, wt = (t[:, 0].float() for t in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        out = torch.einsum("bhi,bhij->bhj", rt, state + u[..., :, None] * kv)
        new_state = state * wt[..., :, None] + kv
        out = out[:, None]                         # (B,1,H,hd)
    elif mode == "chunked" and s % 64 == 0 and s >= 128:
        out, new_state = _wkv_chunked(r, k, v, w, u), None
    else:
        out, new_state = _wkv_scan(r, k, v, w, u), None

    # group norm over heads, then gate and output proj
    outf = out.reshape(b, -1, h, hd)
    mu = outf.mean(-1, keepdim=True)
    var = ((outf - mu) ** 2).mean(-1, keepdim=True)
    outf = (outf - mu) * torch.rsqrt(var + 1e-5)
    outf = outf.reshape(b, -1, d) * p.ln_x.float()
    y = dense(outf.to(x.dtype) * g, p.wo)
    return constrain(y, "data", None, None, role="timemix_out"), new_state


def channelmix_apply(p, x, x_prev_token, cfg):
    x_prev = _shifted(x, x_prev_token)
    xk = x + (x_prev - x) * p.mu_k.to(x.dtype)
    xr = x + (x_prev - x) * p.mu_r.to(x.dtype)
    kk = constrain(F.relu(dense(xk, p.wk)).square(), "data", None, "model",
                   role="channelmix_hidden")
    return torch.sigmoid(dense(xr, p.wr)) * dense(kk, p.wv)
