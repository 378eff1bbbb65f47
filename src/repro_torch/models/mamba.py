"""Mamba (S6 selective SSM) block for the Jamba hybrid: the port of
`repro/models/mamba.py`.

Prefill ('train' mode): a causal depthwise conv, then the selective scan
over time, one step per position.  Decode: an O(1) recurrent step with
the carried conv window (B, D_CONV - 1, di) and SSM state (B, di,
D_STATE).

The scan never materialises the discretised (B, S, di, N) tensors (8.6
GB each at Jamba's width): each step rebuilds its (B, di, N) decay and
input from (B, di)-sized slices.  As in JAX, the scan streams dt, B, C
and the conv output in bfloat16 and emits y in bfloat16 whatever
cfg.dtype is, while the state stays float32.  JAX nests its scan in
256-position chunks for the backward pass; the forward is the same
recurrence, so the port runs one loop.

The SSD (Mamba-2-style) chunked variant, opt-in through REPRO_MAMBA2
(`ssd_enabled`), collapses the decay to a scalar per (head, token) so
the recurrence factors into causal matmuls within chunks and a short
scan across them.  `a_log` stays float32 whatever cfg.param_dtype is.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.utils.loops import steps
from .layers import dense, linear, normal_init, param
from .sharding import constrain

D_CONV = 4       # causal conv kernel width
D_STATE = 16     # SSM state dim per channel
SSD_HEAD_DIM = 64


class Mamba(nn.Module):
    """in_proj (D -> 2 di), conv_w (D_CONV, di), conv_b, x_proj (di ->
    dt_rank + 2 N), dt_proj (dt_rank -> di), dt_bias (softplus ~ 0.01),
    a_log (di, N) float32, d_skip, out_proj (di -> D)."""

    def __init__(self, cfg, gen: torch.Generator):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        di = cfg.mamba_d_inner or 2 * d
        dt_rank = max(d // 16, 1)
        dev = gen.device
        self.in_proj = linear(gen, d, 2 * di, dt)
        self.conv_w = param(normal_init(gen, (D_CONV, di), 0.1, dt))
        self.conv_b = param(torch.zeros(di, dtype=dt, device=dev))
        self.x_proj = linear(gen, di, dt_rank + 2 * D_STATE, dt)
        self.dt_proj = linear(gen, dt_rank, di, dt)
        self.dt_bias = param(torch.full((di,), -4.6, dtype=dt, device=dev))
        a = torch.arange(1, D_STATE + 1, dtype=torch.float32, device=dev)
        self.a_log = param(torch.log(a).expand(di, D_STATE).clone())
        self.d_skip = param(torch.ones(di, dtype=dt, device=dev))
        self.out_proj = linear(gen, di, d, dt)


def _ssm_params(p, xc):
    """xc: (B, S, di) post-conv activations -> (dt, Bmat, Cmat), float32."""
    dt_rank = p.dt_proj.weight.shape[1]
    proj = dense(xc, p.x_proj)
    dt, bmat, cmat = proj.split([dt_rank, D_STATE, D_STATE], -1)
    dt = F.softplus(dense(dt, p.dt_proj).float() + p.dt_bias.float())
    return dt, bmat.float(), cmat.float()


def _ssd_chunked(xh, dt_h, a_h, bm, cm, chunk: int = 128):
    """SSD (Mamba-2) chunked recurrence.

    xh (B,T,H,hd), dt_h (B,T,H) post-softplus, a_h (H,) negative,
    bm/cm (B,T,N).  State S_t = exp(dt_t a_h) S_{t-1} + dt_t B_t x_t^T;
    y_t = S_t^T C_t, i.e.
      y_t = sum_{j<=t} exp(cum_t - cum_j) (C_t . B_j) dt_j x_j
    as causal matmuls within chunks and a loop across them."""
    b, t, h, hd = xh.shape
    n = bm.shape[-1]
    nc = t // chunk
    xt = (xh * dt_h[..., None]).reshape(b, nc, chunk, h, hd).float()
    logd = (dt_h * a_h).reshape(b, nc, chunk, h).float()
    cum = torch.cumsum(logd, 2)                       # (B,NC,C,H)
    total = cum[:, :, -1]                             # (B,NC,H)
    bmc = bm.reshape(b, nc, chunk, n).float()
    cmc = cm.reshape(b, nc, chunk, n).float()

    # intra-chunk: att[b,k,t,j,h] = exp(cum_t - cum_j)(C_t . B_j), j<=t
    cb = torch.einsum("bktn,bkjn->bktj", cmc, bmc)    # (B,NC,C,C)
    dec = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device) \
        .tril()
    att = torch.where(tri[:, :, None], cb[..., None] * dec, 0.0)
    intra = torch.einsum("bktjh,bkjhd->bkthd", att, xt)

    # inter-chunk: carry state (B,H,hd,N) across chunks
    kdec = torch.exp(total[:, :, None] - cum)         # decay to chunk end
    kv = torch.einsum("bkjh,bkjhd,bkjn->bkhdn", kdec, xt, bmc)
    s = torch.zeros((b, h, hd, n), dtype=torch.float32, device=xh.device)
    states = []                                       # entering chunk k
    for i in range(nc):
        states.append(s)
        s = s * torch.exp(total[:, i])[..., None, None] + kv[:, i]
    states = torch.stack(states, 1)
    rdec = torch.exp(cum)                             # decay from start
    inter = torch.einsum("bkth,bkhdn,bktn->bkthd", rdec, states, cmc)
    return (intra + inter).reshape(b, t, h, hd)


def _ssd_naive(xh, dt_h, a_h, bm, cm):
    """Per-token oracle for the chunked SSD (tests)."""
    b, t, h, hd = xh.shape
    xh, dt_h, bm, cm = (x.float() for x in (xh, dt_h, bm, cm))
    s = torch.zeros((b, h, hd, bm.shape[-1]), dtype=torch.float32,
                    device=xh.device)
    ys = []
    for i in range(t):
        a_t = torch.exp(dt_h[:, i] * a_h)             # (B,H)
        upd = torch.einsum("bhd,bn->bhdn", xh[:, i] * dt_h[:, i, :, None],
                           bm[:, i])
        s = s * a_t[..., None, None] + upd
        ys.append(torch.einsum("bhdn,bn->bhd", s, cm[:, i]))
    return torch.stack(ys, 1)


def ssd_enabled() -> bool:
    return bool(os.environ.get("REPRO_MAMBA2"))


def _mamba_ssd_train(p, xc, z, cfg):
    """Mamba-2-style path over the Mamba-1 parameters: the per-channel
    decay collapses to a per-head scalar (the mean of -exp(a_log) over
    the head's channels and state dim) so the recurrence factors into
    chunks."""
    b, s, di = xc.shape
    h = max(di // SSD_HEAD_DIM, 1)
    hd = di // h
    dt, bm, cm = _ssm_params(p, xc.to(cfg.compute_dtype))
    a_h = -torch.exp(p.a_log).reshape(h, hd, -1).mean((1, 2))    # (H,)
    dt_h = dt.reshape(b, s, h, hd).mean(-1)                       # (B,S,H)
    xh = xc.reshape(b, s, h, hd)
    chunk = 128 if s % 128 == 0 and s >= 256 else max(s // 2, 1)
    if s % chunk:
        chunk = s
    y = _ssd_chunked(xh, dt_h, a_h, bm, cm, chunk=chunk).reshape(b, s, di)
    y = y + xc * p.d_skip.float()
    y = y * F.silu(z.float())
    return dense(y.to(cfg.compute_dtype), p.out_proj), None


def mamba_apply(p, x, cfg, mode: str = "train", state=None):
    """x: (B,S,D).  mode 'train' scans S (prefill); 'decode' takes one
    position against `state` = {"conv": (B, D_CONV-1, di), "ssm": (B,
    di, D_STATE)}.  Returns (y, new state; None in train mode)."""
    b, s, d = x.shape
    xi, z = dense(x, p.in_proj).chunk(2, -1)
    xi = constrain(xi, "data", None, "model", role="mamba_inner")

    if mode == "decode":
        conv_win = torch.cat([state["conv"], xi], 1)
        xc = torch.einsum("bkd,kd->bd", conv_win.float(), p.conv_w.float())
        xc = F.silu(xc + p.conv_b.float())[:, None]
        dt, bm, cm = _ssm_params(p, xc.to(x.dtype))
        a = -torch.exp(p.a_log)                              # (di, N)
        da = torch.exp(dt[:, 0, :, None] * a)                # (B,di,N)
        dbx = dt[:, 0, :, None] * bm[:, 0, None, :] * xc[:, 0, :, None]
        new_ssm = state["ssm"] * da + dbx
        y = torch.einsum("bdn,bn->bd", new_ssm, cm[:, 0])
        y = y + xc[:, 0] * p.d_skip.float()
        y = y[:, None] * F.silu(z.float())
        return dense(y.to(x.dtype), p.out_proj), \
            {"conv": conv_win[:, 1:], "ssm": new_ssm}

    # prefill: causal depthwise conv then selective scan
    xpad = F.pad(xi, (0, 0, D_CONV - 1, 0))
    xc = sum(xpad[:, i:i + s].float() * p.conv_w[i].float()
             for i in range(D_CONV))
    xc = F.silu(xc + p.conv_b.float())
    if ssd_enabled():
        return _mamba_ssd_train(p, xc, z, cfg)
    dt, bm, cm = _ssm_params(p, xc.to(x.dtype))
    a = -torch.exp(p.a_log)                                  # (di,N)
    # the streams in bf16, each step's (B,di,N) rebuilt from its slices
    dt16, bm16, cm16, xc16 = (t.to(torch.bfloat16) for t in (dt, bm, cm, xc))
    # zeros (B,di,N) that carry a gradient where `a` does, so that the
    # first step is like the others (a cost walk that collapses the scan
    # counts one step S times)
    hstate = (a * 0).expand(b, -1, -1)
    ys = []
    for t in steps(s, "mamba_scan"):
        dtf = dt16[:, t].float()
        da_t = torch.exp(dtf[..., None] * a)                 # (B,di,N)
        dbx_t = (dtf * xc16[:, t].float())[..., None] \
            * bm16[:, t].float()[:, None, :]
        hstate = hstate * da_t + dbx_t
        ys.append(torch.einsum("bdn,bn->bd", hstate,
                               cm16[:, t].float()).to(torch.bfloat16))
    # (B,S,di); under a cost walk that collapses the scan, (B,1,di)
    # stands for it in shape (broadcast below)
    y = torch.stack(ys, 1).float()
    y = y + xc * p.d_skip.float()
    y = y * F.silu(z.float())
    return dense(y.to(x.dtype), p.out_proj), None
