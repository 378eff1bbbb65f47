"""Multiplication entry points, the impl registry and the fused
division-step and Barrett dispatch.

Four interchangeable implementations of every product (all exact and
bit-identical, so a caller may swap them freely):

  cuda_fused    the fused division-step and Barrett kernels
                (kernels/fused.py; JAX impl "pallas_fused"); a bare
                product is the batched kernel.  The default.
  cuda_batched  the batched product kernel, one block per instance
                (`bigmul.mul_batch_cuda`; JAX "pallas_batched"), with the
                division-step and Barrett glue in torch.
  cuda_pairs    the pair-product kernel, one block per (instance, output
                column tile) with the carries chained in the launch
                (`bigmul.mul_pairs`; JAX "pallas"), glue in torch.
  blocked       the plain product `mul_plain` (JAX "blocked"): torch ops
                only, no kernel of this package.

JAX's "scan" oracle is not ported.  The unfused impls run the same
compositions as the JAX package's `step_reference` & co. with their
own product.  `fallback_chain` is the serving tier's degradation
ladder: cuda_fused -> cuda_batched -> blocked and cuda_pairs ->
blocked, as in the JAX package; on the card it ends at the last kernel
rung, so no kernel is ever stood in for by the plain versions there.

Device rule: a CPU tensor goes to each kernel's plain version, a CUDA
tensor to the hand-written Hopper kernel, and any other device raises.
There is no fallback from a kernel to its plain version.

`mul_plain` is the plain product.  It is exact on both devices: limbs
are base 2^16, so one limb product is < 2^32 and a column sum of a
product of W-limb operands is < W * (2^16 - 1)^2 < 2^48 for W <= 2^16,
far inside float64's 2^53 exact-integer range.  CUDA has no integer
matrix product, so the per-diagonal sums come from float64
block-Toeplitz products (exact, since every partial sum is an integer
< 2^53); carries are resolved in int64 exactly as the kernels resolve
them (`csrc/digitmma.cuh:cluster_resolve`).
"""

from __future__ import annotations

import torch

from repro_torch.core import arith as A
from repro_torch.core.bigint import DTYPE, LOG_BASE, MASK
from repro_torch.obs import telemetry as T

# Limbs per tile of the plain product (the pair kernel has its own
# column tile, `bigmul.PAIRS_TC`).
BLOCK_T = 128

IMPLS = ("blocked", "cuda_pairs", "cuda_batched", "cuda_fused")
# the JAX package's name of each impl
JAX_IMPLS = {"blocked": "blocked", "cuda_pairs": "pallas",
             "cuda_batched": "pallas_batched",
             "cuda_fused": "pallas_fused"}

DEFAULT_IMPL = "cuda_fused"

_FALLBACK = {"cuda_fused": "cuda_batched",
             "cuda_batched": "blocked",
             "cuda_pairs": "blocked"}


def default_impl() -> str:
    return DEFAULT_IMPL


def check_impl(name: str | None) -> str:
    """The concrete impl for an optional name (None = the default);
    raises ValueError for an unknown one."""
    name = name or DEFAULT_IMPL
    if name not in IMPLS:
        raise ValueError(f"unknown impl {name!r}; expected one of {IMPLS}")
    return name


def fallback_impl(name: str) -> str | None:
    """The next impl down the degradation ladder, or None when `name`
    is terminal ("blocked" runs torch ops only)."""
    return _FALLBACK.get(check_impl(name))


def fallback_chain(name: str, device=None) -> list[str]:
    """`name` followed by every impl below it on the ladder.  For work
    on the card (`device` of type "cuda") the chain stops at the last
    kernel rung: "blocked" runs there only when it is asked for."""
    chain = [check_impl(name)]
    while chain[-1] in _FALLBACK:
        chain.append(_FALLBACK[chain[-1]])
    if device is not None and torch.device(device).type == "cuda":
        chain = chain[:1] + [i for i in chain[1:] if i != "blocked"]
    return chain


def _check_device(*ts: torch.Tensor) -> str:
    dev = ts[0].device.type
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("operands lie on different devices")
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"no implementation for device {dev!r}")
    return dev


def resolve_columns(col: torch.Tensor) -> torch.Tensor:
    """Exact column sums (batch, n) int64, each < 2^48 -> canonical
    base-2^16 limbs (batch, n) int32, mod B^n.

    Each sum is split into three 16-bit pieces added at offsets 0, 1
    and 2 limbs (< 3 * 2^16), one local pass leaves digits <= 2^16 + 1
    with carries in {0, 1}, and one generate/propagate scan finishes."""
    col = col.to(torch.int64)
    e = ((col & MASK) + A.shift((col >> LOG_BASE) & MASK, 1)
         + A.shift(col >> (2 * LOG_BASE), 2))
    f = (e & MASK) + A.shift(e >> LOG_BASE, 1)
    c = A.carry_scan((f >> LOG_BASE).to(DTYPE), (f == MASK).to(DTYPE))
    return ((f + c) & MASK).to(DTYPE)


def pair_sums_plain(u: torch.Tensor, v: torch.Tensor,
                    d_keep: int) -> torch.Tensor:
    """Raw per-diagonal sums of the tiled product, in plain PyTorch: the
    sums of the plain versions of `csrc/pairs.cu` and `csrc/mul.cu`.

    u (batch, Wu), v (batch, Wv) limbs; tile i of u is limbs [i*T,
    (i+1)*T).  Returns (batch, ndiag, 2T) int64 with raw[b, d, s] = sum
    over tile pairs i + j = d of sum_c u_i[c] * v_j[s - c], for the
    diagonals d < min(nu + nv - 1, d_keep)."""
    t = BLOCK_T
    batch = u.shape[0]
    nu = min(max(-(-u.shape[1] // t), 1), d_keep)
    nv = min(max(-(-v.shape[1] // t), 1), d_keep)
    ndiag = min(nu + nv - 1, d_keep)
    f64 = torch.float64
    u, v = u[:, :nu * t].to(f64), v[:, :nv * t].to(f64)
    uf = torch.nn.functional.pad(u, (0, nu * t - u.shape[1]))
    uf = uf.reshape(batch, nu, t)
    vg = torch.nn.functional.pad(v, (t, nv * t - v.shape[1] + t))
    # toep[b, j, c, s] = v[j*t + s - c] for 0 <= s - c < t, else 0
    dev = u.device
    j = torch.arange(nv, device=dev)[:, None, None]
    c = torch.arange(t, device=dev)[None, :, None]
    s = torch.arange(2 * t, device=dev)[None, None, :]
    toep = vg[:, j * t + s - c + t]
    toep = toep * ((s - c >= 0) & (s - c < t)).to(f64)
    raw = torch.zeros(batch, ndiag, 2 * t, dtype=f64, device=dev)
    for i in range(nu):
        nj = min(nv, ndiag - i)                   # pairs with i + j < ndiag
        if nj <= 0:
            break
        raw[:, i:i + nj] += torch.einsum("bc,bjcs->bjs", uf[:, i],
                                         toep[:, :nj])
    return raw.to(torch.int64)


def pair_columns(raw: torch.Tensor, out_width: int) -> torch.Tensor:
    """Per-diagonal sums (batch, ndiag, 2T) -> the product's exact column
    sums (batch, out_width) int64: diagonal d is added at limb offset
    d * T (the overlap-add)."""
    t = BLOCK_T
    batch, ndiag, _ = raw.shape
    col = torch.zeros(batch, (ndiag + 1) * t, dtype=torch.int64,
                      device=raw.device)
    col[:, :ndiag * t] += raw[..., :t].reshape(batch, -1)
    col[:, t:] += raw[..., t:].reshape(batch, -1)
    col = col[:, :out_width]
    if col.shape[1] < out_width:
        col = torch.nn.functional.pad(col, (0, out_width - col.shape[1]))
    return col


def columns_from_pairs(raw: torch.Tensor, out_width: int) -> torch.Tensor:
    """Per-diagonal sums (batch, ndiag, 2T) -> canonical limbs (batch,
    out_width): `pair_columns`, then `resolve_columns`, the resolution
    the digit-GEMM kernels run (`csrc/digitmma.cuh:cluster_resolve`).
    Shared by every plain product."""
    return resolve_columns(pair_columns(raw, out_width))


def tiles_for(width: int) -> int:
    """Diagonals a product truncated to `width` limbs can see: a pair on
    diagonal d writes limbs [d*T, (d+2)*T), and carries only travel up,
    so it matters iff d*T < width."""
    return max(-(-width // BLOCK_T), 1)


def mul_plain(u: torch.Tensor, v: torch.Tensor, out_width: int) -> torch.Tensor:
    """Exact (u * v) mod B^out_width for (batch, Wu) x (batch, Wv) limb
    tensors, on either device, in plain PyTorch."""
    return columns_from_pairs(
        pair_sums_plain(u, v, tiles_for(out_width)), out_width)


def _mul_batched(u: torch.Tensor, v: torch.Tensor,
                 out_width: int) -> torch.Tensor:
    """The batched kernel on CUDA tensors, its plain version on CPU
    ones."""
    if _check_device(u, v) == "cuda":
        from . import bigmul
        return bigmul.mul_batch_cuda(u, v, out_width)
    return mul_plain(u, v, out_width)


def _mul_pairs(u: torch.Tensor, v: torch.Tensor,
               out_width: int) -> torch.Tensor:
    from . import bigmul
    return bigmul.mul_pairs(u, v, out_width)


_PRODUCTS = {"blocked": mul_plain, "cuda_pairs": _mul_pairs,
             "cuda_batched": _mul_batched, "cuda_fused": _mul_batched}


def product(impl: str | None):
    """impl's product as a function (u, v, out_width) -> limbs: what
    `mul_batch` and the unfused compositions of kernels/fused.py
    multiply with (cuda_fused's bare product is the batched kernel)."""
    return _PRODUCTS[check_impl(impl)]


def mul_batch(u: torch.Tensor, v: torch.Tensor, out_width: int,
              impl: str | None = None) -> torch.Tensor:
    """Batched exact product: (batch, Wu) x (batch, Wv) -> (batch,
    out_width) limbs, mod B^out_width, with impl's product."""
    return product(impl)(u, v, out_width)


def mul(u: torch.Tensor, v: torch.Tensor, out_width: int,
        impl: str | None = None) -> torch.Tensor:
    """Exact u * v truncated to out_width limbs for one (W,) instance."""
    return mul_batch(u[None], v[None], out_width, impl)[0]


def mulmod(u: torch.Tensor, v: torch.Tensor, L, out_width: int,
           impl: str | None = None) -> torch.Tensor:
    """(u * v) mod B^L per row, with L an int or a (batch,) tensor."""
    return A.mask_below(mul_batch(u, v, out_width, impl), L)


def _fused(impl, *ts) -> bool:
    """Whether the fused kernel runs: impl cuda_fused on CUDA tensors.
    Every other case runs the plain composition with impl's product."""
    return check_impl(impl) == "cuda_fused" and _check_device(*ts) == "cuda"


def fused_step(v, w, *, h, m, l, s, active, g: int, win: int,
               impl: str | None = None):
    """One guarded Refine iteration on the full-width iterate.

    v, w: (batch, W) limbs; h, m, l, s: (batch,) int32; active:
    (batch,) bool; g the guard digit count, win this iteration's static
    window.  Under cuda_fused two kernel launches on CUDA (powdiff,
    update); otherwise the plain composition with impl's product (two
    product launches under cuda_batched and cuda_pairs)."""
    from . import fused
    with T.scope("fused_step"):
        if _fused(impl, v, w):
            return fused.step_cuda(v, w, h=h, m=m, l=l, s=s, active=active,
                                   g=g, win=win)
        return fused.step_reference(v, w, h=h, m=m, l=l, s=s,
                                    active=active, g=g, win=win,
                                    mul=product(impl))


def fused_correct(u, v, si, *, h, impl: str | None = None):
    """divmod finalization -> (q, r) at width W, with divmod(u, 0) =
    (0, u).  One kernel launch under cuda_fused on CUDA, else the plain
    composition with impl's product (two products)."""
    from . import fused
    with T.scope("fused_correct"):
        if _fused(impl, u, v, si):
            return fused.correct_cuda(u, v, si, h=h)
        return fused.correct_reference(u, v, si, h=h, mul=product(impl))


def fused_barrett(x, mu, v, *, h: int, impl: str | None = None):
    """Barrett reduction core -> r at width W (the caller cuts it to the
    modulus width).  x: (batch, <= W) limbs; mu: (W,) shared or
    (batch, W) per lane; v likewise, at most W limbs; h a static int.
    One kernel launch under cuda_fused on CUDA, else the plain
    composition with impl's product (two products)."""
    from . import fused
    with T.scope("fused_barrett"):
        if _fused(impl, x, mu, v):
            return fused.barrett_cuda(x, mu, v, h=h)
        return fused.barrett_reference(x, mu, v, h=h, mul=product(impl))
