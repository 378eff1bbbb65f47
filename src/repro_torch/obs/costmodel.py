"""The paper's cost model for the port: multiplications and kernel
launches of a batched division, a Barrett precompute, a reduction and a
modexp ladder, per impl, and the work (limb products, bytes in and out)
of each launch.  A jax-free copy of `repro/obs/costmodel.py` (that
module lazily imports the JAX `core/shinv.py` for `refine_iters`, so
the port keeps its own), with the impl names of `kernels/ops.py`:
cuda_fused (JAX pallas_fused), cuda_batched (pallas_batched),
cuda_pairs (pallas) and blocked.  A launch is one kernel of this
package; the blocked impl launches none.  Every count defaults to
cuda_fused.

The work counts come in two forms from one set of functions: per
launch from the operands' significant limbs (what a run's data needs:
`chip_smoke.py`'s kernel bounds), and per operation at (m_limbs,
batch, impl) with every operand at its full static window (the dense
work a static cost analysis sees, an upper bound of the data's:
`launch/bigint_dryrun.py`'s roofline, through `obs/roofline.py`)."""

from __future__ import annotations

import math

FUSED_STEP_LAUNCHES = 2        # powdiff launch + update launch
FUSED_CORRECT_LAUNCHES = 1     # divmod finalization
FUSED_BARRETT_LAUNCHES = 1     # Barrett reduction core
PROLOGUE_LAUNCHES = 1          # a division's or precompute's set-up
MUL_LAUNCHES = 1               # one batched full product
# Full-width torch ops in the unfused step composition (the JAX
# package's count of its XLA glue ops, `repro/obs/costmodel.py`).
UNFUSED_STEP_GLUE_OPS = 19
# Unfused product launches per Refine iteration (PowDiff and w*x).
UNFUSED_STEP_MUL_LAUNCHES = 2
KERNEL_PRODUCTS = ("cuda_pairs", "cuda_batched", "cuda_fused")
# the product kernel each unfused kernel impl launches
PRODUCT_KERNEL = {"cuda_batched": "mul_batch", "cuda_pairs": "mul_pairs",
                  "cuda_fused": "mul_batch"}

# Working widths (the algorithm's, `core/shinv.py` and
# `core/modarith.py` import them): a division runs at W = M + PAD limbs,
# a Barrett reduction at h = 2m + MU_GUARD and W = h + PAD.
PAD = 8
MU_GUARD = 2

# ---------------------------------------------------------------------------
# the paper's multiplication counts (Sec 2.3)
# ---------------------------------------------------------------------------

# A full division costs at least 5 and at most 7 full multiplications
# (result wider than M/2 digits; the double-width u*shinv product counts
# as two).  The fixed-trip-count Refine occasionally runs one settling
# iteration past convergence, which adds a small tail at 8-9; the
# benchmark gate (benchmarks/costmodel.py) asserts min >= 5 and
# median <= 7.
DIV_FULL_MULTS_MIN = 5
DIV_FULL_MULTS_MAX = 7

# A Barrett reduction against a cached shifted inverse is two truncated
# multiplications (x*mu and q*v); the modexp amortization argument is
# (5..7)/2 per reduction.
BARRETT_MULS = 2


def refine_iters(m_limbs: int) -> int:
    """Static Refine trip count ceil(log2(M)) + 2 for an M-limb
    division (the paper's Algorithm 1 line 19; `repro/core/shinv.py:74`)."""
    return math.ceil(math.log2(max(m_limbs, 2))) + 2


def refine_window(i: int, width: int, windowed: bool = True) -> int:
    """Static operand window (limbs) of Refine iteration i at working
    width `width`: iteration i satisfies l <= 2^i + 1, so its operands
    fit 2^(i+1) + 16 limbs."""
    if not windowed:
        return width
    return min(max(32, 2 ** (i + 1) + 16), width)


def refine_mul_work(m_limbs: int, width: int | None = None,
                    windowed: bool = True) -> float:
    """Predicted Refine multiplication work in full-multiplication
    equivalents (one full mult = width^2 limb products; each iteration
    performs 2 products at its window).  Windowed, the sum is a
    geometric series ~ (4/3 + 4/3) full mults instead of 2 * iters."""
    width = width or m_limbs
    it = refine_iters(m_limbs)
    return sum(2.0 * (refine_window(i, width, windowed) / width) ** 2
               for i in range(it))


def div_width(m_limbs: int) -> int:
    """Working width W of an M-limb division."""
    return m_limbs + PAD


def barrett_width(m_limbs: int) -> int:
    """Working width W of a Barrett reduction at an m-limb modulus."""
    return 2 * m_limbs + MU_GUARD + PAD


def step_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of one Refine iteration under `impl`."""
    if impl == "cuda_fused":
        return FUSED_STEP_LAUNCHES
    return UNFUSED_STEP_MUL_LAUNCHES if impl in KERNEL_PRODUCTS else 0


def step_glue_ops(impl: str = "cuda_fused") -> int:
    """Full-width torch glue ops per Refine iteration under `impl`."""
    return 0 if impl == "cuda_fused" else UNFUSED_STEP_GLUE_OPS


def mul_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched full product under `impl`."""
    return MUL_LAUNCHES if impl in KERNEL_PRODUCTS else 0


def prologue_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of a division's or a precompute's set-up (the pads,
    prec(u), the lift, the special cases and the initial approximation,
    `core/shinv.py:_Inverse`): one `prologue` launch under cuda_fused,
    torch ops under every other impl.  The JAX package has no such
    launch (its set-up is jnp glue), so it is counted apart from
    `divmod_launches` and `precompute_launches`."""
    return PROLOGUE_LAUNCHES if impl == "cuda_fused" else 0


def divmod_launches(m_limbs: int, impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched divmod at M limbs in the Refine
    loop and the finalization: under cuda_fused two per Refine iteration
    plus one finalization; under an unfused kernel impl two products per
    iteration plus the finalization's two (u * shinv, v * q).  The
    set-up adds `prologue_launches(impl)`."""
    it = refine_iters(m_limbs)
    if impl == "cuda_fused":
        return FUSED_STEP_LAUNCHES * it + FUSED_CORRECT_LAUNCHES
    return step_launches(impl) * it + 2 * mul_launches(impl)


def precompute_iters(m_limbs: int) -> int:
    """Refine trip count of the Barrett precompute of an m-limb modulus:
    h = 2m + 2 and h - k <= h - 1 bound the refinement length
    (`repro/core/modarith.py:113-117`)."""
    return math.ceil(math.log2(max(2 * m_limbs + 1, 2))) + 2


def precompute_launches(m_limbs: int, impl: str = "cuda_fused") -> int:
    """Kernel launches of one Barrett precompute's Refine loop (a shinv,
    no finalization): 30/32/34 at m = 2048/4096/8192 under cuda_fused,
    and as many under cuda_batched and cuda_pairs (two products per
    iteration).  The set-up adds `prologue_launches(impl)`."""
    return step_launches(impl) * precompute_iters(m_limbs)


def barrett_launches(impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched Barrett reduction: one fused
    launch, or the two truncated products unfused."""
    if impl == "cuda_fused":
        return FUSED_BARRETT_LAUNCHES
    return 2 * mul_launches(impl)


def modmul_launches(impl: str = "cuda_fused") -> int:
    """One modular multiplication: full product + Barrett reduction."""
    return mul_launches(impl) + barrett_launches(impl)


def modexp_ladder(e_bits: int, window_bits: int = 4) -> dict:
    """Trip counts of the fixed-window modexp ladder
    (`core/modarith.py:modexp`) for an e_bits-bit exponent storage:
    n_windows windows of window_bits squarings + 1 table multiply,
    plus the 2^window_bits-entry table build and the two initial
    reductions (a mod v, 1 mod v).  All counts are static: the ladder
    is data-independent by construction."""
    if e_bits % window_bits:
        raise ValueError("window_bits must divide the exponent width")
    n_win = e_bits // window_bits
    squarings = n_win * window_bits
    table_muls = 1 << window_bits
    window_muls = n_win
    modmuls = squarings + table_muls + window_muls
    return {
        "n_windows": n_win,
        "squarings": squarings,
        "table_muls": table_muls,
        "window_muls": window_muls,
        "modmuls": modmuls,
        "reductions": modmuls + 2,       # + a mod v, 1 mod v
    }


def modexp_launches(e_bits: int, window_bits: int = 4,
                    impl: str = "cuda_fused") -> int:
    """Kernel launches of one batched modexp: 674 for a 256-bit
    exponent at window 4 under cuda_fused."""
    lad = modexp_ladder(e_bits, window_bits)
    return (lad["modmuls"] * modmul_launches(impl)
            + 2 * barrett_launches(impl))


def model_launches(op: str, m_limbs: int, impl: str = "cuda_fused",
                   e_bits: int | None = None,
                   window_bits: int = 4) -> int | None:
    """Kernel launches of one service op on one bucket at m limbs:
    divmod, precompute, reduce, modmul, and modexp when e_bits is given
    (the JAX package returns None for modexp, whose launches sit in scan
    bodies; the port counts them at run time).  None for anything
    else."""
    if op == "divmod":
        return divmod_launches(m_limbs, impl)
    if op == "precompute":
        return precompute_launches(m_limbs, impl)
    if op == "reduce":
        return barrett_launches(impl)
    if op == "modmul":
        return modmul_launches(impl)
    if op == "modexp" and e_bits is not None:
        return modexp_launches(e_bits, window_bits, impl)
    return None


# ---------------------------------------------------------------------------
# work per launch: limb products and bytes in and out
#
# Limbs move as int32 (4 bytes).  Each input is counted read once and
# each output written once, whatever a kernel reads again.  A function
# given per-lane significant limbs counts what those lanes need; given
# none, every operand fills its static window.
# ---------------------------------------------------------------------------

def cut_products(a: int, b: int, n: int) -> int:
    """Limb products i + j < n of an a-limb by a b-limb operand: the sum
    over i < min(a, b) of min(max(a, b), max(0, n - i))."""
    if not (a and b and n > 0):
        return 0
    a, b = min(a, b), max(a, b)
    full = max(0, min(a, n - b + 1))
    lo, hi = max(0, n - b + 1), min(a - 1, n - 1)
    tri = (hi - lo + 1) * n - (lo + hi) * (hi - lo + 1) // 2 \
        if hi >= lo else 0
    return full * b + tri


def mul_work(batch: int, wu: int, wv: int, out_width: int) -> tuple:
    """(products, bytes) of one batched product of (batch, wu) x (batch,
    wv) limbs cut to out_width: `mul_batch`/`mul_pairs` and the unfused
    impls' products."""
    return (batch * cut_products(wu, wv, out_width),
            4 * batch * (wu + wv + out_width))


def powdiff_work(batch: int, full_w: int, win: int,
                 pv=None, pw=None) -> tuple:
    """(products, bytes) of one powdiff launch: prec(vp) * prec(wq) per
    lane (pv, pw: the lanes' significant limbs of vp and wq in the
    window); it reads win limbs of v (from offset s) and of w, writes x
    at full width and moves 4 scalars per lane."""
    if pv is None:
        pv = pw = [win] * batch
    return (sum(a * b for a, b in zip(pv, pw)),
            4 * batch * (2 * win + full_w + 4))


def update_work(batch: int, full_w: int, win: int, pw=None, px=None,
                off=None, active=None) -> tuple:
    """(products, bytes, kept) of one update launch: on each active lane
    the products i + j < n of prec(wq) x prec(x) limbs, n =
    min(prec(wq) + prec(x), max(h - 2m, 0) + win, 2 win) where the
    kernel's product stops (off: h - 2m per lane), and the share of the
    product columns that n keeps.  It reads win limbs of w and x and
    writes full width on an active lane, copies w on an inactive one,
    and reads 4 scalars per lane."""
    if pw is None:
        pw = px = [win] * batch
        off = [win] * batch
        active = [True] * batch
    products = cols = kept = 0
    for a, b, o, on in zip(pw, px, off, active):
        if not (on and a and b):
            continue
        n = min(a + b, max(o, 0) + win, 2 * win)
        products += cut_products(a, b, n)
        cols += a + b
        kept += n
    act = sum(bool(x) for x in active)
    nbytes = 4 * (act * (2 * win + full_w) + (batch - act) * 2 * full_w
                  + 4 * batch)
    return products, nbytes, (kept / cols if cols else None)


def correct_work(batch: int, width: int, lanes=None) -> tuple:
    """(products, bytes) of one correct launch: on each lane with v != 0,
    u * si over prec(u) x prec(si) limbs below column min(2W, h + W),
    then q * v below limb W over prec(q) x prec(v) limbs (lanes:
    (prec(u), prec(si), prec(q), prec(v), h) per such lane).  It reads
    u, v, si and h and writes q and r at W."""
    W = width
    if lanes is None:
        lanes = [(W, W, W, W, W)] * batch
    products = sum(cut_products(pu, ps, min(pu + ps, 2 * W, h + W))
                   + cut_products(pq, pv, min(pq + pv, W))
                   for pu, ps, pq, pv, h in lanes)
    return products, 4 * batch * (5 * W + 1)


def barrett_work(batch: int, m_limbs: int, lanes=None, nmu=None,
                 nv=None) -> tuple:
    """(products, bytes) of one shared-context Barrett launch: x * mu
    over prec(x) x prec(mu) limbs, then q * v truncated to W over
    prec(q) x prec(v) limbs, q = floor(x * mu / B^h) cut to W (lanes:
    (prec(x), prec(q)) per lane).  It reads x at 2m, the shared mu at W
    and v at m once, and writes r at W."""
    W = barrett_width(m_limbs)
    if lanes is None:
        lanes, nmu, nv = [(2 * m_limbs, W)] * batch, W, m_limbs
    products = sum(px * nmu + cut_products(nq, nv, W) for px, nq in lanes)
    return products, 4 * (batch * 2 * m_limbs + W + m_limbs + batch * W)


def divmod_work(m_limbs: int, batch: int, impl: str = "cuda_fused",
                windowed: bool = True) -> list[tuple]:
    """[(kernel, products, bytes)] per launch of one batched M-limb
    divmod's Refine loop and finalization under impl, every operand at
    its full window: per Refine iteration powdiff and update
    (cuda_fused) or the two window products, then the finalization (one
    launch, or u * shinv and q * v).  Empty for blocked.  The set-up's
    `prologue_launches(impl)` launch moves bytes only and is not
    listed."""
    W = div_width(m_limbs)
    out = []
    for i in range(refine_iters(m_limbs)):
        win = refine_window(i, W, windowed)
        out += _step_work(batch, W, win, impl)
    if impl == "cuda_fused":
        out.append(("correct", *correct_work(batch, W)))
    elif impl in KERNEL_PRODUCTS:
        k = PRODUCT_KERNEL[impl]
        out += [(k, *mul_work(batch, W, W, 2 * W)),
                (k, *mul_work(batch, W, W, W))]
    return out


def _step_work(batch: int, W: int, win: int, impl: str) -> list[tuple]:
    if impl == "cuda_fused":
        return [("powdiff", *powdiff_work(batch, W, win)),
                ("update", *update_work(batch, W, win)[:2])]
    if impl in KERNEL_PRODUCTS:
        k = PRODUCT_KERNEL[impl]
        return [(k, *mul_work(batch, win, win, 2 * win))] * 2
    return []


def precompute_work(m_limbs: int, impl: str = "cuda_fused",
                    windowed: bool = True) -> list[tuple]:
    """[(kernel, products, bytes)] per launch of one shared Barrett
    precompute (a shinv of one lane at the Barrett width, no
    finalization)."""
    W = barrett_width(m_limbs)
    out = []
    for i in range(precompute_iters(m_limbs)):
        out += _step_work(1, W, refine_window(i, W, windowed), impl)
    return out


def reduce_work(m_limbs: int, batch: int,
                impl: str = "cuda_fused") -> list[tuple]:
    """[(kernel, products, bytes)] per launch of one shared-context
    reduction of (batch, 2m) limbs: one Barrett launch, or the unfused
    x * mu and q * v at the Barrett width."""
    if impl == "cuda_fused":
        return [("barrett", *barrett_work(batch, m_limbs))]
    if impl not in KERNEL_PRODUCTS:
        return []
    W, k = barrett_width(m_limbs), PRODUCT_KERNEL[impl]
    return [(k, *mul_work(batch, W, W, 2 * W)),
            (k, *mul_work(batch, W, W, W))]


def modmul_work(m_limbs: int, batch: int,
                impl: str = "cuda_fused") -> list[tuple]:
    """[(kernel, products, bytes)] per launch of one shared-context
    modmul: the m x m -> 2m product, then one reduction."""
    if impl not in KERNEL_PRODUCTS:
        return []
    return ([(PRODUCT_KERNEL[impl],
              *mul_work(batch, m_limbs, m_limbs, 2 * m_limbs))]
            + reduce_work(m_limbs, batch, impl))
