"""The port's RWKV-6 blocks (`repro_torch/models/rwkv.py`) against the
JAX package's (`repro/models/rwkv.py`) on the CPU, at the reduced
rwkv6-7b config (d_model 128, 4 heads of 64): JAX's init (seed-keyed)
loaded into the port's modules by the names `params_from_jax` uses, and
the same numpy activations through both.

Tolerances, float32: rtol = atol = 1e-4 for the time mix in every mode
and the channel mix; the chunked WKV form against the scan at 1e-3,
JAX's own tolerance for it (tests/test_archs.py:test_rwkv_chunked_
matches_scan), and against JAX's chunked form at 1e-4.

bfloat16 (the dtype rwkv6-7b serves in), the whole reduced model on
JAX's weights: prefill logits over 128 positions (the chunked form)
within 2^-3 of JAX's bf16 ones and 8 decode steps' within 2^-2 (read:
0.055 and 0.139; logits up to 3.9, whose bf16 ulp is 2^-6, and bf16
puts JAX's own decode logits up to 0.169 from its float32 ones), and the
port's bf16 prefill no further from its float32 prefill than twice
JAX's distance (read: 0.062 in the port, 0.076 in JAX).  A decay
rounded to bf16, a fault of the port's float32 islands, reads 0.31 and
0.29 (`test_bf16_check_catches_a_bf16_decay`).  Two evaluation orders of a
deep random-weight RWKV drift apart: decode against chunked prefill in
float32 at d_model 512, 32 layers, in both, at JAX's 2e-2
(`test_deep_decode_matches_prefill`; run with -s for the readings).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import rwkv as JR
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
# bf16 logits against JAX's bf16, absolute: prefill, decode steps
BF16_TOL = dict(prefill=2 ** -3, decode=2 ** -2)
BF16_DRIFT = 2          # the port's bf16 distance from float32 / JAX's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (JC.get_config("rwkv6-7b").reduced(),
            TC.get_config("rwkv6-7b").reduced())


def _load(module, prefix, tree):
    """One JAX layer's parameters (numpy) into the port's module, by
    `jax_name`; strict."""
    sd = {}
    for key, val in tree.items():
        name, transpose = T.jax_name(f"{prefix}.{key}")
        sd[name[len(prefix) + 1:]] = torch.from_numpy(
            np.array(val.T if transpose else val))
    module.load_state_dict(sd, strict=True)
    return module


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def timemix():
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, JR.timemix_init(jax.random.PRNGKey(3),
                                                    jcfg))
    gen = torch.Generator().manual_seed(0)
    return jcfg, tcfg, tree, _load(R.TimeMix(tcfg, gen), "tm", tree)


@pytest.mark.parametrize("mode,s", [("scan", 16), ("chunked", 128),
                                    ("chunked", 16)])
def test_timemix_prefill_matches_jax(timemix, mode, s):
    """The scan at S = 16, the chunked form at S = 128 (and the dispatch
    to the scan at S = 16 under mode 'chunked'), token shift from
    zeros."""
    jcfg, tcfg, tree, mod = timemix
    x = np.random.default_rng(s).normal(size=(B, s, jcfg.d_model)) \
        .astype(np.float32)
    want, st = jax.jit(lambda p, x: JR.timemix_apply(p, x, None, jcfg,
                                                     mode=mode))(tree, x)
    got, new = R.timemix_apply(mod, torch.from_numpy(x), None, tcfg,
                               mode=mode)
    assert st is None and new is None
    _close(got, want)


def test_timemix_decode_matches_jax(timemix):
    """One position against a carried token and a random float32 WKV
    state: the output and the new state."""
    jcfg, tcfg, tree, mod = timemix
    rng = np.random.default_rng(7)
    h, hd = jcfg.n_heads, jcfg.d_model // jcfg.n_heads
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(B, jcfg.d_model)).astype(np.float32)
    state = (rng.normal(size=(B, h, hd, hd)) * 0.1).astype(np.float32)
    want, wst = jax.jit(lambda p, x, t, s: JR.timemix_apply(
        p, x, t, jcfg, mode="decode", state=s))(tree, x, prev, state)
    got, gst = R.timemix_apply(mod, torch.from_numpy(x),
                               torch.from_numpy(prev), tcfg, mode="decode",
                               state=torch.from_numpy(state))
    assert gst.dtype == torch.float32
    _close(got, want)
    _close(gst, wst)


@pytest.mark.parametrize("carried", [False, True])
def test_channelmix_matches_jax(carried):
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray,
                        JR.channelmix_init(jax.random.PRNGKey(4), jcfg))
    mod = _load(R.ChannelMix(tcfg, torch.Generator().manual_seed(0)), "cm",
                tree)
    rng = np.random.default_rng(8)
    s = 1 if carried else 16
    x = rng.normal(size=(B, s, jcfg.d_model)).astype(np.float32)
    prev = rng.normal(size=(B, jcfg.d_model)).astype(np.float32) \
        if carried else None
    want = jax.jit(lambda p, x, t: JR.channelmix_apply(p, x, t, jcfg))(
        tree, x, prev)
    got = R.channelmix_apply(mod, torch.from_numpy(x),
                             None if prev is None else torch.from_numpy(prev),
                             tcfg)
    _close(got, want)


def test_wkv_chunked_matches_scan_and_jax():
    """JAX's own chunked-vs-scan inputs (decays in (0.45, 0.95)) at
    S = 128, chunk 32 and 64."""
    rng = np.random.default_rng(5)
    b, s, h, hd = 1, 128, 2, 16
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.normal(size=(b, s, h, hd)))) * 0.5 + 0.45) \
        .astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(np.float32)
    tr, tk, tv, tw, tu = map(torch.from_numpy, (r, k, v, w, u))
    scan = R._wkv_scan(tr, tk, tv, tw, tu)
    _close(scan, JR._wkv_scan(r, k, v, w, u))
    for chunk in (32, 64):
        got = R._wkv_chunked(tr, tk, tv, tw, tu, chunk=chunk)
        _close(got, scan, rtol=1e-3, atol=1e-3)
        _close(got, JR._wkv_chunked(r, k, v, w, u, chunk=chunk))


def test_timemix_init_follows_jax():
    """The port's own init draws what JAX's does: mu 0.5, w0 -6, ln_x 1,
    lora_b and wb at scale 0.01, u at 0.1, the dense weights at
    1/sqrt(fan_in); so the decays sit near 1, which keeps the chunked
    form's exp(-cum) finite."""
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, d_model=512, n_heads=8)
    mod = R.TimeMix(tcfg, torch.Generator().manual_seed(1))
    assert torch.equal(mod.mu, torch.full((5, 512), 0.5))
    assert torch.equal(mod.w0, torch.full((512,), -6.0))
    assert torch.equal(mod.ln_x, torch.ones(512))
    for t, scale in ((mod.lora_b, 0.01), (mod.wb, 0.01), (mod.u, 0.1),
                     (mod.wr.weight, 512 ** -0.5), (mod.wa.weight,
                                                    512 ** -0.5)):
        assert abs(t.std().item() / scale - 1) < 0.1
    assert mod.u.shape == (8, 64) and mod.lora_b.shape == (5, R.LORA_R, 512)


def _model_runs(dtype, s, steps, **dims):
    """Reduced rwkv6-7b in `dtype` (and `dims`), JAX's weights (seed 0)
    in both: (JAX, port) each as (prefill logits over s positions, the
    logits of `steps` decode steps from a zero cache over the same
    tokens), float32 numpy over the real vocab."""
    kw = dict(dtype=dtype, param_dtype_str=dtype, **dims)
    jcfg = dataclasses.replace(JC.get_config("rwkv6-7b").reduced(), **kw)
    tcfg = dataclasses.replace(TC.get_config("rwkv6-7b").reduced(), **kw)
    toks = np.random.default_rng(1).integers(1, jcfg.vocab, (B, s)) \
        .astype(np.int32)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    v = jcfg.vocab

    def f32(a):
        return np.asarray(a.float() if isinstance(a, torch.Tensor)
                          else a.astype(np.float32), np.float32)[:, :v]

    jpre = jax.jit(lambda p, b: JT.forward_prefill(p, b, jcfg))(
        params, {"tokens": toks})
    step = jax.jit(lambda p, c, t, i: JT.forward_decode(
        p, c, {"token": t}, i, jcfg))
    cache, jdec = JT.init_cache(jcfg, B, s), []
    for i in range(steps):
        lg, cache = step(params, cache, toks[:, i], np.int32(i))
        jdec.append(f32(lg))
    model = T.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        tpre = T.forward_prefill(model, {"tokens": tt})
        cache, tdec = T.init_cache(tcfg, B, s, device="cpu"), []
        for i in range(steps):
            lg, cache = T.forward_decode(model, cache, {"token": tt[:, i]},
                                         i)
            tdec.append(f32(lg))
    return (f32(jpre), jdec), (f32(tpre), tdec)


def _bf16_distances():
    """The bf16 model against JAX's: prefill (128 positions, the chunked
    form) and 8 decode steps; and each side's bf16 prefill against its
    float32 prefill."""
    (j16, jdec), (t16, tdec) = _model_runs("bfloat16", 128, 8)
    (j32, _), (t32, _) = _model_runs("float32", 128, 0)
    return dict(prefill=np.abs(t16 - j16).max(),
                decode=max(np.abs(t - j).max() for t, j in zip(tdec, jdec)),
                drift_port=np.abs(t16 - t32).max(),
                drift_jax=np.abs(j16 - j32).max())


def test_bf16_model_matches_jax():
    """The port's bf16 RWKV makes JAX's casts: its logits within BF16_TOL
    of JAX's bf16 ones, and bf16 puts them no further from float32's than
    BF16_DRIFT times the distance it puts JAX's."""
    d = _bf16_distances()
    print(f"bf16 rwkv, port against JAX: {d}")
    assert all(d[k] <= tol for k, tol in BF16_TOL.items()), d
    assert d["drift_port"] <= BF16_DRIFT * d["drift_jax"], d


def test_bf16_check_catches_a_bf16_decay(monkeypatch):
    """The bf16 check fails on a fault of the float32 islands: the decay
    w rounded to bf16 before the WKV."""
    proj = R._proj_rkvwg

    def rounded(p, x, x_prev, cfg):
        r, k, v, w, g = proj(p, x, x_prev, cfg)
        return r, k, v, w.to(x.dtype).float(), g

    monkeypatch.setattr(R, "_proj_rkvwg", rounded)
    d = _bf16_distances()
    print(f"bf16 rwkv with a bf16 decay, port against JAX: {d}")
    assert d["prefill"] > BF16_TOL["prefill"], d
    assert d["drift_port"] > BF16_DRIFT * d["drift_jax"], d


def test_deep_decode_matches_prefill():
    """Float32 at d_model 512, 8 heads, 32 layers, JAX's weights in both:
    decode of 128 positions against the chunked prefill, each side within
    JAX's 2e-2; the two sides' prefills against each other too."""
    (jpre, jdec), (tpre, tdec) = _model_runs(
        "float32", 128, 128, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, n_layers=32)
    d = dict(jax=np.abs(jdec[-1] - jpre).max(),
             port=np.abs(tdec[-1] - tpre).max(),
             prefill_port_vs_jax=np.abs(tpre - jpre).max())
    print(f"float32 rwkv, d_model 512, 32 layers, decode vs prefill: {d}")
    assert max(d.values()) <= 2e-2, d
