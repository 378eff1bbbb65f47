"""The port's Whisper parts (`repro_torch/models/layers.py:cross_attention`
and `encode_kv`, `transformer.py:_encode`, `encode_cross` and decode
against a filled cross cache) against the JAX package's on the CPU, at
the reduced whisper-medium config with its weights carried over by
`params_from_jax`.

JAX's `init_cache` makes the cross cache ck/cv zeros and no JAX function
fills it; here both sides fill it from the JAX encoder's output (per
layer `L.encode_kv(lp["xattn"], T._encode(params, batch, cfg), cfg)`,
stacked into the cache leaves, in bfloat16).  The cache's enc_seq is
cut to 64 (`reduced()` keeps 1,500) so the encoder's frames fill it,
which is what makes decode comparable to prefill.

Tolerances: float32 at rtol = atol = 1e-4; decode logits 1e-3 (the
bfloat16 caches, tests/test_torch_lm_model.py); decode against prefill
at JAX's 2e-2 (tests/test_archs.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
B, S, S_ENC = 2, 12, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def whisper():
    """(JAX config, port config, JAX params, the port's model, a batch
    of tokens and encoder frames), enc_seq 64."""
    jcfg = dataclasses.replace(JC.get_config("whisper-medium").reduced(),
                               enc_seq=S_ENC)
    tcfg = dataclasses.replace(TC.get_config("whisper-medium").reduced(),
                               enc_seq=S_ENC)
    params = JT.init_params(jcfg, jax.random.PRNGKey(5))
    model = T.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(1, jcfg.vocab, (B, S)).astype(np.int32),
             "enc_embeds": rng.normal(size=(B, S_ENC, jcfg.d_model))
             .astype(np.float32)}
    return jcfg, tcfg, params, model, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_encode_matches_jax(whisper):
    """The encoder over 64 frames, and over 40 (fewer frames than
    enc_seq take the first rows of enc_pos_embed)."""
    jcfg, tcfg, params, model, batch = whisper
    enc = jax.jit(lambda p, b: JT._encode(p, b, jcfg))
    for n in (S_ENC, 40):
        part = {"enc_embeds": batch["enc_embeds"][:, :n]}
        got = T._encode(model, _torch_batch(part))
        assert got.shape == (B, n, jcfg.d_model)
        _close(got, enc(params, part))


def test_cross_attention_and_encode_kv_match_jax(whisper):
    jcfg, tcfg, params, model, batch = whisper
    lp = jax.tree.map(lambda a: a[1], params["blocks"]["slot0"])
    rng = np.random.default_rng(6)
    enc_out = rng.normal(size=(B, S_ENC, jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, 3, jcfg.d_model)).astype(np.float32)
    jkv = JL.encode_kv(lp["xattn"], enc_out, jcfg)
    tkv = L.encode_kv(model.blocks[1].xattn, torch.from_numpy(enc_out), tcfg)
    for g, w in zip(tkv, jkv):
        assert g.shape == w.shape == (B, S_ENC, jcfg.n_kv_heads,
                                      jcfg.head_dim)
        _close(g, w)
    want = JL.cross_attention(lp["xattn"], x, jkv, jcfg)
    got = L.cross_attention(model.blocks[1].xattn, torch.from_numpy(x),
                            tkv, tcfg)
    _close(got, want)


def _jax_filled_cache(jcfg, params, batch):
    """JAX's zero cache with ck/cv from the JAX encoder, in bf16."""
    cache = JT.init_cache(jcfg, B, S)
    enc_out = JT._encode(params, batch, jcfg)
    blocks = params["blocks"]["slot0"]
    kvs = [JL.encode_kv(jax.tree.map(lambda a: a[r], blocks)["xattn"],
                        enc_out, jcfg) for r in range(jcfg.n_layers)]
    slot = dict(cache["blocks"]["slot0"])
    slot["ck"] = jnp.stack([k for k, _ in kvs]).astype(jnp.bfloat16)
    slot["cv"] = jnp.stack([v for _, v in kvs]).astype(jnp.bfloat16)
    return {"blocks": {"slot0": slot}}


def test_decode_with_filled_cross_cache_matches_jax(whisper):
    """`encode_cross` fills ck/cv as the JAX encoder does (within one
    bf16 ulp); then 8 decode steps' logits, and every cache leaf after
    them, against JAX decoding over its own filled cache."""
    jcfg, tcfg, params, model, batch = whisper
    jc = _jax_filled_cache(jcfg, params, batch)
    tc = T.encode_cross(model, T.init_cache(tcfg, B, S, device="cpu"),
                        _torch_batch(batch))
    step = jax.jit(lambda p, c, b, i: JT.forward_decode(p, c, b, i, jcfg))
    tok = batch["tokens"][:, 0]
    for i in range(8):
        if i == 0:
            for r, st in enumerate(tc):
                for name in ("ck", "cv"):
                    want = np.asarray(jc["blocks"]["slot0"][name][r],
                                      np.float32)
                    got = st[name].float().numpy()
                    assert st[name].dtype == torch.bfloat16
                    np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                               atol=1e-6)
        lj, jc = step(params, jc, {"token": tok}, jnp.int32(i))
        lt, tc = T.forward_decode(model, tc,
                                  {"token": torch.from_numpy(tok).long()}, i)
        _close(lt, lj, **DECODE_TOL)
        tok = np.asarray(lj)[:, :jcfg.vocab].argmax(-1).astype(np.int32)
        assert np.array_equal(lt[:, :jcfg.vocab].argmax(-1).numpy(), tok)
    for r, st in enumerate(tc):
        for name in ("k", "v"):
            want = np.asarray(jc["blocks"]["slot0"][name][r], np.float32)
            np.testing.assert_allclose(st[name].float().numpy(), want,
                                       rtol=2 ** -7, atol=1e-6)


def test_decode_matches_prefill(whisper):
    """Step-by-step decode of the tokens over the filled cross cache ends
    on the prefill's last-position logits (the prefill encodes the same
    frames), at JAX's tolerance for decode against the parallel
    forward."""
    jcfg, tcfg, params, model, batch = whisper
    tb = _torch_batch(batch)
    full = T.forward_prefill(model, tb)
    _close(full, jax.jit(lambda p, b: JT.forward_prefill(p, b, jcfg))(
        params, batch))
    cache = T.encode_cross(model, T.init_cache(tcfg, B, S, device="cpu"), tb)
    for i in range(S):
        logits, cache = T.forward_decode(model, cache,
                                         {"token": tb["tokens"][:, i]}, i)
    _close(logits, full, rtol=2e-2, atol=2e-2)
