"""The port's training loss (`repro_torch/models/transformer.py:
forward_train`, its chunked cross-entropy, `layers.softmax_cross_entropy`)
and its gradients against the JAX package's on the CPU.  For one arch
of each family, reduced (smollm-135m dense, phi3.5-moe with its aux term
and capacity drops, rwkv6-7b at S = 128 so the chunked WKV form runs,
jamba-1.5-large hybrid, whisper-medium over 100 encoder frames, qwen2-vl
from embeddings with M-RoPE), JAX's parameters (`init_params`, seed 0)
are carried into the port by `params_from_jax` in float32, the same
numpy batch goes through both, and every gradient leaf of the port
(`train/step.py:make_grad_fn`) is held against `jax.grad` of JAX's
`forward_train`, laid out by `transformer.state_from_jax`.

Tolerances:
  * loss, ce and aux: rtol 1e-5;
  * every gradient leaf: rtol 1e-3 with atol 1e-5 x the leaf's max |g|
    (JAX's), elementwise;
  * but Jamba's Mamba leaves that the loss reaches only through JAX's
    bfloat16 scan streams (dt_bias, a_log, x_proj, dt_proj: their
    cotangents are rounded to bf16 on both sides): atol 2^-8 (one bf16
    ulp) x max |g|.  There the port and JAX differ by 0.9e-4..4.4e-4 x
    max |g|, and the port differs from itself by 1.3e-4..1.2e-3 x max
    |g| when the block's input is scaled by 1 + 2^-22
    (`test_bf16_stream_gradients_are_that_sensitive`): a 1-ulp change
    flips bf16 roundings of the streams' cotangents.
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
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.train import step as TS

ARCHS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
         "jamba-1.5-large-398b", "whisper-medium", "qwen2-vl-72b"]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
# Jamba's leaves reached only through the bf16 scan streams
BF16_STREAM_LEAVES = ("mamba.dt_bias", "mamba.a_log", "mamba.x_proj",
                      "mamba.dt_proj")
BF16_STREAM_ATOL = 2 ** -8
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(cfg) -> int:
    return 128 if cfg.family == "ssm" else 64


def _batch(cfg, s, seed=0) -> dict:
    """A numpy batch as tests/test_archs.py builds one: labels, tokens
    or (embed_stub decoder-only) embeddings, whisper's 100 frames."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.embed_stub and cfg.family != "encdec":
        b["embeds"] = rng.normal(size=(B, s, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.normal(size=(B, 100, cfg.d_model)) \
            .astype(np.float32)
    return b


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def _jax_grads(jcfg, params, batch):
    f = jax.jit(jax.value_and_grad(
        lambda p, bb: JT.forward_train(p, bb, jcfg), has_aux=True))
    (loss, metrics), grads = f(params, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def _check_grads(tcfg, got: dict, jax_grads, atol_of=lambda name: GRAD_ATOL):
    """Every port gradient against JAX's; returns the worst max |err| /
    max |g| over the leaves."""
    want = T.state_from_jax(tcfg, jax_grads)
    assert set(want) == set(got)
    worst = 0.0
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        g = g.float().numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=atol_of(name) * scale, err_msg=name)
        if scale:
            worst = max(worst, float(np.abs(g - w).max()) / scale)
    return worst


def _stream_atol(name: str) -> float:
    return BF16_STREAM_ATOL if any(k in name for k in BF16_STREAM_LEAVES) \
        else GRAD_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_jax(arch, capsys):
    jcfg = JC.get_config(arch).reduced()
    tcfg = TC.get_config(arch).reduced()
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg, _seq(jcfg))
    jloss, jmetrics, jgrads = _jax_grads(jcfg, params, batch)
    model = T.params_from_jax(tcfg, jax.tree.map(np.asarray, params), "cpu")
    loss, metrics, grads = TS.make_grad_fn(tcfg)(model, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k],
                                   rtol=LOSS_RTOL)
    if tcfg.n_experts:
        assert float(metrics["aux"]) > 0
    worst = _check_grads(tcfg, grads, jgrads, _stream_atol)
    with capsys.disabled():
        print(f"\n{arch}: loss {float(loss):.6f} (JAX {jloss:.6f}), "
              f"worst grad err / max |g| {worst:.2e}")


def test_bf16_stream_gradients_are_that_sensitive():
    """The noise floor of Jamba's bf16-stream leaves: the port's own
    gradients move by more than GRAD_ATOL x max |g| when the Mamba
    block's input is scaled by 1 + 2^-22, and by less than
    BF16_STREAM_ATOL x max |g|."""
    cfg = TC.get_config("jamba-1.5-large-398b").reduced()
    model = T.init_params(cfg, 0, "cpu")
    batch = _torch_batch(_batch(cfg, 64))
    grad_fn = TS.make_grad_fn(cfg)
    _, _, base = grad_fn(model, batch)
    orig = M.mamba_apply

    def nudged(p, x, cfg, mode="train", state=None):
        return orig(p, x * (1 + 2 ** -22), cfg, mode, state)

    M.mamba_apply = nudged
    try:
        _, _, moved = grad_fn(model, batch)
    finally:
        M.mamba_apply = orig
    rel = {k: float((moved[k] - base[k]).abs().max() / base[k].abs().max())
           for k in base if any(s in k for s in BF16_STREAM_LEAVES)}
    assert max(rel.values()) > GRAD_ATOL, rel
    assert max(rel.values()) < BF16_STREAM_ATOL, rel


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 8, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    want = float(JL.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = float(L.softmax_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("edge", ["several_chunks", "vocab_500"])
def test_chunked_ce_edges_match_jax(edge, monkeypatch):
    """Several CE chunks (CE_CHUNK 16 in both modules: 4 chunks of the
    64 positions), and a vocab that is no multiple of 256 (500: the
    padded tail of 12 columns masked)."""
    jcfg = JC.get_config("smollm-135m").reduced()
    tcfg = TC.get_config("smollm-135m").reduced()
    if edge == "several_chunks":
        monkeypatch.setattr(JT, "CE_CHUNK", 16)
        monkeypatch.setattr(T, "CE_CHUNK", 16)
    else:
        jcfg = dataclasses.replace(jcfg, vocab=500)
        tcfg = dataclasses.replace(tcfg, vocab=500)
        assert T.vocab_padded(tcfg) == 512
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    batch = _batch(jcfg, 64, seed=1)
    if edge == "vocab_500":
        batch["labels"][0, :4] = 499            # the last real column
    jloss, jmetrics, jgrads = _jax_grads(jcfg, params, batch)
    model = T.params_from_jax(tcfg, jax.tree.map(np.asarray, params), "cpu")
    loss, metrics, grads = TS.make_grad_fn(tcfg)(model, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["ce"]), jmetrics["ce"],
                               rtol=LOSS_RTOL)
    _check_grads(tcfg, grads, jgrads)
    if edge == "vocab_500":             # no gradient reaches the tail
        assert not grads["embed"][500:].any()


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-medium"])
def test_remat_gives_the_same_gradients(arch):
    """cfg.remat (each layer, each encoder layer and each CE chunk
    recomputed in the backward pass) changes no loss and no gradient
    bit."""
    cfg = TC.get_config(arch).reduced()
    model = T.init_params(cfg, 0, "cpu")
    batch = _torch_batch(_batch(cfg, 64, seed=2))
    plain = TS.make_grad_fn(cfg)(model, batch)
    remat = TS.make_grad_fn(dataclasses.replace(cfg, remat=True))(model,
                                                                  batch)
    assert torch.equal(plain[0], remat[0])
    for k, g in plain[2].items():
        assert torch.equal(g, remat[2][k]), k


def test_serving_records_no_graph():
    """Parameters are built without gradients, so prefill records no
    autograd graph; the train step turns them on for its model."""
    cfg = TC.get_config("smollm-135m").reduced()
    model = T.init_params(cfg, 0, "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits = T.forward_prefill(model, {"tokens": torch.zeros(
        (1, 8), dtype=torch.long)})
    assert logits.grad_fn is None
    TS.make_grad_fn(cfg)(model, _torch_batch(_batch(cfg, 64)))
    assert all(p.requires_grad for p in model.parameters())
