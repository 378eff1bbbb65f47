"""The port's LM layers (`repro_torch/models/{layers,moe}.py`) against
the JAX package's (`repro/models/{layers,moe}.py`) on the CPU: the same
numpy inputs and weights from a seed go through the jitted JAX function
and its port.

Tolerance: float32, rtol = atol = 1e-4.  attn_decode's returned bf16
caches are compared bit for bit; the MoE dispatch (expert ids, slots,
keep mask) exactly, drops and ties included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch import configs as TC
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors are small and the test workers
    share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    """(JAX config, port config), reduced, with the same overrides."""
    return (dataclasses.replace(JC.get_config(arch).reduced(), **kw),
            dataclasses.replace(TC.get_config(arch).reduced(), **kw))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _load(module, prefix, tree):
    """Load one JAX layer's parameters (numpy) into the port's module by
    the names params_from_jax uses."""
    sd = {}
    for key, val in tree.items():
        name, transpose = T.jax_name(f"{prefix}.{key}")
        sd[name[len(prefix) + 1:]] = torch.from_numpy(
            np.ascontiguousarray(val.T if transpose else val))
    module.load_state_dict(sd, strict=True)
    return module


def _attn_params(cfg, rng):
    d, hd = cfg.d_model, cfg.head_dim
    p = {"wq": rng.normal(0, d ** -0.5, (d, cfg.n_heads * hd)),
         "wk": rng.normal(0, d ** -0.5, (d, cfg.n_kv_heads * hd)),
         "wv": rng.normal(0, d ** -0.5, (d, cfg.n_kv_heads * hd)),
         "wo": rng.normal(0, d ** -0.5, (cfg.n_heads * hd, d))}
    if cfg.qkv_bias:
        p.update(bq=rng.normal(0, 0.1, cfg.n_heads * hd),
                 bk=rng.normal(0, 0.1, cfg.n_kv_heads * hd),
                 bv=rng.normal(0, 0.1, cfg.n_kv_heads * hd))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _attention(tcfg, tree):
    gen = torch.Generator().manual_seed(0)
    return _load(L.Attention(tcfg, gen), "attn", tree)


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------

def test_norms():
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 8, 128)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, 128).astype(np.float32)
    bias = rng.normal(0.0, 0.2, 128).astype(np.float32)
    rms = L.RMSNorm(128, torch.float32, "cpu")
    rms.scale.copy_(torch.from_numpy(scale))
    ln = L.LayerNorm(128, torch.float32, "cpu")
    ln.scale.copy_(torch.from_numpy(scale))
    ln.bias.copy_(torch.from_numpy(bias))
    want = jax.jit(lambda x, s, b: (JL.rmsnorm({"scale": s}, x),
                                    JL.layernorm({"scale": s, "bias": b}, x))
                   )(x, scale, bias)
    _close(rms(torch.from_numpy(x)), want[0])
    _close(ln(torch.from_numpy(x)), want[1])


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 16)).astype(np.int32)
    want = jax.jit(lambda x, p: JL.apply_rope(x, p, theta))(x, pos)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                       theta)
    _close(got, want)


@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)),
                                         (32, (4, 6, 6)),
                                         (32, (2, 3, 3)),     # slots past
                                         (32, (16, 24, 24))])  # the sum
def test_apply_mrope(hd, sections):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 2, hd)).astype(np.float32)
    pos = rng.integers(0, 512, (3, 2, 8)).astype(np.int32)
    want = jax.jit(lambda x, p: JL.apply_mrope(x, p, sections))(x, pos)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                        sections)
    _close(got, want)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp(act):
    jcfg, tcfg = _cfgs("smollm-135m", act=act)
    rng = np.random.default_rng(3)
    d, f = tcfg.d_model, tcfg.d_ff
    tree = {"wi": rng.normal(0, d ** -0.5, (d, f)),
            "wo": rng.normal(0, f ** -0.5, (f, d))}
    if act == "swiglu":
        tree["wg"] = rng.normal(0, d ** -0.5, (d, f))
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    want = jax.jit(lambda p, x: JL.mlp(p, x, jcfg))(tree, x)
    mod = _load(L.MLP(tcfg, torch.Generator().manual_seed(0)), "mlp", tree)
    _close(mod(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# attention: full, chunked (the chunk halved until it divides S), decode
# ---------------------------------------------------------------------------

ATTN_ARCHS = ["smollm-135m", "qwen2-0.5b", "qwen2-vl-72b"]   # rope, bias,
#                                                               mrope + bias


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_attn_full(arch):
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    tree = _attn_params(tcfg, rng)
    x = rng.normal(size=(2, 16, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want = jax.jit(lambda p, x, q: JL.attn_full(p, x, jcfg, q))(tree, x, pos)
    got = L.attn_full(_attention(tcfg, tree), torch.from_numpy(x), tcfg,
                      torch.from_numpy(pos.copy()).long())
    _close(got, want)


@pytest.mark.parametrize("arch,s,chunk", [("smollm-135m", 48, 32),
                                          ("qwen2-vl-72b", 40, 16),
                                          ("qwen2-0.5b", 96, 64)])
def test_attn_chunked(arch, s, chunk):
    """S not a multiple of the chunk: 32 -> 16, 16 -> 8, 64 -> 32."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(5)
    tree = _attn_params(tcfg, rng)
    x = rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    want = jax.jit(lambda p, x, q: JL.attn_chunked(p, x, jcfg, q, chunk))(
        tree, x, pos)
    mod = _attention(tcfg, tree)
    got = L.attn_chunked(mod, torch.from_numpy(x), tcfg,
                         torch.from_numpy(pos.copy()).long(), chunk)
    _close(got, want)
    # and the chunked core equals the full one
    full = L.attn_full(mod, torch.from_numpy(x), tcfg,
                       torch.from_numpy(pos.copy()).long())
    _close(got, full)


def _bf16_bits(a):
    """numpy (ml_dtypes) or torch bfloat16 -> uint16 bits."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.fixture(scope="module")
def decode_jit():
    return {}


@pytest.mark.parametrize("arch", ATTN_ARCHS)
@pytest.mark.parametrize("pos", [0, 7, 15])
def test_attn_decode(decode_jit, arch, pos):
    """pos 0, mid and S_max - 1 against a cache holding random bf16
    history: the output within tolerance, both caches bit for bit."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(6)
    tree = _attn_params(tcfg, rng)
    b, smax = 2, 16
    x = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
    shape = (b, smax, tcfg.n_kv_heads, tcfg.head_dim)
    ck = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    cv = jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
    if arch not in decode_jit:
        decode_jit[arch] = jax.jit(
            lambda p, x, k, v, i: JL.attn_decode(p, x, jcfg, k, v, i))
    want, wk, wv = decode_jit[arch](tree, x, ck, cv, jnp.int32(pos))
    to_t = lambda a: torch.from_numpy(_bf16_bits(a).copy().view(np.int16)) \
        .view(torch.bfloat16)                                 # noqa: E731
    got, gk, gv = L.attn_decode(_attention(tcfg, tree), torch.from_numpy(x),
                                tcfg, to_t(ck), to_t(cv), pos)
    _close(got, want)
    assert np.array_equal(_bf16_bits(gk), _bf16_bits(wk))
    assert np.array_equal(_bf16_bits(gv), _bf16_bits(wv))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _jax_route(router, x, cfg):
    """The routing lines of repro/models/moe.py:moe_apply (:362-384),
    returning what the JAX function keeps internal."""
    t = x.shape[0] * x.shape[1]
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(int(np.ceil(k * t / e * cfg.capacity_factor)), 4)
    xt = x.reshape(t, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ router, axis=-1)
    gate_vals, expert_ids = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    flat_oh = jax.nn.one_hot(expert_ids, e, dtype=jnp.int32).reshape(t * k,
                                                                     e)
    pos = ((jnp.cumsum(flat_oh, axis=0) * flat_oh).sum(-1) - 1).reshape(t, k)
    keep = pos < cap
    flat_idx = jnp.where(keep.reshape(-1),
                         (expert_ids * cap + pos).reshape(-1), e * cap)
    return probs, gate_vals, expert_ids, flat_idx, keep


def _moe_tree(cfg, rng):
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    ex = {"wi": rng.normal(0, d ** -0.5, (e, d, f)),
          "wo": rng.normal(0, f ** -0.5, (e, f, d))}
    if cfg.act == "swiglu":
        ex["wg"] = rng.normal(0, d ** -0.5, (e, d, f))
    return {"router": rng.normal(0, d ** -0.5, (d, e)).astype(np.float32),
            "experts": {k: v.astype(np.float32) for k, v in ex.items()}}


@pytest.mark.parametrize("case", ["plain", "drops", "ties"])
def test_moe_apply(case):
    """plain: 2 x 8 tokens; drops: 2 x 32 tokens at capacity factor 0.25
    (C = 8 for 128 slots over 4 experts); ties: router columns 1 and 3
    equal to column 0 and column 2 a hair away from it (exact ties go to
    the lower expert id, as lax.top_k breaks them)."""
    cf = 0.25 if case == "drops" else 1.25
    jcfg, tcfg = _cfgs("phi3.5-moe-42b-a6.6b", capacity_factor=cf)
    rng = np.random.default_rng(7)
    tree = _moe_tree(tcfg, rng)
    if case == "ties":
        r = tree["router"]
        r[:, 1] = r[:, 0]
        r[:, 3] = r[:, 0]
        r[:, 2] = r[:, 0] + 1e-4 * rng.normal(size=r.shape[0])
    s = 32 if case == "drops" else 8
    x = rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    out_w, aux_w = jax.jit(lambda p, x: JM.moe_apply(p, x, jcfg))(tree, x)
    probs_w, gates_w, ids_w, slot_w, keep_w = jax.jit(
        lambda r, x: _jax_route(r, x, jcfg))(tree["router"], x)
    mod = _load(M.MoE(tcfg, torch.Generator().manual_seed(0)), "moe",
                {"router": tree["router"], **{
                    f"experts.{k}": v for k, v in tree["experts"].items()}})
    xt = torch.from_numpy(x)
    r = M.route(mod, xt.reshape(-1, tcfg.d_model), tcfg)
    assert np.array_equal(r.experts.numpy(), np.asarray(ids_w))
    assert np.array_equal(r.slot.numpy(), np.asarray(slot_w))
    assert np.array_equal(r.keep.numpy(), np.asarray(keep_w))
    _close(r.probs, probs_w)
    _close(r.gates, gates_w)
    out, aux = mod(xt)
    _close(out, out_w)
    _close(aux, aux_w)
    dropped = int((~mod.routing.keep).sum())
    assert dropped == int((~np.asarray(keep_w)).sum())
    if case == "drops":
        assert dropped > 0
    if case == "ties":
        p = r.probs.numpy()
        assert np.array_equal(p[:, 0], p[:, 1])    # the ties are exact
        top = r.experts.numpy()      # 0, 1 and 3 tie; 2 may pass them
        assert (top != 3).all()
        assert ((top[:, 0] == 0) & (top[:, 1] == 1)).any()
