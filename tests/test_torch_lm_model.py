"""The port's LM (`repro_torch/models/transformer.py`) and config
registry (`repro_torch/configs/`) against the JAX package's on the CPU.
For each of the ten architectures, reduced (the seven decoder-only ones,
rwkv6-7b, jamba-1.5-large and whisper-medium), the JAX model's
parameters (`init_params`, seed 0) are carried into the port by
`params_from_jax`, and the same numpy tokens (and, for whisper, encoder
frames) go through both.  Whisper decodes here over JAX's zero cross
cache (tests/test_torch_lm_encdec.py fills it).

Tolerances:
  * float32 prefill logits: rtol = atol = 1e-4;
  * decode logits: rtol = atol = 1e-3 (the KV cache is bfloat16, and a
    1-ulp float32 difference can round one cached element differently);
    greedy tokens equal;
  * the bfloat16 cache leaves: every element within one bf16 ulp of
    JAX's, and at most 1 in 256 elements of a leaf differing.  Bit for
    bit is not reachable across two float32 implementations: the
    float32 K and V agree to ~1e-6 relative, and an element rounds to
    the other bf16 neighbour when its value lies that close to a
    rounding boundary, about 2^8 x 1e-6 of elements (1-3 of 2,048 in
    the reduced layernorm archs).  A wrong cache (dtype, position,
    layer order) differs in far more elements by far more;
  * the float32 and cfg.dtype (float32 here) recurrent state leaves
    (RWKV's wkv, tm_x, cm_x; Mamba's conv, ssm): rtol = atol = 1e-3, as
    the decode logits;
  * decode against prefill at JAX's tolerances: 2e-2, and 3e-2 for Jamba
    in the drop-free MoE regime (tests/test_archs.py,
    tests/test_extras.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.models import transformer as T

DECODER_ONLY = ["smollm-135m", "qwen2-0.5b", "starcoder2-3b",
                "nemotron-4-340b", "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b",
                "arctic-480b"]
# the ssm, hybrid and encdec families
OTHERS = ["rwkv6-7b", "jamba-1.5-large-398b", "whisper-medium"]
ARCHS = DECODER_ONLY + OTHERS
PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
B, S, STEPS = 2, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """arch -> the JAX run (params, inputs, prefill logits, decode
    logits, tokens and final cache), each computed once."""
    return {}


def _jax_run(runs, arch):
    if arch in runs:
        return runs[arch]
    cfg = JC.get_config(arch).reduced()
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.normal(size=(B, 24, cfg.d_model)) \
            .astype(np.float32)
    elif cfg.embed_stub:
        batch = {"embeds": rng.normal(size=(B, S, cfg.d_model))
                 .astype(np.float32)}
    prefill = np.asarray(jax.jit(
        lambda p, b: JT.forward_prefill(p, b, cfg))(params, batch))
    step = jax.jit(lambda p, c, b, i: JT.forward_decode(p, c, b, i, cfg))
    cache = JT.init_cache(cfg, B, S)
    tok, logits, tokens = toks[:, 0], [], []
    for i in range(STEPS):
        lg, cache = step(params, cache, {"token": tok}, jnp.int32(i))
        logits.append(np.asarray(lg))
        tok = np.asarray(lg)[:, :cfg.vocab].argmax(-1).astype(np.int32)
        tokens.append(tok)
    runs[arch] = dict(tree=jax.tree.map(np.asarray, params), batch=batch,
                      prefill=prefill, logits=logits, tokens=tokens,
                      first=toks[:, 0],
                      cache=jax.tree.map(np.asarray, cache))
    return runs[arch]


def _model(arch, tree):
    return T.params_from_jax(TC.get_config(arch).reduced(), tree,
                             device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(runs, arch):
    run = _jax_run(runs, arch)
    batch = {k: torch.from_numpy(v).long() if k == "tokens"
             else torch.from_numpy(v) for k, v in run["batch"].items()}
    got = T.forward_prefill(_model(arch, run["tree"]), batch)
    assert got.shape == run["prefill"].shape
    np.testing.assert_allclose(got.numpy(), run["prefill"], **PREFILL_TOL)


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16).astype(np.int32)
    return np.asarray(a).view(np.uint16).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(runs, arch):
    """8 greedy steps: logits, tokens and every cache leaf (whisper's
    ck/cv the zeros JAX's init_cache gives)."""
    run = _jax_run(runs, arch)
    cfg = TC.get_config(arch).reduced()
    model = _model(arch, run["tree"])
    cache = T.init_cache(cfg, B, S, device="cpu")
    tok = torch.from_numpy(run["first"]).long()
    for i in range(STEPS):
        logits, cache = T.forward_decode(model, cache, {"token": tok}, i)
        np.testing.assert_allclose(logits.numpy(), run["logits"][i],
                                   **DECODE_TOL)
        tok = logits[:, :cfg.vocab].argmax(-1)
        assert np.array_equal(tok.numpy(), run["tokens"][i]), i
    plen = len(T.block_pattern(cfg))
    assert len(cache) == cfg.n_layers
    for layer, st in enumerate(cache):
        r, slot = divmod(layer, plen)
        leaves = run["cache"]["blocks"][f"slot{slot}"]
        assert set(st) == set(leaves), layer
        for name, got in st.items():
            want = leaves[name][r]
            assert got.shape == want.shape, (layer, name)
            assert str(got.dtype) == f"torch.{want.dtype}", (layer, name)
            if got.dtype != torch.bfloat16:
                np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL)
                continue
            diff = np.abs(_bits(got) - _bits(want))
            assert diff.max() <= 1, (layer, name)
            assert (diff != 0).sum() * 256 <= diff.size, (layer, name)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "starcoder2-3b",
                                  "arctic-480b", *OTHERS])
def test_params_from_jax_every_leaf(runs, arch):
    """Every leaf of every repeat lands in the port's parameter of that
    name (transposed for nn.Linear), and the port has no other."""
    tree = _jax_run(runs, arch)["tree"]
    cfg = TC.get_config(arch).reduced()
    sd = _model(arch, tree).state_dict()
    plen = len(T.block_pattern(cfg))
    seen = set()

    def check(name, want):
        seen.add(name)
        assert np.array_equal(sd[name].numpy(), want), name

    check("embed", tree["embed"])
    for top in ("final_ln", "enc_final_ln"):
        for k, v in tree.get(top, {}).items():
            check(f"{top}.{k}", v)
    for top in ("pos_embed", "enc_pos_embed"):
        if top in tree:
            check(top, tree[top])
    assert ("enc_blocks" in tree) == (cfg.family == "encdec")
    for path, leaf in T._flat(tree.get("enc_blocks", {})):
        name, transpose = T.jax_name(path)
        assert leaf.shape[0] == cfg.n_enc_layers
        for i in range(leaf.shape[0]):
            check(f"enc_blocks.{i}.{name}", leaf[i].T if transpose
                  else leaf[i])
    if "lm_head" in tree:
        check("lm_head.weight", tree["lm_head"].T)
    assert ("lm_head" in tree) != cfg.tie_embeddings
    for path, leaf in T._flat(tree["blocks"]):
        slot, rest = path.split(".", 1)
        name, transpose = T.jax_name(rest)
        assert leaf.shape[0] == T.n_repeats(cfg)
        for r in range(leaf.shape[0]):
            layer = r * plen + int(slot[4:])
            check(f"blocks.{layer}.{name}", leaf[r].T if transpose
                  else leaf[r])
    assert seen == set(sd)
    if cfg.n_experts:
        assert sd[f"blocks.{plen - 1}.moe.router"].dtype == torch.float32
    if cfg.family == "hybrid":
        assert sd["blocks.0.mamba.a_log"].dtype == torch.float32


def test_params_from_jax_bfloat16():
    """bf16 leaves (numpy arrays of ml_dtypes' bfloat16) land bit for
    bit, in bf16."""
    kw = dict(dtype="bfloat16", param_dtype_str="bfloat16")
    jcfg = dataclasses.replace(JC.get_config("qwen2-0.5b").reduced(), **kw)
    tcfg = dataclasses.replace(TC.get_config("qwen2-0.5b").reduced(), **kw)
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(1)))
    sd = T.params_from_jax(tcfg, tree, device="cpu").state_dict()
    attn = tree["blocks"]["slot0"]["attn"]
    for name, want in (("embed", tree["embed"]),
                       ("blocks.1.attn.wq.weight", attn["wq"][1].T),
                       ("blocks.1.attn.wq.bias", attn["bq"][1])):
        assert sd[name].dtype == torch.bfloat16
        assert np.array_equal(_bits(sd[name]), _bits(want)), name


@pytest.mark.parametrize("arch", JC.list_archs())
def test_config_registry_matches_jax(arch):
    """Every field, reduced(), n_params() and n_active_params()."""
    assert TC.list_archs() == JC.list_archs()
    for jc, tc in ((JC.get_config(arch), TC.get_config(arch)),
                   (JC.get_config(arch).reduced(),
                    TC.get_config(arch).reduced())):
        names = [f.name for f in dataclasses.fields(jc)]
        assert names == [f.name for f in dataclasses.fields(tc)]
        for name in names:
            assert getattr(tc, name) == getattr(jc, name), name
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert str(tc.param_dtype) == f"torch.{jc.param_dtype}"
        assert str(tc.compute_dtype) == f"torch.{jc.compute_dtype}"
        for shape in JC.SHAPES:
            assert TC.cell_applicable(tc, TC.SHAPES[shape]) == \
                JC.cell_applicable(jc, JC.SHAPES[shape])
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JC.SHAPES.items()}


def test_decode_matches_prefill():
    """The port on its own: step-by-step decode of a prompt ends on the
    prefill's last-token logits (JAX's check,
    tests/test_archs.py:test_decode_matches_forward_attention, at its
    tolerance).  A dense arch: a MoE prefill routes all S tokens at once
    against one capacity, so it may drop what one-token steps keep."""
    cfg = TC.get_config("smollm-135m").reduced()
    model = T.init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (2, 8)))
    full = T.forward_prefill(model, {"tokens": toks})
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    for i in range(8):
        logits, cache = T.forward_decode(model, cache,
                                         {"token": toks[:, i]}, i)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("arch,tol", [("rwkv6-7b", 2e-2),
                                      ("jamba-1.5-large-398b", 3e-2)])
def test_recurrent_decode_matches_prefill(arch, tol):
    """The port on its own, as JAX checks it (tests/test_archs.py:
    test_decode_matches_forward_rwkv, tests/test_extras.py:
    test_jamba_decode_matches_forward): step-by-step decode of a prompt,
    carrying the WKV, conv and SSM states and the token shifts, ends on
    the prefill's last-token logits.  Jamba at capacity factor 16, the
    drop-free regime (a prefill routes all positions against one
    capacity).  rwkv at 128 positions, where the prefill takes the
    chunked WKV form; Jamba at 16 (its prefill scan streams bf16, its
    decode float32)."""
    cfg = TC.get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    s = 128 if cfg.family == "ssm" else 16
    model = T.init_params(cfg, seed=7, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab, (2, s)))
    full = T.forward_prefill(model, {"tokens": toks})
    cache = T.init_cache(cfg, 2, s, device="cpu")
    for i in range(s):
        logits, cache = T.forward_decode(model, cache,
                                         {"token": toks[:, i]}, i)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), rtol=tol,
                               atol=tol)


def test_no_family_refused():
    """Every registered arch builds, reduced, with a decode cache whose
    leaves are those of its mixers (JAX's `_slot_cache`)."""
    for arch in TC.list_archs():
        cfg = TC.get_config(arch).reduced()
        model = T.init_params(cfg, device="cpu")
        cache = T.init_cache(cfg, 1, 4, device="cpu")
        assert len(cache) == len(model.blocks) == cfg.n_layers
        want = {"attn": {"k", "v"}, "mamba": {"conv", "ssm"},
                "rwkv": {"wkv", "tm_x", "cm_x"}}
        for (mixer, _), st in zip(T.layer_slots(cfg), cache):
            extra = {"ck", "cv"} if cfg.family == "encdec" else set()
            assert set(st) == want[mixer] | extra, arch


def test_first_layers_is_the_shallow_model():
    """`first_layers(model, n)` runs as a model of n layers holding the
    same modules: its logits equal those of an n-layer model loaded with
    the first n layers' weights, the original keeps all its layers, and
    a cut inside a repeat unit raises."""
    cfg = dataclasses.replace(TC.get_config("rwkv6-7b").reduced(),
                              n_layers=4)
    model = T.init_params(cfg, seed=3, device="cpu")
    view = T.first_layers(model, 2)
    assert len(model.blocks) == 4 and model.cfg.n_layers == 4
    assert view.cfg.n_layers == 2 and view.blocks[1] is model.blocks[1]
    short = T.init_params(view.cfg, seed=4, device="cpu")
    short.load_state_dict(view.state_dict(), strict=True)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (2, 16)))
    assert torch.equal(T.forward_prefill(view, {"tokens": toks}),
                       T.forward_prefill(short, {"tokens": toks}))
    jamba = T.init_params(TC.get_config("jamba-1.5-large-398b").reduced(),
                          device="cpu")
    with pytest.raises(ValueError):
        T.first_layers(jamba, 1)
