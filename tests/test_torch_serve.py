"""The port's serving launcher (`repro_torch/launch/serve.py`) on the CPU:
`serve_lm` at the reduced smollm, rwkv6-7b, jamba-1.5-large and
whisper-medium gives JAX's greedy tokens for the same weights (whisper
over the zero cross cache, as JAX's serve loop decodes it),
`serve_bigint` divides exactly, and the module runs from a fresh
interpreter.  Decode logits agree within rtol = atol = 1e-3 (the
bfloat16 KV cache; see tests/test_torch_lm_model.py); the tokens must be
equal."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import transformer as JT
from repro_torch import configs as TC
from repro_torch.launch import serve
from repro_torch.models import transformer as T

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    base = dict(arch="smollm-135m", bigint=False, tokens=8, batch=2,
                limbs=16, device=torch.device("cpu"))
    return argparse.Namespace(**{**base, **kw})


def _to_jax(model, jcfg):
    """The port's parameters as a JAX pytree: params_from_jax inverted
    (the repeat axis stacked again, nn.Linear weights transposed back)."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    template = jax.tree.map(np.asarray,
                            JT.init_params(jcfg, jax.random.PRNGKey(0)))
    plen = len(T.block_pattern(jcfg))

    def stacked(top, layer_of):
        out = {}
        for path, leaf in T._flat(template[top]):
            rest = path.split(".", 1)[1] if top == "blocks" else path
            name, transpose = T.jax_name(rest)
            reps = [sd[f"{top}.{layer_of(path, r)}.{name}"]
                    for r in range(leaf.shape[0])]
            node = out
            keys = path.split(".")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = np.stack([x.T if transpose else x
                                       for x in reps])
        return out

    tree = {"embed": sd["embed"],
            "blocks": stacked("blocks", lambda path, r: r * plen
                              + int(path.split(".")[0][4:]))}
    for top in ("final_ln", "enc_final_ln"):
        if top in template:
            tree[top] = {k[len(top) + 1:]: v for k, v in sd.items()
                         if k.startswith(f"{top}.")}
    for top in ("pos_embed", "enc_pos_embed"):
        if top in template:
            tree[top] = sd[top]
    if "enc_blocks" in template:
        tree["enc_blocks"] = stacked("enc_blocks", lambda path, r: r)
    if "lm_head.weight" in sd:
        tree["lm_head"] = sd["lm_head.weight"].T
    assert jax.tree.structure(tree) == jax.tree.structure(template)
    return tree


def _jax_greedy(args):
    """repro/launch/serve.py's loop over the port's seed-0 weights."""
    jcfg = JC.get_config(args.arch).reduced()
    tcfg = TC.get_config(args.arch).reduced()
    params = _to_jax(T.init_params(tcfg, 0, "cpu"), jcfg)
    cache = JT.init_cache(jcfg, args.batch, args.tokens + 8)
    step = jax.jit(lambda p, c, b, i: JT.forward_decode(p, c, b, i, jcfg))
    tok = jnp.zeros((args.batch,), jnp.int32)
    want = []
    for i in range(args.tokens):
        logits, cache = step(params, cache, {"token": tok}, jnp.int32(i))
        tok = jnp.argmax(logits[:, : jcfg.vocab], -1).astype(jnp.int32)
        want.append(np.asarray(tok).tolist())
    return want


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-1.5-large-398b",
                                  "whisper-medium"])
def test_serve_lm_families_match_jax_greedy(capsys, arch):
    """The ssm, hybrid and encdec families: serve_lm's 8 greedy tokens at
    batch 2 equal JAX's (whisper: no encoder pass, the zero cross cache,
    on both sides)."""
    args = _args(arch=arch)
    got = serve.serve_lm(args)
    assert "decoded 8 tokens x batch 2" in capsys.readouterr().out
    assert got == _jax_greedy(args)


def test_serve_lm_matches_jax_greedy(capsys):
    """serve_lm's tokens (reduced smollm, seed-0 weights, 8 steps at
    batch 2) equal JAX's greedy decode (repro/launch/serve.py's loop) over
    the same weights."""
    args = _args()
    got = serve.serve_lm(args)
    assert "decoded 8 tokens x batch 2" in capsys.readouterr().out
    assert got == _jax_greedy(args)


def test_serve_bigint_exact(capsys):
    serve.serve_bigint(_args(bigint=True, limbs=16, batch=8))
    assert "all exact" in capsys.readouterr().out


def test_serve_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--device", "cpu", "--tokens", "4", "--arch",
                        "phi3.5-moe-42b-a6.6b"],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "decoded 4 tokens x batch 4" in r.stdout


def test_serve_refuses_what_is_not_there(capsys):
    """An arch the registry lacks is a usage error; --device cuda without
    a card stops with a usage error, not a run on the CPU."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "whisper-large", "--device", "cpu"])
    assert exc.value.code == 2
    assert "invalid choice" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit) as exc:
        serve.main(["--tokens", "2"])
    assert exc.value.code == 2
