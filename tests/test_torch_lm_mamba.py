"""The port's Mamba block (`repro_torch/models/mamba.py`) against the JAX
package's (`repro/models/mamba.py`) on the CPU, at the reduced Jamba
config (d_model 128, d_inner 256): JAX's init (seed-keyed) loaded into
the port's module by the names `params_from_jax` uses, and the same
numpy activations through both.

Tolerances, float32: rtol = atol = 1e-4 for `mamba_apply` in both modes
and at both sequence lengths (S = 512 is JAX's two-level chunked scan,
which the port runs as one loop), and for the SSD forms against JAX;
the chunked SSD form against the per-token oracle at 2e-4, JAX's own
tolerance for it (tests/test_extras.py:test_ssd_chunked_matches_naive).
The prefill scan streams in bfloat16 on both sides, so y's bf16
rounding is part of what is held.
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import mamba as JM
from repro_torch import configs as TC
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


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
def mamba():
    jcfg = JC.get_config("jamba-1.5-large-398b").reduced()
    tcfg = TC.get_config("jamba-1.5-large-398b").reduced()
    tree = jax.tree.map(np.asarray, JM.mamba_init(jax.random.PRNGKey(2),
                                                  jcfg))
    sd = {}
    for key, val in tree.items():
        name, transpose = T.jax_name(f"mamba.{key}")
        sd[name[len("mamba."):]] = torch.from_numpy(
            np.array(val.T if transpose else val))
    mod = M.Mamba(tcfg, torch.Generator().manual_seed(0))
    mod.load_state_dict(sd, strict=True)
    assert mod.a_log.dtype == torch.float32
    return jcfg, tcfg, tree, mod


def _x(s, d, seed):
    return np.random.default_rng(seed).normal(size=(B, s, d)) \
        .astype(np.float32)


@pytest.mark.parametrize("s", [16, 512])
def test_mamba_prefill_matches_jax(mamba, s):
    jcfg, tcfg, tree, mod = mamba
    x = _x(s, jcfg.d_model, s)
    want, _ = jax.jit(lambda p, x: JM.mamba_apply(p, x, jcfg))(tree, x)
    got, st = M.mamba_apply(mod, torch.from_numpy(x), tcfg, mode="train")
    assert st is None
    _close(got, want)


def test_mamba_decode_matches_jax(mamba):
    """Four positions against a carried conv window and SSM state,
    starting from random ones: the outputs and both states."""
    jcfg, tcfg, tree, mod = mamba
    rng = np.random.default_rng(11)
    di = mod.d_skip.shape[0]
    state = {"conv": rng.normal(size=(B, M.D_CONV - 1, di))
             .astype(np.float32),
             "ssm": (rng.normal(size=(B, di, M.D_STATE)) * 0.1)
             .astype(np.float32)}
    step = jax.jit(lambda p, x, s: JM.mamba_apply(p, x, jcfg, mode="decode",
                                                  state=s))
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    for i in range(4):
        x = _x(1, jcfg.d_model, 20 + i)
        want, state = step(tree, x, state)
        got, tstate = M.mamba_apply(mod, torch.from_numpy(x), tcfg,
                                    mode="decode", state=tstate)
        _close(got, want)
        for k in ("conv", "ssm"):
            _close(tstate[k], state[k])
    assert tstate["ssm"].dtype == torch.float32


def test_ssd_chunked_matches_naive_and_jax():
    """JAX's own oracle inputs: (B, T, H, hd, N) = (2, 256, 4, 16, 8),
    chunk 64."""
    rng = np.random.default_rng(0)
    b, t, h, hd, n = 2, 256, 4, 16, 8
    xh = (rng.normal(size=(b, t, h, hd)) * 0.5).astype(np.float32)
    dt_h = np.log1p(np.exp(rng.normal(size=(b, t, h)) - 1.0)) \
        .astype(np.float32)
    a_h = (-np.exp(rng.normal(size=(h,)) * 0.3)).astype(np.float32)
    bm = (rng.normal(size=(b, t, n)) * 0.5).astype(np.float32)
    cm = (rng.normal(size=(b, t, n)) * 0.5).astype(np.float32)
    args = tuple(map(torch.from_numpy, (xh, dt_h, a_h, bm, cm)))
    naive = M._ssd_naive(*args)
    chunked = M._ssd_chunked(*args, chunk=64)
    _close(chunked, naive, rtol=2e-4, atol=2e-4)
    _close(naive, JM._ssd_naive(xh, dt_h, a_h, bm, cm))
    _close(chunked, JM._ssd_chunked(xh, dt_h, a_h, bm, cm, chunk=64))


@pytest.mark.parametrize("s", [16, 256])
def test_mamba_ssd_prefill_matches_jax(mamba, monkeypatch, s):
    """REPRO_MAMBA2 set on both sides (`ssd_enabled` reads it at each
    call): the SSD prefill, chunk s/2 at S = 16 and 128 at S = 256."""
    jcfg, tcfg, tree, mod = mamba
    monkeypatch.setenv("REPRO_MAMBA2", "1")
    assert M.ssd_enabled() and JM.ssd_enabled()
    x = _x(s, jcfg.d_model, 40 + s)
    want, _ = jax.jit(lambda p, x: JM.mamba_apply(p, x, jcfg))(tree, x)
    got, _ = M.mamba_apply(mod, torch.from_numpy(x), tcfg, mode="train")
    _close(got, want)
    monkeypatch.delenv("REPRO_MAMBA2")
    assert not M.ssd_enabled()
    plain, _ = M.mamba_apply(mod, torch.from_numpy(x), tcfg, mode="train")
    assert (plain - got).abs().max() > 1e-5      # the other recurrence


def test_mamba_init_follows_jax():
    """a_log = log(1..16) per channel in float32 whatever param_dtype
    is; dt_bias -4.6, conv_b 0, d_skip 1; conv_w at scale 0.1."""
    import dataclasses
    tcfg = dataclasses.replace(
        TC.get_config("jamba-1.5-large-398b").reduced(),
        param_dtype_str="bfloat16", dtype="bfloat16")
    mod = M.Mamba(tcfg, torch.Generator().manual_seed(1))
    assert mod.a_log.dtype == torch.float32
    assert torch.equal(mod.a_log[5], torch.log(torch.arange(1.0, 17.0)))
    assert mod.in_proj.weight.dtype == torch.bfloat16
    assert torch.equal(mod.dt_bias, torch.full((256,), -4.6,
                                               dtype=torch.bfloat16))
    assert not mod.conv_b.any() and (mod.d_skip == 1).all()
    assert abs(mod.conv_w.float().std().item() / 0.1 - 1) < 0.1
    assert mod.x_proj.weight.shape == (128 // 16 + 2 * M.D_STATE, 256)
