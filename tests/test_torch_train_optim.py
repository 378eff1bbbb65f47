"""The port's AdamW (`repro_torch/optim/adamw.py`), train step
(`repro_torch/train/step.py:make_train_step`) and synthetic stream
(`repro_torch/data/synthetic.py`) against the JAX package's on the CPU.

Tolerances:
  * AdamW on the same gradients, 3 steps (clip active, in warmup):
    float32 parameters and moments rtol 1e-6, atol 1e-7 x max (the
    elementwise update's ops in another order and libm); a bfloat16
    parameter or moment within one bf16 ulp (2^-8 relative) of JAX's,
    where a 1-ulp float32 difference rounds the other way; the step
    equal;
  * the train step, 3 steps at the reduced smollm-135m (lr 3e-3): loss
    rtol 1e-5; the new parameters rtol 1e-4 with an atol in units of the
    learning rate, 0.01 lr with float32 gradients and 0.04 lr with 2
    microbatches accumulated in bfloat16 (STEP_ATOL).  AdamW moves a
    parameter by lr g / (|g| + eps) for a gradient element g below eps
    = 1e-8, so float noise in such a g (the gradients agree within 1e-5
    x max |g|, tests/test_torch_train_model.py) becomes up to lr x
    noise / eps in the parameter: measured 0.53% and 1.9% of lr (1.6e-5
    and 5.6e-5) at most, on 0.1% of the embedding's elements.  A wrong
    update (sign, schedule, decay) moves parameters by ~lr;
  * the stream: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import synthetic as JD
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.train import step as JS
from repro_torch import configs as TC
from repro_torch.data import synthetic as D
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.train import step as TS

BF16_ULP = 2 ** -8
# the train step's parameters after 3 steps, in units of the learning rate
STEP_ATOL = {"float32": 0.01, "bfloat16": 0.04}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, bf16: bool, rtol=1e-6, atol=1e-7):
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    if bf16:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                                   atol=BF16_ULP * 1e-3 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(state_dtype):
    """Three updates on the same gradients: a float32 matrix and vector
    and a bfloat16 matrix (cast back to bf16), the clip active
    (grad_clip below the gradients' norm) and the learning rate in its
    warmup."""
    cfg = dict(lr=1e-2, warmup_steps=10, grad_clip=0.5,
               state_dtype=state_dtype)
    jcfg, tcfg = JA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
    rng = np.random.default_rng(0)
    shapes = {"w": ((32, 16), np.float32), "b": ((16,), np.float32),
              "e": ((8, 24), jnp.bfloat16)}
    jp = {k: jnp.asarray(rng.normal(size=s), dt) for k, (s, dt) in
          shapes.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jp.items()}
    js, ts = JA.init_state(jp, jcfg), A.init_state(tp, tcfg)
    bf16_state = state_dtype == "bfloat16"
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, (s, _) in shapes.items()}
        gnorm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                            for g in grads.values()))
        assert gnorm > jcfg.grad_clip
        jp, js = JA.apply_updates(
            jp, {k: jnp.asarray(g, jp[k].dtype) for k, g in grads.items()},
            js, jcfg)
        tp, ts = A.apply_updates(
            tp, {k: torch.from_numpy(g).to(tp[k].dtype)
                 for k, g in grads.items()}, ts, tcfg)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert ts["step"].dtype == torch.int32
        for k in shapes:
            assert str(tp[k].dtype).endswith(str(jp[k].dtype))
            _close(tp[k], jp[k], bf16=k == "e")
            for mom in ("m", "v"):
                assert ts[mom][k].dtype == getattr(torch, state_dtype)
                _close(ts[mom][k], js[mom][k], bf16=bf16_state)


def _jax_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("microbatches,accum", [(1, "float32"),
                                                (2, "bfloat16")])
def test_train_step_matches_jax(microbatches, accum):
    """Three steps of make_train_step from the same weights on the same
    batches: the loss and every new parameter, and the step count."""
    jcfg = JC.get_config("smollm-135m").reduced()
    tcfg = TC.get_config("smollm-135m").reduced()
    ocfg = dict(lr=3e-3, warmup_steps=2)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = JA.init_state(params, JA.AdamWConfig(**ocfg))
    jstep = jax.jit(JS.make_train_step(
        jcfg, JA.AdamWConfig(**ocfg), microbatches=microbatches,
        grad_accum_dtype=getattr(jnp, accum)))
    model = T.params_from_jax(tcfg, jax.tree.map(np.asarray, params), "cpu")
    topt = A.init_state(dict(model.named_parameters()),
                        A.AdamWConfig(**ocfg))
    tstep = TS.make_train_step(tcfg, A.AdamWConfig(**ocfg),
                               microbatches=microbatches,
                               grad_accum_dtype=getattr(torch, accum))
    atol = STEP_ATOL[accum] * ocfg["lr"]
    for i in range(3):
        batch = _jax_batch(jcfg, 4, 32, seed=i)
        params, jopt, jm = jstep(params, jopt, batch)
        model, topt, tm = tstep(model, topt, {
            k: torch.from_numpy(v).long() for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert set(tm) == {"ce", "aux", "loss"}
        assert int(topt["step"]) == i + 1
    want = T.state_from_jax(tcfg, jax.tree.map(np.asarray, params))
    for name, p in model.named_parameters():
        w = np.asarray(want[name], np.float32)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-4,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("dp_size", [1, 2])
def test_synthetic_stream_equals_jax(dp_size):
    cfg = dict(vocab=500, seq_len=96, global_batch=4, seed=7, doc_len=32)
    for rank in range(dp_size):
        js = JD.SyntheticStream(JD.DataConfig(**cfg), rank, dp_size)
        ts = D.SyntheticStream(D.DataConfig(**cfg), rank, dp_size)
        assert ts.local_batch == js.local_batch == 4 // dp_size
        for step in (0, 1, 7):
            want, got = js.batch(step), ts.batch(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype == np.int32
                assert np.array_equal(got[k], want[k]), (rank, step, k)
