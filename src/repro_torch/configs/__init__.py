"""Architecture config registry: ``get_config(name)`` / ``--arch <id>``.

The port of `repro/configs/`: one module per architecture (exact
published configs), the same ten as the JAX registry, with the same
fields, `reduced()`, `n_params()` and `n_active_params()`.  Every config
has ``.reduced()`` producing a small same-family variant for CPU smoke
tests.  `param_dtype` and `compute_dtype` are `torch.dtype`s.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"            # swiglu | gelu | relu2
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- MoE
    n_experts: int = 0
    moe_top_k: int = 2
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    moe_every: int = 1             # apply MoE on layers where i % moe_every
    # --- hybrid (jamba): repeating layer pattern
    layer_pattern: tuple = ()      # e.g. ("m","m","m","a","m","m","m","m")
    mamba_d_inner: Optional[int] = None
    # --- encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- modality stub: inputs are precomputed embeddings
    embed_stub: bool = False
    # --- compute policy
    dtype: str = "bfloat16"
    param_dtype_str: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = False
    attn_chunk: int = 1024
    # Megatron-style sequence parallelism at block boundaries: the
    # residual stream saved by the layer scan for backward is stored
    # sharded on ("model") along the sequence dim; compute gathers it
    # per layer.  Cuts the dominant activation-memory term ~x16 for the
    # widest models at the cost of per-layer all-gathers.
    seq_parallel: bool = False
    # --- notes for DESIGN.md / dry-run policy
    supports_long_context: bool = False   # sub-quadratic family?
    source: str = ""

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype_str)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=min(self.d_model, 128) // min(self.n_heads, 4),
            d_ff=min(self.d_ff, 256),
            moe_d_ff=min(self.moe_d_ff, 256) if self.n_experts else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            mamba_d_inner=min(self.mamba_d_inner or 256, 256)
            if self.family in ("hybrid",) else self.mamba_d_inner,
            # keep the family character (mamba + attn + MoE) in one
            # 2-layer repeat unit
            layer_pattern=("m", "a") if self.layer_pattern else (),
            dtype="float32",
            param_dtype_str="float32",
            remat=False,
        )

    def n_params(self) -> int:
        """Analytic parameter count (used for 6*N*D roofline term)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        if self.act == "swiglu":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        moe_ffn = 0
        if self.n_experts:
            per = (3 if self.act == "swiglu" else 2) * d * self.moe_d_ff
            moe_ffn = self.n_experts * per + d * self.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid" and self.layer_pattern:
            di = self.mamba_d_inner or 2 * d
            mamba = d * 2 * di + di * (max(d // 16, 1) + 2 * 16) \
                + max(d // 16, 1) * di + di * d + 4 * di
            n_m = sum(1 for c in self.layer_pattern if c == "m")
            n_a = sum(1 for c in self.layer_pattern if c == "a")
            reps = L // len(self.layer_pattern)
            n_moe = L // max(self.moe_every, 1)
            blocks = reps * (n_m * mamba + n_a * attn)
            blocks += n_moe * moe_ffn + (L - n_moe) * ffn
            return blocks + emb
        if self.family == "ssm":
            # rwkv: timemix ~ 5 d^2 + channelmix 2*d*f (+ lora extras)
            tm = 5 * d * d + d * 32 * 5 + 5 * 32 * d + d * 64 + 64 * d
            cm = 2 * d * f + d * d
            return L * (tm + cm) + emb
        per_layer = attn + (moe_ffn if self.n_experts else ffn)
        if self.n_experts and self.dense_residual:
            per_layer += ffn
        total = L * per_layer + emb
        if self.n_enc_layers:
            total += self.n_enc_layers * (attn + ffn) + attn * L  # cross
        return total

    def n_active_params(self) -> int:
        """Active-per-token params (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.n_params()
        full = self.n_params()
        per = (3 if self.act == "swiglu" else 2) * self.d_model \
            * self.moe_d_ff
        n_moe_layers = self.n_layers // max(self.moe_every, 1)
        if self.family == "hybrid":
            n_moe_layers = self.n_layers // max(self.moe_every, 1)
        inactive = n_moe_layers * (self.n_experts - self.moe_top_k) * per
        return full - inactive


# ---------------------------------------------------------------------------
# input-shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeCell) -> tuple[bool, str]:
    """Whether (arch x shape) is well-defined; reason if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("skipped: pure full-attention architecture; "
                       "524288-token decode needs a sub-quadratic family "
                       "(see DESIGN.md)")
    return True, ""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    from . import (phi35_moe, arctic, qwen2_vl, smollm, qwen2_05b,  # noqa
                   nemotron, starcoder2, rwkv6, whisper_medium, jamba)
    _LOADED = True
