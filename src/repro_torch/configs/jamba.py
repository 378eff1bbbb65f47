"""jamba-1.5-large-398b: Mamba+attention 1:7 interleave, 16-expert
top-2 MoE every other layer [arXiv:2403.19887].  Hybrid family: the
long_500k decode cell runs (attention layers are only 1/8 of depth)."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, n_experts=16, moe_top_k=2, moe_d_ff=24576,
    moe_every=2,
    # 8-layer Jamba block: attention at index 3, Mamba elsewhere (1:7)
    layer_pattern=("m", "m", "m", "a", "m", "m", "m", "m"),
    mamba_d_inner=16384, act="swiglu", rope="rope",
    supports_long_context=True,
    seq_parallel=True,
    source="arXiv:2403.19887",
))
