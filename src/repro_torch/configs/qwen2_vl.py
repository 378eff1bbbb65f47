"""qwen2-vl-72b: M-RoPE, dynamic-resolution ViT frontend (STUB: the
model consumes precomputed patch embeddings) [arXiv:2409.12191]."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    act="swiglu", rope="mrope", mrope_sections=(16, 24, 24),
    qkv_bias=True, embed_stub=True,
    seq_parallel=True,
    source="arXiv:2409.12191",
))
