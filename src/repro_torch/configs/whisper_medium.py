"""whisper-medium: encoder-decoder, conv audio frontend (STUB: encoder
consumes precomputed frame embeddings) [arXiv:2212.04356; unverified]."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, act="gelu", rope="none", norm="layernorm",
    enc_seq=1500, embed_stub=True,
    source="arXiv:2212.04356 (unverified)",
))
