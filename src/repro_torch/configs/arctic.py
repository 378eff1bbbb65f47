"""arctic-480b: 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from . import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, n_experts=128, moe_top_k=2, moe_d_ff=4864,
    dense_residual=True,       # dense FFN residual in parallel with MoE
    act="swiglu", rope="rope",
    seq_parallel=True,
    source="hf:Snowflake/snowflake-arctic-base",
))
