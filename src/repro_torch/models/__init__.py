"""The language models of the decoder-only families (`dense`, `moe`):
`layers` (norms, RoPE/M-RoPE, GQA attention, MLPs), `moe` (top-k
capacity dispatch) and `transformer` (the model, its KV cache, prefill
and decode).  The port of `repro/models/`; the `ssm`, `hybrid` and
`encdec` families are not ported yet."""
