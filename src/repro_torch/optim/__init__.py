"""Optimizers: `adamw` (AdamW with a global-norm clip, linear warmup,
a configurable state dtype and its ZeRO-1 layout)."""
