"""Optimizers: `adamw` (AdamW with a global-norm clip, linear warmup
and a configurable state dtype)."""
