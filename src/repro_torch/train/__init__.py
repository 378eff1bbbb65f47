"""Training: `step` (the train, serve and prefill step builders, with
gradient accumulation over microbatches) and `trainer` (the
fault-tolerant loop: checkpoints, restart, straggler watchdog)."""
