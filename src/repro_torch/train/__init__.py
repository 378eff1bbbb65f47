"""Training: `step` (the train, serve and prefill step builders, with
gradient accumulation over microbatches), `trainer` (the fault-tolerant
loop: checkpoints, restart, straggler watchdog), `comm` (the
collectives of a `torch.distributed` process group), `ddp_shardmap`
(the explicit-collective DDP step with int8 error-feedback gradient
all-reduce) and `pipeline` (the GPipe forward over stages)."""
