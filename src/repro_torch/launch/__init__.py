"""Launch layouts and entry points: `mesh` (device meshes for the
sharded services and the LM, the production layout as an abstract
mesh), `specs` (the LM's parameter, optimizer, cache and input
layouts), `bigint_dryrun` (one shard of batched division on the
production layout, with its roofline), `dryrun` and `reanalyze` (the
LM's per-device memory, cost and roofline on the production layout),
`serve` (the LM decode demo and the division service from the command
line) and `train` (the fault-tolerant LM trainer from the command
line)."""
