"""Launch layouts and entry points: `mesh` (device meshes for the
sharded services, the production layout as shard counts),
`bigint_dryrun` (one shard of batched division on the production
layout, with its roofline), `serve` (the LM decode demo and the
division service from the command line) and `train` (the fault-tolerant
LM trainer from the command line)."""
