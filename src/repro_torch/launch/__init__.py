"""Launch layouts and the dry run of the paper's workload: `mesh`
(device meshes for the sharded services, the production layout as shard
counts) and `bigint_dryrun` (one shard of batched division on the
production layout, with its roofline)."""
