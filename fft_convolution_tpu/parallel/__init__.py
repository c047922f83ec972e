"""Scale-out: vmap channel/IR batching and shard_map device-mesh sharding.

The reference is single-threaded (SURVEY.md §2: parallelism ABSENT); these
modules are the scale-out story — data parallelism over channels/IRs, and
segment-axis model parallelism for very long IRs, over device meshes whose
cards NCCL joins over NVLink."""
