"""Sharded matching over shard groups (in-process shards or a
torch.distributed process group)."""
