"""Replication over the row-sharded arena, and the row split it keys on."""
from repro_torch.distributed.replication import (ReplicaState,
                                                 ReplicatedArena,
                                                 ReplicationConfig)
from repro_torch.distributed.sharding import shard_row_slice

__all__ = ["ReplicaState", "ReplicatedArena", "ReplicationConfig",
           "shard_row_slice"]
