"""Replication over the row-sharded arena, and the row split it keys on.
``__all__`` is the reference's, less the mesh-only names."""
from repro_torch.distributed.replication import (ReplicaState,
                                                 ReplicatedArena,
                                                 ReplicationConfig)
from repro_torch.distributed.sharding import (cf_shardings, local_state,
                                              shard_row_slice)

__all__ = ["cf_shardings", "ReplicaState", "ReplicatedArena",
           "ReplicationConfig"]
