"""Replication over the row-sharded arena, and the row split it keys on.
``__all__`` is the reference's, less the mesh-only names."""
from repro_torch.distributed.replication import (ReplicaState,
                                                 ReplicatedArena,
                                                 ReplicationConfig)
from repro_torch.distributed.sharding import (cf_shardings, gnn_shardings,
                                              lm_shardings, local_state,
                                              recsys_shardings,
                                              shard_row_slice)

__all__ = ["cf_shardings", "gnn_shardings", "lm_shardings",
           "recsys_shardings",
           "ReplicaState", "ReplicatedArena", "ReplicationConfig"]
