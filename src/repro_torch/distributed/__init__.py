"""Sharding rules, replication over the row-sharded arena, and the row
split it keys on.  ``__all__`` is the reference's."""
from repro_torch.distributed.replication import (ReplicaState,
                                                 ReplicatedArena,
                                                 ReplicationConfig)
from repro_torch.distributed.sharding import (MeshAxes, cf_shardings,
                                              gnn_shardings, lm_shardings,
                                              local_state, mesh_axes, named,
                                              recsys_shardings,
                                              shard_row_slice, zero_extend)

__all__ = ["MeshAxes", "cf_shardings", "gnn_shardings", "lm_shardings",
           "mesh_axes", "named", "recsys_shardings", "zero_extend",
           "ReplicaState", "ReplicatedArena", "ReplicationConfig"]
