"""Public serving surface of the port: ``__all__`` is the reference's."""
from repro_torch.distributed.replication import ReplicationConfig
from repro_torch.serving.cf_server import (CFServer, OnboardResult,
                                           ServerStats, LEVEL_DEGRADED,
                                           LEVEL_SHED, LEVEL_TRADITIONAL,
                                           LEVEL_TWINSEARCH)
from repro_torch.serving.config import (LadderConfig, RotationConfig,
                                        ServerConfig, SnapshotConfig,
                                        WalConfig)
from repro_torch.serving.dedup import (DedupPlan, dedup_batch, dedup_rows,
                                       fan_out, prompt_hash)
from repro_torch.serving.guard import (Quarantine, Rejection, RetryPolicy,
                                       call_with_retry)
from repro_torch.serving.lm_server import LMServer
from repro_torch.serving.wal import WalRecord, WriteAheadLog

__all__ = [
    "CFServer", "OnboardResult", "ServerStats",
    "ServerConfig", "SnapshotConfig", "WalConfig", "RotationConfig",
    "LadderConfig", "ReplicationConfig",
    "LEVEL_TWINSEARCH", "LEVEL_TRADITIONAL", "LEVEL_DEGRADED", "LEVEL_SHED",
    "Quarantine", "Rejection", "RetryPolicy", "call_with_retry",
    "WalRecord", "WriteAheadLog",
    "DedupPlan", "dedup_batch", "dedup_rows", "fan_out", "prompt_hash",
    "LMServer",
]
