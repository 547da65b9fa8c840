"""Consolidated configuration surface for ``CFServer``.

``CFServer.__init__`` grew one keyword at a time across the resilience,
durability, and replication PRs — nineteen flat knobs whose grouping
(snapshotting vs WAL vs rotation vs the degradation ladder) lived only in
the docstring.  ``ServerConfig`` makes the grouping structural: four
frozen sub-configs plus the core arena knobs, constructible from the old
flat kwargs (``ServerConfig.from_kwargs``) and flattenable back
(``to_kwargs``) so the legacy shim round-trips losslessly.

All dataclasses are frozen: a server's configuration is immutable for its
lifetime; derive variants with ``dataclasses.replace``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any

from repro_torch.serving.guard import RetryPolicy


@dataclass(frozen=True)
class SnapshotConfig:
    """Snapshot / rollback cadence (legacy ``snapshot_*`` / ``check_every``)."""
    every: int = 64          # healthy onboards between snapshots
    dir: str | None = None   # durable checkpoints when set (else in-mem only)
    keep: int = 3            # durable checkpoints retained
    check_every: int = 8     # onboards between arena_healthy sweeps


@dataclass(frozen=True)
class WalConfig:
    """Write-ahead log (legacy ``wal_dir`` / ``wal_fsync``) + this PR's
    group-commit and batched-replay knobs."""
    dir: str | None = None   # WAL enabled when set
    fsync: bool = True       # fsync each commit (power-loss durability)
    group_commit: bool = True   # coalesce batch appends into one fsync
    replay_batch: int = 16   # records per jitted replay chunk (1 = serial)


@dataclass(frozen=True)
class RotationConfig:
    """Arena rotation (legacy ``rotate_headroom``) + incremental rotation.

    ``budget_rows == 0`` (default) keeps the classic synchronous rotation:
    the triggering onboard pays the whole compaction.  ``budget_rows > 0``
    switches to the chunked plan: rotation starts when free write slots
    drop to ``reserve_slots`` and each onboard/tick merges at most
    ``budget_rows`` base rows, with the atomic swap deferred until the
    plan completes (or the buffer truly fills, which force-drains)."""
    headroom: float = 1.0
    budget_rows: int = 0
    reserve_slots: int | None = None   # None -> max(1, k_cap // 4)


@dataclass(frozen=True)
class LadderConfig:
    """Degradation ladder + retry (legacy ``retry`` / ``monitor`` /
    ``recover_after`` / ``shed_cooldown_s``)."""
    recover_after: int = 32
    shed_cooldown_s: float = 1.0
    drain_on_shed: bool = True   # shed backpressure time drains rotation
    retry: RetryPolicy | None = None
    monitor: Any = None          # StragglerMonitor (duck-typed, mutable)


@dataclass(frozen=True)
class ServerConfig:
    """Everything ``CFServer`` is told at construction, grouped."""
    capacity_extra: int = 64
    c_probes: int = 8
    sim_tol: float = 1e-6
    measure: str = "cosine"
    seed: int = 0
    rating_range: tuple[float, float] = (1.0, 5.0)
    quarantine_capacity: int = 256
    latency_window: int = 1024
    replication: Any = None      # distributed.replication.ReplicationConfig
    snapshot: SnapshotConfig = field(default_factory=SnapshotConfig)
    wal: WalConfig = field(default_factory=WalConfig)
    rotation: RotationConfig = field(default_factory=RotationConfig)
    ladder: LadderConfig = field(default_factory=LadderConfig)

    # -- legacy flat-kwarg bridge ------------------------------------------

    @classmethod
    def from_kwargs(cls, **kw: Any) -> "ServerConfig":
        """Build a config from ``CFServer``'s historical flat kwargs.

        Unknown keys raise ``TypeError`` (same contract as the old
        signature).  Emitting the ``DeprecationWarning`` is the caller's
        job — this classmethod is also the documented migration helper."""
        cfg = cls()
        snap: dict[str, Any] = {}
        wal: dict[str, Any] = {}
        rot: dict[str, Any] = {}
        lad: dict[str, Any] = {}
        top: dict[str, Any] = {}
        for key, val in kw.items():
            if key in _TOP_KEYS:
                top[key] = val
            elif key in _LEGACY_MAP:
                group, name = _LEGACY_MAP[key]
                {"snapshot": snap, "wal": wal,
                 "rotation": rot, "ladder": lad}[group][name] = val
            else:
                raise TypeError(
                    f"CFServer got an unexpected keyword argument {key!r}")
        return replace(
            cfg, **top,
            snapshot=replace(cfg.snapshot, **snap),
            wal=replace(cfg.wal, **wal),
            rotation=replace(cfg.rotation, **rot),
            ladder=replace(cfg.ladder, **lad))

    def to_kwargs(self) -> dict[str, Any]:
        """Flatten back to the historical kwargs (inverse of
        ``from_kwargs`` for every key; defaults are included)."""
        out: dict[str, Any] = {k: getattr(self, k) for k in _TOP_KEYS}
        groups = {"snapshot": self.snapshot, "wal": self.wal,
                  "rotation": self.rotation, "ladder": self.ladder}
        for legacy, (group, name) in _LEGACY_MAP.items():
            out[legacy] = getattr(groups[group], name)
        return out


_TOP_KEYS = tuple(
    f.name for f in fields(ServerConfig)
    if f.name not in ("snapshot", "wal", "rotation", "ladder"))

# legacy kwarg -> (sub-config, field)
_LEGACY_MAP = {
    "snapshot_every": ("snapshot", "every"),
    "snapshot_dir": ("snapshot", "dir"),
    "snapshot_keep": ("snapshot", "keep"),
    "check_every": ("snapshot", "check_every"),
    "wal_dir": ("wal", "dir"),
    "wal_fsync": ("wal", "fsync"),
    "wal_group_commit": ("wal", "group_commit"),
    "wal_replay_batch": ("wal", "replay_batch"),
    "rotate_headroom": ("rotation", "headroom"),
    "rotation_budget_rows": ("rotation", "budget_rows"),
    "rotation_reserve_slots": ("rotation", "reserve_slots"),
    "retry": ("ladder", "retry"),
    "monitor": ("ladder", "monitor"),
    "recover_after": ("ladder", "recover_after"),
    "shed_cooldown_s": ("ladder", "shed_cooldown_s"),
    "drain_on_shed": ("ladder", "drain_on_shed"),
}
