"""r-way replication over the row-sharded CF arena (PyTorch port of
``repro.distributed.replication``).

The serving arena is row-sharded (``shard_row_slice``).  Replication keeps
``r`` byte-identical copies of every row slice, so recovery from a lost
shard is **exact and similarity-free**:

  * **placement** — replica j of shard s lives on node ``(s + j) % n``
    (chained declustering): any single node loss leaves every shard with
    at least one survivor for all ``r >= 2``;
  * **health** — per-replica state (HEALTHY / REBUILDING / DEAD) driven
    by the serving layer's poison rule (live similarity lists finite and
    ascending, finite ratings and norms), swept per replica slice;
  * **failover reads / repair** — a poisoned primary row is re-read from
    the first healthy replica of its shard (``repair``): pure data
    movement, bit-exact, zero similarity recompute;
  * **re-replication** — a lost replica is rebuilt by copying rows from
    a surviving replica of the same shard (never from the primary, which
    may itself be the casualty), under a per-call row budget so it runs as
    background work between requests.

The replica copies are host numpy arrays, as in the reference: they stand
for other nodes, and two copies of a Douban-width arena would not fit on
the card beside the primary.  Only the primary-side work touches the
card, and it moves only the rows it must (the reference copies the whole
arena through the host on every ``bad_rows`` and ``repair``):

  * ``bad_rows`` sweeps the live primary rows on the primary's device
    with the server's own health rule (``verify_rows.ops.live_rows_ok``),
    and copies only the row ids back;
  * ``repair`` checks that every bad row has a surviving replica before it
    writes anything, then writes just those rows back with an index write
    (the port's state is written in place, so a repair that cannot finish
    must not start);
  * ``apply_rows`` copies just the given rows off the card, and ``reset``
    copies each shard's slice off the card once.

No kernel is launched here; the replica-kill tests assert that by making
every similarity-computing callable raise.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from enum import Enum

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_row_slice
from repro_torch.kernels.verify_rows.ops import (HEALTH_CHUNK_ROWS,
                                                live_rows_ok)

log = logging.getLogger(__name__)

# The arena fields a replica mirrors, in checkpoint order.
FIELDS = ("ratings", "norms", "sim_vals", "sim_idx")


class ReplicaState(Enum):
    HEALTHY = "healthy"
    REBUILDING = "rebuilding"
    DEAD = "dead"


@dataclass(frozen=True)
class ReplicationConfig:
    n_shards: int = 4
    r: int = 2                     # replica factor (copies per shard)
    rebuild_rows: int = 0          # rows copied per step_rebuild call; 0 = all

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not 1 <= self.r <= self.n_shards:
            raise ValueError(
                f"replica factor r={self.r} outside [1, {self.n_shards}]")

    def owners(self, shard: int) -> tuple[int, ...]:
        """Nodes holding shard ``shard``, primary first (chained
        declustering)."""
        return tuple((shard + j) % self.n_shards for j in range(self.r))


class _Replica:
    """One (node, shard) copy: per-field row-slice arrays + health."""

    __slots__ = ("node", "shard", "state", "data", "progress")

    def __init__(self, node: int, shard: int):
        self.node = node
        self.shard = shard
        self.state = ReplicaState.HEALTHY
        self.data: dict[str, np.ndarray] = {}
        self.progress = 0              # rows copied so far while REBUILDING


def _row_ok(ratings: np.ndarray, norms: np.ndarray,
            sim_vals: np.ndarray) -> np.ndarray:
    """Per-row arena invariant (the ``verify_rows`` family contract):
    finite ratings and norms, finite ascending similarity lists."""
    fin_r = np.isfinite(ratings).all(axis=1)
    fin_n = np.isfinite(norms) & (norms >= 0)
    fin_s = np.isfinite(sim_vals).all(axis=1)
    asc = (np.diff(sim_vals, axis=1) >= 0).all(axis=1)
    return fin_r & fin_n & fin_s & asc


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that never aliases it (a CPU tensor's
    ``.numpy()`` would share its memory with the live state)."""
    return t.to("cpu", copy=True).numpy()


class ReplicatedArena:
    """r-way replicated mirror of a ``CFState``'s row-sharded fields.

    The primary arena stays the server's ``CFState``; this class owns the
    replica copies, their health, and the recovery data paths.  The
    serving layer keeps replicas in sync by calling ``apply_rows`` after
    each committed mutation and ``reset`` after a geometry change
    (rotation / rollback)."""

    def __init__(self, state, cfg: ReplicationConfig):
        self.cfg = cfg
        self.rebuilt_rows = 0          # re-replication row copies (lifetime)
        self.repaired_rows = 0         # primary rows healed from replicas
        self.dead_marks = 0            # replicas lost (kill + sweep)
        self._replicas: dict[tuple[int, int], _Replica] = {}
        for s in range(cfg.n_shards):
            for node in cfg.owners(s):
                self._replicas[(node, s)] = _Replica(node, s)
        self.reset(state)

    # -- geometry -----------------------------------------------------------

    def reset(self, state) -> None:
        """(Re)build every live replica from ``state`` — full
        re-replication after construction or an arena geometry change.
        Each shard's slice is copied off the primary's device once; its
        other replicas copy that host copy."""
        self.n_rows = int(state.capacity)
        if self.n_rows < self.cfg.n_shards:
            raise ValueError(
                f"arena of {self.n_rows} rows cannot spread over "
                f"{self.cfg.n_shards} shards")
        self.n_active = int(state.n_active)
        self._slices = [shard_row_slice(self.n_rows, self.cfg.n_shards, s)
                        for s in range(self.cfg.n_shards)]
        for s, sl in enumerate(self._slices):
            live = [self._replicas[(node, s)] for node in self.cfg.owners(s)
                    if self._replicas[(node, s)].state
                    is not ReplicaState.DEAD]
            if not live:
                continue
            host = {f: _to_host(getattr(state, f)[sl]) for f in FIELDS}
            for j, rep in enumerate(live):
                rep.data = (host if j == 0
                            else {f: host[f].copy() for f in FIELDS})
                rep.state = ReplicaState.HEALTHY
                rep.progress = 0

    def shard_of(self, row: int) -> int:
        per = max(1, self.n_rows // self.cfg.n_shards)
        return min(row // per, self.cfg.n_shards - 1)

    def _live_for_write(self, rep: _Replica, local_row: int) -> bool:
        if rep.state is ReplicaState.HEALTHY:
            return True
        # A rebuilding replica takes writes only for rows already copied;
        # later rows pick the write up from the (already-written) source.
        return (rep.state is ReplicaState.REBUILDING
                and local_row < rep.progress)

    # -- write path ---------------------------------------------------------

    def apply_rows(self, rows, state) -> None:
        """Mirror the given primary rows (all fields) into every live
        replica — called after each committed onboard/add_rating.  Only
        those rows leave the primary's device."""
        self.n_active = int(state.n_active)
        rows = [int(r) for r in rows]
        if not rows:
            return
        ids = torch.as_tensor(rows, device=state.ratings.device)
        vals = {f: _to_host(getattr(state, f)[ids]) for f in FIELDS}
        for j, row in enumerate(rows):
            s = self.shard_of(row)
            lo = self._slices[s].start
            for node in self.cfg.owners(s):
                rep = self._replicas[(node, s)]
                if self._live_for_write(rep, row - lo):
                    for f in FIELDS:
                        rep.data[f][row - lo] = vals[f][j]

    # -- health -------------------------------------------------------------

    def kill_node(self, node: int) -> list[tuple[int, int]]:
        """Lose a node: every replica it stores is gone."""
        lost = []
        for (n, s), rep in self._replicas.items():
            if n == node and rep.state is not ReplicaState.DEAD:
                rep.state = ReplicaState.DEAD
                rep.data = {}
                rep.progress = 0
                self.dead_marks += 1
                lost.append((n, s))
        if lost:
            log.warning("node %d lost: %d replicas dead", node, len(lost))
        return lost

    def sweep(self) -> list[tuple[int, int]]:
        """Run the invariant sweep over every healthy replica's slice;
        poisoned replicas (bit-flips, partial loss) go DEAD.  Returns the
        newly dead (node, shard) pairs."""
        newly_dead = []
        for (node, s), rep in self._replicas.items():
            if rep.state is not ReplicaState.HEALTHY:
                continue
            sl = self._slices[s]
            live = min(max(self.n_active - sl.start, 0), sl.stop - sl.start)
            if live == 0:
                continue
            ok = _row_ok(rep.data["ratings"][:live],
                         rep.data["norms"][:live],
                         rep.data["sim_vals"][:live])
            if not ok.all():
                rep.state = ReplicaState.DEAD
                rep.data = {}
                self.dead_marks += 1
                newly_dead.append((node, s))
                log.warning("replica (node=%d, shard=%d) failed the "
                            "invariant sweep; marked dead", node, s)
        return newly_dead

    def redundancy(self) -> int:
        """Minimum healthy replica count over all shards."""
        return min(
            sum(self._replicas[(n, s)].state is ReplicaState.HEALTHY
                for n in self.cfg.owners(s))
            for s in range(self.cfg.n_shards))

    def degraded(self) -> bool:
        return self.redundancy() < self.cfg.r

    def replica_states(self) -> dict[tuple[int, int], str]:
        return {k: rep.state.value for k, rep in self._replicas.items()}

    # -- read failover / repair --------------------------------------------

    def _holder(self, row: int) -> tuple[_Replica, int] | None:
        """The first healthy replica of ``row``'s shard (or a rebuilding
        one that already holds the row), with the row's local index."""
        s = self.shard_of(row)
        local = row - self._slices[s].start
        for node in self.cfg.owners(s):
            rep = self._replicas[(node, s)]
            if rep.state is ReplicaState.HEALTHY or (
                    rep.state is ReplicaState.REBUILDING
                    and local < rep.progress):
                return rep, local
        return None

    def read_row(self, field: str, row: int) -> np.ndarray | None:
        """Row ``row`` of ``field`` from the first healthy replica of its
        shard (failover read); None if every replica is down."""
        held = self._holder(row)
        return None if held is None else held[0].data[field][held[1]]

    def bad_rows(self, state) -> np.ndarray:
        """Live primary rows violating the arena invariant
        (``live_rows_ok``, swept on the primary's device)."""
        ok = live_rows_ok(state.sim_vals, state.ratings, state.norms,
                          int(state.n_active))
        return torch.nonzero(~ok).flatten().cpu().numpy().astype(np.int64)

    def repair(self, state):
        """Heal poisoned primary rows from healthy replicas, in place.

        Returns ``(state, repaired_row_ids)``, or ``(None, row_ids)`` when
        some poisoned row has no surviving replica (the caller falls back
        to snapshot rollback); then nothing was written.  Pure data
        movement: only the bad rows cross to the primary's device."""
        rows = self.bad_rows(state)
        if rows.size == 0:
            return state, rows
        by_replica: dict[tuple[int, int], tuple[_Replica, list, list]] = {}
        for row in rows:
            held = self._holder(int(row))
            if held is None:
                log.error("row %d unrecoverable: all replicas of shard %d "
                          "down", row, self.shard_of(int(row)))
                return None, rows
            rep, local = held
            entry = by_replica.setdefault((rep.node, rep.shard),
                                          (rep, [], []))
            entry[1].append(int(row))
            entry[2].append(local)
        dev = state.ratings.device
        for rep, ids, locals_ in by_replica.values():
            for c0 in range(0, len(ids), HEALTH_CHUNK_ROWS):
                idx = torch.as_tensor(ids[c0:c0 + HEALTH_CHUNK_ROWS],
                                      device=dev)
                loc = np.asarray(locals_[c0:c0 + HEALTH_CHUNK_ROWS])
                for f in FIELDS:
                    getattr(state, f)[idx] = torch.from_numpy(
                        rep.data[f][loc]).to(dev)
        self.repaired_rows += int(rows.size)
        return state, rows

    # -- re-replication -----------------------------------------------------

    def step_rebuild(self, budget_rows: int | None = None) -> int:
        """Advance background re-replication by up to ``budget_rows`` row
        copies (None/0 = the config's ``rebuild_rows``; 0 there = finish
        everything).  Copies come from a surviving replica of the same
        shard — never the primary.  Returns rows copied."""
        if budget_rows is None:
            budget_rows = self.cfg.rebuild_rows
        remaining = budget_rows if budget_rows > 0 else None
        copied = 0
        for (node, s), rep in sorted(self._replicas.items()):
            if rep.state is ReplicaState.DEAD:
                src = self._source_for(s, exclude=node)
                if src is None:
                    continue           # no survivor yet; stay dead
                rep.state = ReplicaState.REBUILDING
                rep.progress = 0
                rep.data = {f: np.empty_like(src.data[f]) for f in FIELDS}
            if rep.state is not ReplicaState.REBUILDING:
                continue
            src = self._source_for(s, exclude=node)
            if src is None:
                continue
            n_rows = self._slices[s].stop - self._slices[s].start
            take = n_rows - rep.progress
            if remaining is not None:
                take = min(take, remaining)
            if take > 0:
                lo, hi = rep.progress, rep.progress + take
                for f in FIELDS:
                    rep.data[f][lo:hi] = src.data[f][lo:hi]
                rep.progress += take
                copied += take
                if remaining is not None:
                    remaining -= take
            if rep.progress >= n_rows:
                rep.state = ReplicaState.HEALTHY
                rep.progress = 0
            if remaining == 0:
                break
        self.rebuilt_rows += copied
        return copied

    def _source_for(self, shard: int, exclude: int) -> _Replica | None:
        for node in self.cfg.owners(shard):
            if node == exclude:
                continue
            rep = self._replicas[(node, shard)]
            if rep.state is ReplicaState.HEALTHY:
                return rep
        return None

    def stats(self) -> dict:
        states = list(self._replicas.values())
        return {
            "n_shards": self.cfg.n_shards,
            "r": self.cfg.r,
            "redundancy": self.redundancy(),
            "healthy": sum(r.state is ReplicaState.HEALTHY for r in states),
            "rebuilding": sum(r.state is ReplicaState.REBUILDING
                              for r in states),
            "dead": sum(r.state is ReplicaState.DEAD for r in states),
            "rebuilt_rows": self.rebuilt_rows,
            "repaired_rows": self.repaired_rows,
        }
