"""Twin-request dedup for serving — the paper's insight transplanted
(beyond-paper, DESIGN.md §4), now backing both the LM and CF read paths.

TwinSearch's structure is probe -> candidate set -> exact verify -> copy.
The serving analogue: requests whose expensive computation is determined
by identical inputs ("twins") share that computation.  Probe = cheap
rolling hash; candidate set = hash-bucket collisions; verify = exact
comparison of the full rows (a hash collision can therefore never cause
wrong sharing); copy = reuse the computed result via ``fan_out``.

Two instantiations ride on the same plan machinery:

  * **LM prompts** (``dedup_batch``): rows are (B, S) token ids; twins
    share prefill compute (KV cache / logits).
  * **CF queries** (``dedup_rows``): rows are arbitrary fixed-width
    byte-comparable vectors — the CF server keys recommendation queries
    on (top-k neighbour sims, neighbour ids, the user's own rating row)
    and prediction queries on (sims, neighbour ids, item).  Users whose
    keys match bit-for-bit provably receive identical scores (the scoring
    kernel is a deterministic function of exactly those inputs), so the
    batch collapses to its unique rows before dispatch and the scored
    results fan back out.

This is the batching-layer component: a ``DedupPlan`` maps a request
batch to its unique programs and back.  Bit-level equality (float keys
are compared on their bit patterns) is deliberately conservative: it can
only miss sharing, never invent it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


_P1 = np.uint64(1099511628211)
_OFF = np.uint64(14695981039346656037)


def _fnv1a(cols: np.ndarray) -> np.ndarray:
    """(B, S) uint-castable columns -> (B,) FNV-1a hashes (the probe)."""
    h = np.full(cols.shape[0], _OFF, np.uint64)
    for t in range(cols.shape[1]):
        h = (h ^ cols[:, t].astype(np.uint64)) * _P1
    return h


def prompt_hash(tokens: np.ndarray) -> np.ndarray:
    """(B, S) -> (B,) FNV-1a over token ids (the probe step)."""
    return _fnv1a(tokens)


@dataclass
class DedupPlan:
    unique_rows: np.ndarray          # (U,) indices into the original batch
    scatter: np.ndarray              # (B,) position of each request's twin
    n_unique: int

    @property
    def savings(self) -> float:
        return 1.0 - self.n_unique / max(len(self.scatter), 1)


def _dedup(hashes: np.ndarray, rows: np.ndarray) -> DedupPlan:
    """Hash-probe then exact verify within buckets (Relationship 2: the
    probe admits candidates, only bitwise row equality shares)."""
    B = rows.shape[0]
    first_of: dict = {}
    unique_rows: list[int] = []
    scatter = np.zeros(B, np.int64)
    for i in range(B):
        bucket = first_of.setdefault(int(hashes[i]), [])
        hit = -1
        for u in bucket:                      # exact verify
            if np.array_equal(rows[i], rows[unique_rows[u]]):
                hit = u
                break
        if hit < 0:
            hit = len(unique_rows)
            unique_rows.append(i)
            bucket.append(hit)
        scatter[i] = hit
    return DedupPlan(unique_rows=np.asarray(unique_rows, np.int64),
                     scatter=scatter, n_unique=len(unique_rows))


def dedup_batch(tokens: np.ndarray) -> DedupPlan:
    """Collapse identical (B, S) prompts: hash-probe, then exact verify
    within buckets (hash collisions never cause wrong sharing)."""
    return _dedup(prompt_hash(tokens), tokens)


def dedup_rows(rows: np.ndarray) -> DedupPlan:
    """Collapse bitwise-identical rows of an arbitrary fixed-width (B, W)
    array — the CF query-path generalisation of ``dedup_batch``.

    Rows are compared on their raw bytes: float keys dedup on bit
    patterns (NaN payloads and -0.0 vs 0.0 distinguish), which is exactly
    the "identical inputs -> identical scores" contract the query path
    needs and strictly conservative otherwise."""
    rows = np.ascontiguousarray(rows)
    B = rows.shape[0]
    flat = rows.reshape(B, -1).view(np.uint8)
    return _dedup(_fnv1a(flat.view(np.uint32) if flat.shape[1] % 4 == 0
                         else flat), flat)


def fan_out(unique_results: np.ndarray, plan: DedupPlan) -> np.ndarray:
    """Scatter the unique computations back to the full batch."""
    return unique_results[plan.scatter]
