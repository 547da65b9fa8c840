"""Pure-NumPy transcription of Algorithm 1 — the testing oracle.

This mirrors the paper's pointer/set formulation (binary search on sorted
lists, Python-set intersection, early-exit verification loop) so the
vectorised implementation in ``twinsearch.py`` can be property-tested
against it.  The port keeps its own copy of the reference's oracle.
"""
from __future__ import annotations

import bisect

import numpy as np


def cosine_vs_all_np(R: np.ndarray, r0: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(R.astype(np.float64), axis=1)
    n0 = np.linalg.norm(r0.astype(np.float64))
    dots = R.astype(np.float64) @ r0.astype(np.float64)
    return dots / np.maximum(norms * max(n0, 1e-12), 1e-12)


def build_sorted_lists_np(R: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Full similarity build; ascending per row, (vals, idx)."""
    Rf = R.astype(np.float64)
    norms = np.maximum(np.linalg.norm(Rf, axis=1), 1e-12)
    S = (Rf / norms[:, None]) @ (Rf / norms[:, None]).T
    idx = np.argsort(S, axis=1, kind="stable").astype(np.int32)
    vals = np.take_along_axis(S, idx, axis=1)
    return vals, idx


def twinsearch_np(R: np.ndarray, sim_vals: np.ndarray, sim_idx: np.ndarray,
                  r0: np.ndarray, probes: np.ndarray, tol: float = 1e-6
                  ) -> tuple[bool, int, set[int]]:
    """Algorithm 1 on NumPy/python structures.

    Returns (found, twin_index, Set_0).  ``sim_vals``/``sim_idx`` are the
    ascending sorted lists of the *existing* n users.
    """
    n = R.shape[0]
    sims0 = cosine_vs_all_np(R, r0)[probes]

    sets: list[set[int]] = []
    for i, p in enumerate(probes):
        row_v = sim_vals[p]
        row_i = sim_idx[p]
        lo = bisect.bisect_left(row_v.tolist(), sims0[i] - tol)
        hi = bisect.bisect_right(row_v.tolist(), sims0[i] + tol)
        s = set(int(x) for x in row_i[lo:hi])
        if abs(sims0[i] - 1.0) <= tol:          # lines 5-7
            s.add(int(p))
        sets.append(s)

    set0 = sets[0]
    for s in sets[1:]:
        set0 &= s

    for x in sorted(set0):                       # lines 10-15
        if np.array_equal(R[x], r0.astype(R.dtype)):
            return True, x, set0
    return False, -1, set0
