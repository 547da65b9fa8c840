"""Carry a ``CFState``, and trees of model weights, between the JAX
reference and the port.

The JAX ``CFState`` crosses as a dict of numpy arrays (``ratings``,
``norms``, ``sim_vals``, ``sim_idx``, ``n_active``), and a tree of weights
or optimizer state as the same nest of numpy arrays, so neither package
imports the other.  ``lists_match`` is the tolerance contract for sorted
similarity lists built by two implementations.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import (SENTINEL, SENTINEL_GATE, CFState,
                                    require_device)
from repro_torch.tree import tree_map

FIELDS = ("ratings", "norms", "sim_vals", "sim_idx", "n_active")


def state_from_numpy(arrays: dict, device: str | torch.device = "cuda"
                     ) -> CFState:
    """numpy arrays (or anything ``np.asarray`` takes) -> port state on
    ``device``, the card unless the caller asks for the CPU.  Raises if
    ``device`` is CUDA and no card is present."""
    device = require_device(device, "state_from_numpy")
    a = {k: np.asarray(arrays[k]) for k in FIELDS}
    return CFState(
        ratings=torch.as_tensor(a["ratings"].astype(np.float32),
                                device=device),
        norms=torch.as_tensor(a["norms"].astype(np.float32), device=device),
        sim_vals=torch.as_tensor(a["sim_vals"].astype(np.float32),
                                 device=device),
        sim_idx=torch.as_tensor(a["sim_idx"].astype(np.int32),
                                device=device),
        n_active=int(a["n_active"]))


def state_to_numpy(state) -> dict:
    """Port state -> dict of numpy arrays (copies; ``n_active`` as an
    int32 scalar), the layout ``state_from_numpy`` and the JAX side read."""
    return {"ratings": state.ratings.cpu().numpy().copy(),
            "norms": state.norms.cpu().numpy().copy(),
            "sim_vals": state.sim_vals.cpu().numpy().copy(),
            "sim_idx": state.sim_idx.cpu().numpy().copy(),
            "n_active": np.int32(state.n_active)}


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """A nest of dicts, lists, tuples and NamedTuples of numpy arrays (or
    anything ``np.asarray`` takes: JAX arrays, scalars) -> the same nest of
    tensors on ``device``, the card unless the caller asks for the CPU.
    Each leaf is copied; a bfloat16 array stays bfloat16.  A NamedTuple
    keeps its own type: wrap it in the port's (``AdamWState(*tree)``)."""
    device = require_device(device, "params_from_numpy")

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32),
                                device=device).to(torch.bfloat16)
        return torch.tensor(a, device=device)

    return tree_map(one, tree)


def params_to_numpy(tree):
    """A nest of tensors -> the same nest of numpy arrays (host copies;
    bfloat16 as float32, which holds every bfloat16 value exactly)."""
    def one(t):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy()

    return tree_map(one, tree)


def _dense(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Scatter each sorted row back to user order (ids < 0 skipped)."""
    n, L = vals.shape
    out = np.full((n, L), SENTINEL, np.float32)
    r, c = np.nonzero(idx >= 0)
    out[r, idx[r, c]] = vals[r, c]
    return out


def lists_match(vals_a: np.ndarray, idx_a: np.ndarray, vals_b: np.ndarray,
                idx_b: np.ndarray, atol: float) -> str | None:
    """Compare two sets of ascending similarity lists built by different
    implementations.  Sorted values must agree within ``atol``, every
    (row, user) similarity must agree within ``atol``, and the ids must
    match exactly except inside runs of values that lie within ``atol`` of
    a neighbour (near-ties may order either way).  Returns None on a match,
    else a description of the first mismatch."""
    vals_a, vals_b = np.asarray(vals_a), np.asarray(vals_b)
    idx_a, idx_b = np.asarray(idx_a), np.asarray(idx_b)
    if vals_a.shape != vals_b.shape or idx_a.shape != idx_b.shape:
        return f"shapes differ: {vals_a.shape} vs {vals_b.shape}"
    err = np.abs(vals_a - vals_b)
    if err.max(initial=0.0) > atol:
        r, c = np.unravel_index(np.argmax(err), err.shape)
        return f"sorted values differ at ({r}, {c}) by {err[r, c]:.3g}"
    derr = np.abs(_dense(vals_a, idx_a) - _dense(vals_b, idx_b))
    if derr.max(initial=0.0) > atol:
        r, c = np.unravel_index(np.argmax(derr), derr.shape)
        return f"similarity of row {r} to user {c} differs by {derr[r, c]:.3g}"
    # SENTINEL runs tie exactly; their ids follow the same stable order.
    bad = _unexplained(vals_a, idx_a, idx_b, atol, vals_a > SENTINEL_GATE)
    if bad is not None:
        r, c = bad
        return (f"ids differ at ({r}, {c}): {idx_a[r, c]} vs {idx_b[r, c]} "
                f"with no near-tie")
    return None


def _unexplained(vals, ids_a, ids_b, atol, may_tie, last_may_tie=False):
    """First (row, col) where the ids differ although the value there lies
    more than ``atol`` from both neighbours (so no near-tie can explain
    it), or None."""
    gap = np.abs(np.diff(vals, axis=1)) <= atol
    near = np.zeros(vals.shape, bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    if last_may_tie:
        near[:, -1] = True
    bad = (ids_a != ids_b) & ~(near & may_tie)
    return tuple(np.argwhere(bad)[0]) if bad.any() else None


def ranked_match(vals_a, ids_a, vals_b, ids_b, atol: float) -> str | None:
    """Compare two top-n cuts (descending scores, item ids) from different
    implementations: scores within ``atol``; ids exact except inside
    near-ties, including one at the cut with an item outside it.  Returns
    None on a match, else a description of the first mismatch."""
    vals_a, vals_b = np.asarray(vals_a), np.asarray(vals_b)
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    if vals_a.shape != vals_b.shape or ids_a.shape != ids_b.shape:
        return f"shapes differ: {vals_a.shape} vs {vals_b.shape}"
    with np.errstate(invalid="ignore"):
        err = np.where(vals_a == vals_b, 0.0, np.abs(vals_a - vals_b))
    if np.nanmax(err, initial=0.0) > atol or np.isnan(err).any():
        return f"scores differ by up to {np.nanmax(err):.3g}"
    bad = _unexplained(vals_a, ids_a, ids_b, atol, np.isfinite(vals_a),
                       last_may_tie=True)
    if bad is not None:
        r, c = bad
        return (f"items differ at ({r}, {c}): {ids_a[r, c]} vs "
                f"{ids_b[r, c]} with no near-tie")
    return None
