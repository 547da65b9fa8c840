"""Core state container for the neighbourhood-CF system (PyTorch port of
``repro.core.types``).

  * ``ratings``  — (N, m) float32 dense rating matrix, 0 = unrated.
  * ``norms``    — (N,) cached L2 row norms (0 for inactive rows).
  * ``sim_vals`` — (N, N) per-row similarity lists sorted **ascending**
                   (top neighbour = tail); inactive entries hold SENTINEL.
  * ``sim_idx``  — (N, N) int32: ``sim_vals[i, j]`` is the similarity
                   between user i and user ``sim_idx[i, j]``.
  * ``n_active`` — host ``int`` count of live rows; rows [n_active, N) are
                   the preallocated slots new users are appended into.

``n_active`` is a Python int rather than a device scalar: every request
reads it, and a device scalar would cost a host-device sync each time.
Onboarding writes the new user's rows into the arena **in place** (the JAX
reference copies the (N, N) arena on every onboard); a function that does
so says so, and returns a state whose tensors alias its input's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

SENTINEL = -2.0
# Anything above this is a real similarity (cosine/pearson live in [-1, 1]).
SENTINEL_GATE = -1.5


def require_device(device: str | torch.device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no card is
    present, so an entry point never slides onto the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device='cuda') needs a CUDA device "
                           "and none is available; pass device='cpu' to "
                           "run the plain PyTorch path")
    return device


class CFState(NamedTuple):
    ratings: torch.Tensor       # (N, m) float32
    norms: torch.Tensor         # (N,) float32
    sim_vals: torch.Tensor      # (N, N) float32, ascending per row
    sim_idx: torch.Tensor       # (N, N) int32
    n_active: int

    @property
    def capacity(self) -> int:
        return self.ratings.shape[0]

    @property
    def n_items(self) -> int:
        return self.ratings.shape[1]

    @property
    def device(self) -> torch.device:
        return self.ratings.device


class TwinResult(NamedTuple):
    """Outcome of one TwinSearch probe-and-verify pass (0-d tensors)."""

    found: torch.Tensor         # bool — a verified twin exists
    twin_idx: torch.Tensor      # int — index of the twin (garbage if !found)
    n_candidates: torch.Tensor  # int — |Set_0| before the static cap
    overflowed: torch.Tensor    # bool — |Set_0| exceeded the static bound
    probe_sims: torch.Tensor    # (c,) — sims between the new user and probes


class OnboardStats(NamedTuple):
    """Per-new-user statistics from a batched onboarding loop."""

    found: torch.Tensor         # (k,) bool
    twin_idx: torch.Tensor      # (k,) int
    n_candidates: torch.Tensor  # (k,) int
    overflowed: torch.Tensor    # (k,) bool


def active_mask(state: CFState) -> torch.Tensor:
    """(N,) bool — which capacity rows hold live users."""
    return torch.arange(state.capacity, device=state.device) < state.n_active


def as_index(x, device: torch.device) -> torch.Tensor:
    """Ids (tensor, numpy array, list or int) as an int64 tensor on
    ``device``; numpy input is copied, never aliased."""
    if isinstance(x, torch.Tensor):
        return x.to(device).long()
    return torch.tensor(x, device=device).long()


def clone_state(state: CFState) -> CFState:
    """Deep copy of the arena (the port writes rows in place, so a snapshot
    must not alias the live state)."""
    return CFState(state.ratings.clone(), state.norms.clone(),
                   state.sim_vals.clone(), state.sim_idx.clone(),
                   state.n_active)


def set0_cap(n: int, divisor: int = 125, slack: float = 1.5,
             minimum: int = 8) -> int:
    """Static candidate-set bound from the paper's Gaussian analysis
    (|Set_0| <= n/125, with ``slack`` for tie mass); identical to the JAX
    reference's."""
    cap = max(minimum, int(math.ceil(n / divisor * slack)))
    if cap > 512:
        cap = -(-cap // 512) * 512
    return cap
