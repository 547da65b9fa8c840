"""The paper's CF system as a launchable architecture family (PyTorch port
of ``repro.models.cf``).

Two step kinds (see ``repro_torch/configs/twinsearch_cf.py``):

  * ``build``   — the traditional full similarity build: rows normalised
    in the ratings' dtype, the cosine product accumulated in fp32 on the
    ``similarity`` kernel (on the card; its plain version on the CPU),
    then a stable per-row sort in ``SORT_CHUNK_ROWS`` slices.
  * ``onboard`` — the TwinSearch burst: k new users scanned through
    probe -> equal-range search -> mask intersect -> bounded verify -> copy,
    with the traditional mat-vec + sort as the per-user fallback; over a
    row-sharded arena on ``torch.distributed`` when given ``mesh_info``
    (``core.twinsearch_sharded``).

``state_structs`` and ``input_structs`` describe a step's inputs as
tensors on the ``meta`` device, which hold shapes and dtypes and no data.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import CFConfig, ShapeSpec, pad_to_shard
from repro_torch.core import baseline
from repro_torch.core import twinsearch as ts
from repro_torch.core.knn import SORT_CHUNK_ROWS, sort_rows
from repro_torch.core.similarity import EPS, row_norms
from repro_torch.core.types import CFState, set0_cap
from repro_torch.kernels.similarity.kernel import row_buffer
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.spans import RECORDER


def build_step(R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full build: R (n, m) -> ascending sorted lists (vals f32, idx i32).

    Rows are normalised as the reference does: the fp32 norm, the division
    in fp32, the cast back to ``R.dtype``, written straight into a buffer
    whose rows the kernel reads as they lie (bf16: a row stride of
    roundup(m, 8) items, ``kernel.row_buffer``), so no copy is paid.  The
    product Rn·Rnᵀ runs on the similarity kernel in ``R``'s dtype (float32
    on the CUDA cores without TF32, bfloat16 on the tensor cores) with unit
    norms, so its epilogue divides by max(1·1, EPS) = 1 exactly, and
    accumulates in fp32.  The sort is stable, in ``SORT_CHUNK_ROWS`` row
    slices written back over the product.  One call is one request of
    ``repro_torch.spans``, ``cf.build_step``."""
    with RECORDER.request("cf.build_step"):
        return _build(R)


def _build(R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    Rf = R.float()
    norms = torch.clamp_min(row_norms(Rf), EPS)
    Rn = torch.div(Rf, norms[:, None],
                   out=row_buffer(*R.shape, R.dtype, R.device))
    del Rf
    ones = torch.ones(R.shape[0], dtype=torch.float32, device=R.device)
    S = cosine_similarity(Rn, Rn, ones, ones)
    del Rn
    idx = torch.empty(S.shape, dtype=torch.int32, device=S.device)
    for r0 in range(0, S.shape[0], SORT_CHUNK_ROWS):
        sl = slice(r0, r0 + SORT_CHUNK_ROWS)
        S[sl], idx[sl] = sort_rows(S[sl])
    return S, idx


def onboard_step(state: CFState, R_new: torch.Tensor, probes,
                 cfg: CFConfig, mesh_info=None):
    """The TwinSearch burst over an immutable base arena, with the static
    candidate bound ``set0_cap(N_base, cfg.set0_divisor, cfg.set0_slack)``
    and ``tol = cfg.sim_tol``.

    Without ``mesh_info``: ``state`` is the whole arena and the buffered
    burst runs (``twinsearch.onboard_batch_buffered``).  With
    ``mesh_info=(axes, mesh)``: ``state`` is this rank's rows
    (``distributed.sharding.local_state``) of an arena row-sharded over
    those axes of the ``DeviceMesh``, and the sharded burst runs
    (``twinsearch_sharded.onboard_batch_sharded``); N_base is the width of
    the lists."""
    n_base = state.sim_vals.shape[1]
    s_max = set0_cap(n_base, cfg.set0_divisor, cfg.set0_slack)
    if mesh_info is not None:
        from repro_torch.core.twinsearch_sharded import onboard_batch_sharded
        axes, mesh = mesh_info
        return onboard_batch_sharded(state, R_new, probes, s_max=s_max,
                                     axes=axes, mesh=mesh, tol=cfg.sim_tol)
    return ts.onboard_batch_buffered(state, R_new, probes, s_max=s_max,
                                     tol=cfg.sim_tol)


def onboard_traditional_step(state: CFState, R_new: torch.Tensor):
    """The baseline burst (every user through compute-all + sort).  The k
    users are appended **in place** into the arena's last k slots
    (``n_active == capacity - k``); returns their (vals, idx) rows."""
    k = R_new.shape[0]
    state2 = baseline.onboard_batch_traditional(state, R_new)
    rows = slice(state.capacity - k, state.capacity)
    return state2.sim_vals[rows], state2.sim_idx[rows]


def state_structs(n_base: int, m: int, k: int,
                  ratings_dtype: torch.dtype = torch.bfloat16) -> CFState:
    """A stand-in ``CFState`` of ``meta`` tensors with capacity n_base + k;
    ``n_active`` is a 0-d int32 tensor, as the reference's struct."""
    N = n_base + k

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    return CFState(ratings=meta((N, m), ratings_dtype),
                   norms=meta((N,), torch.float32),
                   sim_vals=meta((N, N), torch.float32),
                   sim_idx=meta((N, N), torch.int32),
                   n_active=meta((), torch.int32))


def input_structs(cfg: CFConfig, shape: ShapeSpec) -> dict[str, Any]:
    """A step's inputs as ``meta`` tensors: bf16 ratings, rows padded to the
    shard boundary (``pad_to_shard``), as the reference's."""
    n, m = shape.dim("n_users"), shape.dim("n_items")
    if cfg.mode == "item":
        n, m = m, n
    if shape.kind == "build":
        # Row count pads to the shard boundary (zero rows sort harmlessly;
        # benches at exact scale run unsharded).
        return {"R": torch.empty((pad_to_shard(n), m), dtype=torch.bfloat16,
                                 device="meta")}
    if shape.kind == "onboard":
        k = shape.dim("k_new")
        return {
            "state": state_structs(pad_to_shard(n), m, 0),
            "R_new": torch.empty((k, m), dtype=torch.bfloat16,
                                 device="meta"),
            "probes": torch.empty((k, cfg.c_probes), dtype=torch.int32,
                                  device="meta"),
        }
    raise ValueError(f"unknown CF shape kind {shape.kind}")
