"""Similarity measures for neighbourhood CF (PyTorch port of
``repro.core.similarity``).

Each formula keeps the reference's order of operations: the full build
normalises the rows first and then multiplies; ``cosine_vs_all`` multiplies
first and then divides.  The rounding that follows from that order feeds
the 1e-6 twin tolerance, so it is part of the contract.

fp32 products on the card run without TF32 (about three decimal digits,
far too coarse for that tolerance): every matmul here first turns TF32 off
for the process.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def _fp32_exact(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def row_norms(R: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(R.float()), dim=-1))


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(x, EPS)


def cosine_matrix(R: torch.Tensor, *,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n, n) cosine similarity; fp32 accumulation.  The rows and their
    norms are rounded to ``compute_dtype`` and divided there, as in the
    reference; a bf16 product is a float32 sum of exact bf16 products
    (``layers.matmul_f32``)."""
    _fp32_exact(R)
    Rn = R.to(compute_dtype) / _safe(row_norms(R))[:, None].to(compute_dtype)
    if compute_dtype == torch.float32:
        return Rn @ Rn.T
    # Imported here: ``repro_torch.models`` imports this package.
    from repro_torch.models.layers import matmul_f32
    return matmul_f32(Rn, Rn.T)


def cosine_vs_all(R: torch.Tensor, norms: torch.Tensor,
                  r0: torch.Tensor) -> torch.Tensor:
    """(n,) cosine similarity of one new row ``r0`` against every row of R.
    ``norms`` is the cached row-norm vector (0 for inactive rows: their
    similarity is reported as 0 and must be masked by the caller)."""
    _fp32_exact(R)
    r0 = r0.float()
    dots = R.float() @ r0
    denom = _safe(norms) * _safe(torch.sqrt(torch.sum(torch.square(r0))))
    return dots / denom


def pearson_matrix(R: torch.Tensor) -> torch.Tensor:
    """Pearson correlation restricted to co-rated items, exact via matmuls
    (see ``repro.core.similarity.pearson_matrix``)."""
    _fp32_exact(R)
    Rf = R.float()
    B = (Rf != 0).float()
    n_co = B @ B.T
    sum_uv = Rf @ Rf.T
    sum_u = Rf @ B.T
    sq_u = torch.square(Rf) @ B.T
    n_safe = _safe(n_co)
    cov = sum_uv - sum_u * sum_u.T / n_safe
    var_u = sq_u - torch.square(sum_u) / n_safe
    var_v = var_u.T
    sim = cov / _safe(torch.sqrt(_safe(var_u) * _safe(var_v)))
    return torch.where(n_co >= 2, sim, 0.0)


def adjusted_cosine_matrix(R: torch.Tensor) -> torch.Tensor:
    """Item-based adjusted cosine on R laid out (items, users): centre each
    user's ratings by their mean, then the item-item cosine."""
    Rf = R.float()
    B = Rf != 0
    user_sum = torch.sum(Rf, dim=0)
    user_cnt = _safe(torch.sum(B, dim=0).float())
    centred = torch.where(B, Rf - (user_sum / user_cnt)[None, :], 0.0)
    return cosine_matrix(centred)


MEASURES = {
    "cosine": cosine_matrix,
    "pearson": pearson_matrix,
    "adjusted_cosine": adjusted_cosine_matrix,
}


def similarity_matrix(R: torch.Tensor, measure: str = "cosine"
                      ) -> torch.Tensor:
    try:
        fn = MEASURES[measure]
    except KeyError:
        raise ValueError(f"unknown similarity measure {measure!r}; "
                         f"have {sorted(MEASURES)}") from None
    return fn(R)
