"""Twin detection over graph adjacency — the paper's idea transplanted
(PyTorch port of ``repro.core.twins_graph``).

A node's neighbour list is structurally a user's similarity list; nodes with
identical adjacency rows ("structural twins") produce identical GNN messages
and can share computation.  Used by the molecule pipeline to dedup
isomorphic-featured nodes; exposed as a generic utility.

torch has no arithmetic on unsigned 32- or 64-bit integers on the CPU, so
everything is int64 holding the reference's bits: a signature is masked to
32 bits after the multiply and after the sum (reduction mod 2^32 commutes
with the sum, so this is exact), the group key is built with int64
multiply-adds, which wrap to the same bits as the reference's uint64, and
the key is sorted with its sign bit flipped, so signed order is the
reference's unsigned order.
"""
from __future__ import annotations

import torch

_PRIMES = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
_U32 = 0xFFFFFFFF
_FNV_PRIME = 0x100000001B3
_SIGN = torch.iinfo(torch.int64).min          # the bit pattern 1 << 63


def adjacency_signature(edge_dst: torch.Tensor, edge_src: torch.Tensor,
                        n_nodes: int, n_hash: int = 4) -> torch.Tensor:
    """(n_nodes, n_hash) order-invariant signatures of each node's neighbour
    multiset via summed multiplicative hashes of neighbour ids; int64
    holding the reference's uint32 values."""
    dev = edge_src.device
    primes = torch.tensor(_PRIMES[:n_hash], dtype=torch.int64, device=dev)
    src = edge_src.long() & _U32
    h = ((src[:, None] * primes[None, :]) & _U32) ^ (src[:, None] >> 7)
    sig = torch.zeros((n_nodes, primes.shape[0]), dtype=torch.int64,
                      device=dev)
    sig.index_add_(0, edge_dst.long(), h)
    return sig & _U32


def twin_groups(signatures: torch.Tensor) -> torch.Tensor:
    """(n,) int64 group id per node; nodes sharing a signature share a
    group, numbered in the order of their keys.  Collisions are resolved by
    the caller via exact row comparison (the same probe-then-verify
    structure as TwinSearch)."""
    n = signatures.shape[0]
    packed = signatures.long()
    key = packed[:, 0]
    for j in range(1, signatures.shape[1]):
        key = key * _FNV_PRIME + packed[:, j]        # wraps as uint64 does
    order = torch.sort(key ^ _SIGN, stable=True).indices
    sorted_key = key[order]
    new_group = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=key.device),
                           sorted_key[1:] != sorted_key[:-1]])
    gid_sorted = torch.cumsum(new_group, dim=0) - 1
    gid = torch.zeros(n, dtype=gid_sorted.dtype, device=key.device)
    gid[order] = gid_sorted
    return gid
