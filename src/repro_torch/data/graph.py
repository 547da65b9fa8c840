"""Graph data: generators + a real neighbour sampler.

``NeighborSampler`` implements GraphSAGE-style fixed-fanout sampling from a
CSR adjacency (uniform with replacement, self-loop fallback for isolated
nodes) — the ``minibatch_lg`` cell's host-side companion.  Generators
produce power-law graphs at Cora / Reddit / ogbn-products scales plus
batched molecule graphs.
"""
from __future__ import annotations

import numpy as np


def random_graph(seed: int, n_nodes: int, n_edges: int, power: float = 1.2,
                 add_self_loops: bool = True
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Power-law (src, dst) int32 edge lists."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, n_nodes + 1, dtype=np.float64) ** -power
    p /= p.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges, dtype=np.int32)
    if add_self_loops:
        loops = np.arange(n_nodes, dtype=np.int32)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    return src, dst


def cora_like(seed: int = 0) -> dict:
    """2708 nodes, 10556 edges, 1433 binary features, 7 classes."""
    rng = np.random.default_rng(seed)
    n, d, c = 2708, 1433, 7
    src, dst = random_graph(seed, n, 10_556)
    labels = rng.integers(0, c, n).astype(np.int32)
    # Class-correlated sparse binary features (so GAT can learn).
    proto = rng.random((c, d)) < 0.015
    noise = rng.random((n, d)) < 0.005
    feats = (proto[labels] | noise).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, 140, replace=False)] = True      # 20/class train split
    return {"feats": feats, "edge_src": src, "edge_dst": dst,
            "labels": labels, "mask": mask}


def molecule_batch(seed: int, batch: int, n_nodes: int = 30,
                   n_edges: int = 64, d_feat: int = 16,
                   n_classes: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    loops = np.broadcast_to(np.arange(n_nodes, dtype=np.int32),
                            (batch, n_nodes))
    src = np.concatenate([src, loops], axis=1)
    dst = np.concatenate([dst, loops], axis=1)
    labels = rng.integers(0, n_classes, batch).astype(np.int32)
    feats = rng.normal(size=(batch, n_nodes, d_feat)).astype(np.float32)
    feats += labels[:, None, None] * 0.3
    return {"feats": feats, "edge_src": src, "edge_dst": dst,
            "labels": labels}


class CSR:
    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(src, kind="stable")
        self.col = dst[order]
        counts = np.bincount(src, minlength=n_nodes)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64)
        self.n_nodes = n_nodes


class NeighborSampler:
    """Fixed-fanout uniform neighbour sampling (with replacement; isolated
    nodes fall back to self-loops) producing the padded index arrays the
    ``train_sampled`` model path consumes."""

    def __init__(self, csr: CSR, fanouts: tuple[int, ...], seed: int = 0):
        self.csr, self.fanouts, self.seed = csr, fanouts, seed

    def _sample(self, rng, nodes: np.ndarray, fanout: int) -> np.ndarray:
        lo = self.csr.indptr[nodes]
        hi = self.csr.indptr[nodes + 1]
        deg = (hi - lo)
        r = rng.integers(0, np.maximum(deg, 1)[:, None],
                         size=(nodes.size, fanout))
        idx = np.minimum(lo[:, None] + r, len(self.csr.col) - 1)
        nbrs = self.csr.col[idx].astype(np.int32)
        return np.where(deg[:, None] > 0, nbrs, nodes[:, None].astype(
            np.int32))

    def __call__(self, step: int, roots: np.ndarray) -> dict:
        """2-hop block: roots (B,) -> nbr1 (B, f1), nbr2 (B(1+f1), f2)."""
        rng = np.random.default_rng([self.seed, step])
        f1, f2 = self.fanouts[0], self.fanouts[1]
        nbr1 = self._sample(rng, roots, f1)              # (B, f1)
        frontier = np.concatenate([roots[:, None], nbr1], axis=1).reshape(-1)
        nbr2 = self._sample(rng, frontier, f2)           # (B(1+f1), f2)
        return {"roots": roots.astype(np.int32), "nbr1": nbr1, "nbr2": nbr2}
