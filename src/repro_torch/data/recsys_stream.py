"""Synthetic CTR / retrieval batch streams (a numpy copy of
``repro.data.recsys_stream``: the same seed and step give the reference's
batches bit for bit).

Per-field Zipf-distributed ids (hot-row skew like production traffic),
labels drawn from a hidden sparse-linear teacher so AUC visibly improves,
and stateless (seed, step) generation for exact restart replay.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.recsys import MULTI_HOT, _N_ITEM_FIELDS, _N_USER_FIELDS


def _zipf_ids(rng, vocab: int, size, a: float = 1.3) -> np.ndarray:
    raw = rng.zipf(a, size=size)
    return ((raw - 1) % vocab).astype(np.int32)


class CTRStream:
    def __init__(self, cfg: RecsysConfig, batch: int, seed: int = 0):
        self.cfg, self.batch, self.seed = cfg, batch, seed
        rng = np.random.default_rng(seed)
        self._field_w = rng.normal(0, 1.0, len(cfg.field_vocab_sizes))
        self._dense_w = rng.normal(0, 0.5, cfg.n_dense or 0)

    def __call__(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng([self.seed, step])
        B = self.batch
        idx = np.stack([_zipf_ids(rng, v, B)
                        for v in cfg.field_vocab_sizes], axis=1)
        batch: dict = {"sparse_idx": idx}
        score = (self._field_w[None, :] * ((idx % 7) - 3) / 3.0).sum(1)
        if cfg.n_dense:
            dense = rng.normal(0, 1, (B, cfg.n_dense)).astype(np.float32)
            batch["dense"] = dense
            score = score + dense @ self._dense_w
        if cfg.variant == "xdeepfm":
            batch["multi_idx"] = _zipf_ids(
                rng, cfg.field_vocab_sizes[0], (B, MULTI_HOT))
            batch["multi_mask"] = rng.random((B, MULTI_HOT)) < 0.6
        if cfg.variant == "bst":
            batch["hist"] = _zipf_ids(rng, cfg.item_vocab, (B, cfg.seq_len))
            batch["target"] = _zipf_ids(rng, cfg.item_vocab, B)
            score = score + ((batch["target"] % 11) - 5) / 5.0
        p = 1 / (1 + np.exp(-(score - score.mean())))
        batch["label"] = (rng.random(B) < p).astype(np.float32)
        return batch


class TwoTowerStream:
    def __init__(self, cfg: RecsysConfig, batch: int, seed: int = 0):
        self.cfg, self.batch, self.seed = cfg, batch, seed

    def __call__(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng([self.seed, step])
        B = self.batch
        uf = np.stack([_zipf_ids(rng, v, B) for v in
                       cfg.field_vocab_sizes[:_N_USER_FIELDS]], axis=1)
        itf = np.stack([_zipf_ids(rng, v, B) for v in
                        cfg.field_vocab_sizes[_N_USER_FIELDS:
                                              _N_USER_FIELDS +
                                              _N_ITEM_FIELDS]], axis=1)
        return {
            "user_id": _zipf_ids(rng, cfg.user_vocab, B),
            "user_fields": uf,
            "item_id": _zipf_ids(rng, cfg.item_vocab, B),
            "item_fields": itf,
            "label": np.ones(B, np.float32),
        }
