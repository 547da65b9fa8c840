"""Deterministic LM token pipeline.

Synthetic corpus with bigram structure (so a ~100M-param model visibly
learns), generated stateless-per-step from (seed, step) — restart at step k
trivially replays the exact stream, which is what the checkpoint/resume
integration test asserts.
"""
from __future__ import annotations

import numpy as np


def _bigram_table(seed: int, vocab: int, branch: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(vocab, branch), dtype=np.int32)


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq, self.seed = vocab, batch, seq, seed
        self._table = _bigram_table(seed, vocab)

    def __call__(self, step: int) -> dict:
        rng = np.random.default_rng([self.seed, step])
        toks = np.empty((self.batch, self.seq), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, self.batch)
        branch = self._table.shape[1]
        choices = rng.integers(0, branch, size=(self.batch, self.seq))
        for t in range(1, self.seq):
            toks[:, t] = self._table[toks[:, t - 1], choices[:, t]]
        return {"tokens": toks}

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "next_step": step}
