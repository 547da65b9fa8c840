"""Batched LM decode loop (PyTorch port of ``repro.serving.lm_server``):
prefill once, decode autoregressively, with the twin-prompt dedup plan
collapsing identical requests before prefill."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as lm
from repro_torch.serving.dedup import DedupPlan, dedup_batch, fan_out


class LMServer:
    """Serves ``cfg`` with ``params`` on the device the params live on.

    ``_prefill`` and ``_decode`` are the server's two steps, as in the
    reference (there jitted); a caller may wrap them to time each one."""

    def __init__(self, params: dict, cfg: LMConfig, max_len: int = 1024):
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self.device = params["embed"].device
        self._prefill = lambda p, t: lm.prefill(p, t, cfg)
        self._decode = lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg)

    @torch.no_grad()
    def generate(self, tokens: np.ndarray, n_new: int,
                 dedup: bool = True, greedy: bool = True,
                 key=None) -> tuple[np.ndarray, dict]:
        """tokens: (B, S) prompts (equal length) -> ((B, n_new) int32
        completions, {"prefill_rows", "batch", "dedup_savings"}).

        With ``dedup`` the batch collapses to unique prompts (the paper's
        twin insight at the serving layer); identical prompts share prefill
        *and* decode compute under greedy decoding.  Decoding is greedy
        (``argmax``, the first index on ties) whatever ``greedy`` says, as
        in the reference: ``greedy=False`` only turns dedup off, and ``key``
        is unused.  The reference also runs one decode step after the last
        token, whose logits it drops; the port skips it.
        """
        tokens = np.asarray(tokens)
        B, S = tokens.shape
        if S + n_new > self.max_len:
            raise ValueError(f"{S} prompt + {n_new} new tokens exceed "
                             f"max_len {self.max_len}")
        plan: DedupPlan | None = None
        work = tokens
        if dedup and greedy:
            plan = dedup_batch(tokens)
            work = tokens[plan.unique_rows]

        logits, cache = self._prefill(
            self.params, torch.as_tensor(work, device=self.device))
        # Grow the global cache to max_len for decode appends.
        for k in ("kg", "vg"):
            c = cache[k]
            grown = c.new_zeros((*c.shape[:2], self.max_len, *c.shape[3:]))
            grown[:, :, :S] = c
            cache[k] = grown
        out = []
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for i in range(n_new):
            out.append(tok[:, 0])
            if i + 1 < n_new:
                logits, cache = self._decode(self.params, cache, tok, S + i)
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        completions = (torch.stack(out, dim=1).cpu().numpy() if out else
                       np.zeros((work.shape[0], 0), np.int32))
        info = {"prefill_rows": work.shape[0], "batch": B,
                "dedup_savings": plan.savings if plan else 0.0}
        if plan is not None:
            completions = fan_out(completions, plan)
        return completions, info
