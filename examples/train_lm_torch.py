"""End-to-end run on the PyTorch port: train a ~100M-param LM for a few
hundred steps on the synthetic bigram corpus, with checkpointing + resume,
on one CUDA card (or ``--device cpu``).

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
          [--dim 512] [--device cuda]

The config is a shrunk Gemma-3-style model (~100M params at the defaults);
loss should fall from ~ln(V) toward the bigram entropy floor.
"""
import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.types import require_device
from repro_torch.data import TokenPipeline
from repro_torch.models import transformer as lm
from repro_torch.training import (AdamW, TrainLoopConfig, init_ef,
                                  make_train_step, run_loop, warmup_cosine)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = require_device(args.device, "train_lm_torch")

    cfg = LMConfig(
        name="train-demo", n_layers=args.layers, d_model=args.dim,
        n_heads=8, n_kv_heads=4, head_dim=args.dim // 8, d_ff=4 * args.dim,
        vocab_size=args.vocab, act="swiglu", window=128, global_every=4,
        dtype="float32")
    n_params = cfg.param_count()
    print(f"model: {n_params/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model} V={cfg.vocab_size}) on {device}")

    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg)
    pipe = TokenPipeline(args.vocab, args.batch, args.seq, seed=0)

    opt = AdamW(lr=warmup_cosine(3e-4, 20, args.steps), weight_decay=0.01)
    step = make_train_step(
        lambda p, b: lm.lm_loss(p, b["tokens"], cfg, loss_chunk=128), opt)

    def batches(i: int) -> dict:
        return {"tokens": torch.as_tensor(pipe(i)["tokens"], device=device)}

    loop_cfg = TrainLoopConfig(n_steps=args.steps, ckpt_dir=args.ckpt,
                               ckpt_every=100, log_every=10)
    params, _, hist = run_loop(step, params, opt.init(params), batches,
                               loop_cfg, ef_state=init_ef(params),
                               data_state_fn=pipe.state)
    print(f"loss: {hist[0]:.3f} -> {hist[-1]:.3f} over {len(hist)} steps")
    assert hist[-1] < hist[0], "training failed to reduce loss"


if __name__ == "__main__":
    import logging
    logging.basicConfig(level=logging.INFO)
    main()
