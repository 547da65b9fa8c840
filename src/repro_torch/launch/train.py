"""Training launcher of the port (``repro.launch.train`` on PyTorch).

Selects an architecture config, builds its train cell
(``launch.steps.build_cell``), materialises params and optimizer state as
zeros on the device, as the reference launcher does, and runs the
restartable loop with checkpointing and straggler monitoring.  On the card
by default; the tests pass ``--device cpu``.

  python -m repro_torch.launch.train --arch xdeepfm --shape train_batch \\
      --steps 100 --ckpt /ckpt/run1 [--resume] [--device cuda]
  python -m repro_torch.launch.train --arch gemma3-1b --shape train_4k

From zeros only the recsys models' wide branch and last biases receive
gradient, and an LM's gradients are all zero (the reference's start, kept:
ROADMAP, reference quirks).  ``--multi-pod`` and ``--debug-mesh`` name JAX
meshes, which the port does not have, and exit with a message; so does a
shape that is not a training shape.
"""
from __future__ import annotations

import argparse
import logging
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.core.types import require_device
from repro_torch.launch.steps import build_cell
from repro_torch.training import (StragglerMonitor, TrainLoopConfig,
                                  run_loop)
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.launch.train")


def make_batches(spec, shape, device: str | torch.device = "cuda"):
    """Deterministic host data pipeline per family, each batch moved to
    ``device``."""
    if spec.family == "lm":
        from repro_torch.data import TokenPipeline
        pipe = TokenPipeline(spec.config.vocab_size,
                             shape.dim("global_batch"),
                             shape.dim("seq_len"), seed=0)
        return lambda i: {"tokens": torch.as_tensor(pipe(i)["tokens"],
                                                    device=device)}
    if spec.family == "recsys":
        from repro_torch.data import CTRStream, TwoTowerStream
        cls = (TwoTowerStream if spec.config.variant == "two_tower"
               else CTRStream)
        stream = cls(spec.config, shape.dim("batch"), seed=0)
        return lambda i: {k: torch.as_tensor(v, device=device)
                          for k, v in stream(i).items()}
    raise ValueError(f"no training pipeline for family {spec.family}")


def _zeros(structs, device):
    """Zeros of each ``meta`` leaf's shape and dtype on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), structs)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--multi-pod", action="store_true",
                    help="a JAX mesh option; the port refuses it")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="a JAX mesh option; the port refuses it")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    return ap


def main(argv: list[str] | None = None):
    """Runs the loop; returns (params, opt_state, loss history)."""
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    for flag in ("multi_pod", "debug_mesh"):
        if getattr(args, flag):
            sys.exit(f"repro_torch.launch.train: --{flag.replace('_', '-')} "
                     "names a JAX mesh; the port runs on one card (or the "
                     "CPU) and has no meshes")
    spec = get_arch(args.arch)
    device = require_device(args.device, "repro_torch.launch.train")
    shape = spec.shape(args.shape)
    if not shape.kind.startswith("train"):
        sys.exit(f"repro_torch.launch.train: {args.arch}/{args.shape} is a "
                 f"{shape.kind} shape, not a train shape")
    cell = build_cell(spec, shape)
    pstructs, ostructs, _ = cell.args
    params, opt_state = _zeros(pstructs, device), _zeros(ostructs, device)

    batches = make_batches(spec, shape, device)
    monitor = StragglerMonitor()

    def wrapped(params, opt_state, ef, batch):
        params, opt_state, loss = cell.fn(params, opt_state, batch)
        return params, opt_state, ef, {"loss": loss}

    loop_cfg = TrainLoopConfig(n_steps=args.steps, ckpt_dir=args.ckpt,
                               resume=args.resume)
    out = run_loop(wrapped, params, opt_state, batches, loop_cfg,
                   monitor=monitor)
    log.info("done; straggler stats: %s", monitor.stats())
    return out


if __name__ == "__main__":
    main()
