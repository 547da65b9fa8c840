"""Train-step assembly (PyTorch port of ``repro.training.train_loop``):
loss -> grads -> (optional compression) -> optimizer, with
gradient-accumulation microbatching so the global batch is independent of
device memory, and a restartable outer loop with checkpoint/straggler
hooks (used by ``launch/train.py`` and the tests)."""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training.compression import EFState, compress, init_ef
from repro_torch.training.elastic import Action, StragglerMonitor
from repro_torch.tree import leaves, tree_map, unflatten

log = logging.getLogger("repro_torch.train")


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)`` by autograd, as
    ``jax.value_and_grad``: the loss detached, the grads a tree of
    ``params``' structure with a zero gradient for every leaf the loss does
    not reach.  ``params`` themselves are not touched."""
    ps = leaves(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in ps]
    loss = loss_fn(unflatten(params, live), batch)
    wrt = [p for p in live if p.requires_grad]
    got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), unflatten(params, grads)


def make_train_step(loss_fn: Callable, optimizer, *,
                    accum_steps: int = 1,
                    compress_frac: float | None = None) -> Callable:
    """loss_fn(params, batch) -> scalar.  Returns
    step(params, opt_state, ef_state, batch) ->
        (params, opt_state, ef_state, metrics).

    With accum_steps > 1 the batch's leading axis is split into
    ``accum_steps`` microbatches, run one after another; their losses and
    fp32 gradients are summed, then divided by ``accum_steps``."""

    def step(params, opt_state, ef_state, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = leaves(batch)[0].shape[0] // accum_steps
            loss = None
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(accum_steps):
                mb = tree_map(lambda x: x[i * n:(i + 1) * n], batch)
                li, gi = value_and_grad(loss_fn, params, mb)
                loss = li.float() if loss is None else loss + li
                for g, g_i in zip(leaves(grads), leaves(gi)):
                    g.add_(g_i)             # in place: the sums are ours
                del gi
            loss = loss / accum_steps
            for g in leaves(grads):
                g.div_(accum_steps)

        if compress_frac is not None:
            grads, ef_state = compress(grads, ef_state, compress_frac)
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = {"loss": loss}
        return params, opt_state, ef_state, metrics

    return step


@dataclass
class TrainLoopConfig:
    n_steps: int = 100
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    resume: bool = True


def run_loop(step_fn: Callable, params, opt_state, batches, cfg:
             TrainLoopConfig, *, ef_state: EFState | None = None,
             monitor: StragglerMonitor | None = None,
             data_state_fn: Callable[[int], dict] | None = None):
    """Restartable training loop.

    ``batches`` is a callable step -> batch (deterministic, so resuming at
    step k replays the exact data order).  Returns (params, opt_state,
    history).  On resume, the latest checkpoint's step is the start point
    and already-consumed data is skipped by construction; restored leaves
    land on the device and dtype of the ``params``/``opt_state`` given."""
    start = 0
    if cfg.resume and cfg.ckpt_dir:
        latest = ckpt_lib.latest_step(cfg.ckpt_dir)
        if latest is not None:
            (params, opt_state), start, _extra = ckpt_lib.restore(
                cfg.ckpt_dir, (params, opt_state))
            log.info("resumed from step %d", start)

    if ef_state is None:
        ef_state = init_ef(params)
    monitor = monitor or StragglerMonitor()
    history = []
    for step in range(start, cfg.n_steps):
        monitor.step_started()
        batch = batches(step)
        params, opt_state, ef_state, metrics = step_fn(
            params, opt_state, ef_state, batch)
        loss = float(metrics["loss"])
        history.append(loss)
        action = monitor.step_finished()
        if step % cfg.log_every == 0:
            log.info("step %d loss %.4f", step, loss)
        if cfg.ckpt_dir and ((step + 1) % cfg.ckpt_every == 0
                             or step + 1 == cfg.n_steps
                             or action != Action.CONTINUE):
            extra = data_state_fn(step + 1) if data_state_fn else {}
            ckpt_lib.save(cfg.ckpt_dir, step + 1, (params, opt_state),
                          extra=extra, keep_last=cfg.keep_last)
        if action == Action.CHECKPOINT_AND_SHRINK:
            log.warning("straggler policy tripped at step %d: checkpointed; "
                        "relaunch with a smaller world", step)
            break
        if action == Action.ABORT:
            raise RuntimeError(f"step {step} exceeded hang timeout")
    return params, opt_state, history
