"""Fault-tolerant checkpointing (PyTorch port of
``repro.training.checkpoint``, same on-disk layout).

Layout: ``<dir>/step_<n>/`` holding one ``.npy`` per leaf (keyed by its
flattened path) + ``meta.json`` (step, leaf manifest with per-leaf CRC32
checksums, caller's ``extra``).  Writes are atomic (tmp dir + rename) so a
crash mid-save never corrupts the latest checkpoint; ``keep_last`` prunes
old steps.

Leaf keys follow ``jax.tree_util``'s path names, so either package restores
the other's checkpoints: a ``NamedTuple`` field is ``.name`` (a ``CFState``
writes ``.ratings``, ``.norms``, ``.sim_vals``, ``.sim_idx``,
``.n_active``), a dict entry its key (dicts in sorted key order), a
list/tuple entry its index, joined by ``/``.  A Python ``int`` leaf (the
port's ``CFState.n_active``) is stored as a 0-d int32, as the JAX state
holds it; tensors are copied to the host, and bfloat16 persists as float32
plus a dtype tag.

Restore verifies every leaf against its recorded checksum: a torn or
bit-flipped leaf raises ``CorruptCheckpointError``, and the default
newest-first restore *falls back to the previous step* instead of loading
garbage — a corrupt checkpoint costs recency, never correctness.

Unlike the reference, ``save`` fsyncs every file and both directories
before it returns: the server truncates its WAL through a checkpoint right
after saving it, so a checkpoint still in the page cache would leave
nothing to recover from after a power loss.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.tree import is_namedtuple, unflatten

log = logging.getLogger(__name__)


class CorruptCheckpointError(RuntimeError):
    """A checkpoint leaf failed its CRC32 / load check."""


def _flatten(tree: Any, path: tuple = ()) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in ``jax.tree_util.tree_flatten_with_path`` order
    and naming."""
    if tree is None:
        return []
    if is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(path), tree)]
    out = []
    for name, sub in items:
        out.extend(_flatten(sub, path + (name,)))
    return out


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to write, dtype tag) for one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy(), "bfloat16"
        arr = t.cpu().numpy()
    elif isinstance(leaf, (bool, np.bool_)):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    dtype = str(arr.dtype)
    if arr.dtype.kind not in "fiub":
        arr = arr.astype(np.float32)
    return arr, dtype


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of the array's C-order bytes, read in place when the array is
    contiguous (no copy of a multi-gigabyte leaf)."""
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return zlib.crc32(memoryview(arr.reshape(-1)).cast("B"))


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:                     # not supported on this platform/fs
        pass


def _write_durably(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save(ckpt_dir: str, step: int, tree: Any,
         extra: dict | None = None, keep_last: int = 3) -> str:
    """Atomically persist ``tree`` (a ``CFState``, or any nest of
    NamedTuples, dicts, lists and tensors/arrays) at ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # Sweep stale tmp dirs from crashed saves (any step, not just ours):
    # discovery already ignores them (the step_<n> pattern excludes .tmp).
    for name in os.listdir(ckpt_dir):
        if re.fullmatch(r"step_\d+\.tmp", name):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp)

    manifest = {}
    for key, leaf in _flatten(tree):
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        arr, dtype = _to_numpy(leaf)
        _write_durably(os.path.join(tmp, fname), lambda f: np.save(f, arr))
        manifest[key] = {"file": fname, "dtype": dtype,
                         "crc32": _crc32(arr)}
        del arr
    meta = {"step": step, "manifest": manifest, "extra": extra or {}}
    _write_durably(os.path.join(tmp, "meta.json"),
                   lambda f: f.write(json.dumps(meta).encode()))
    _fsync_dir(tmp)
    if os.path.exists(final):
        # Re-save at an existing step (e.g. crash recovery converging on
        # the same sequence number): drop the old dir so the rename lands.
        shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)                  # atomic publish
    _fsync_dir(ckpt_dir)

    _prune(ckpt_dir, keep_last)
    return final


def _prune(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _as_template(arr: np.ndarray, tmpl: Any) -> Any:
    """A loaded leaf in the template leaf's kind: a tensor on the template
    tensor's device and dtype, a Python int, or a numpy array."""
    if isinstance(tmpl, torch.Tensor):
        return torch.as_tensor(arr).to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(tmpl, bool):
        return bool(arr)
    if isinstance(tmpl, int):
        return int(arr)
    if isinstance(tmpl, float):
        return float(arr)
    if hasattr(tmpl, "dtype"):
        return arr.astype(tmpl.dtype)
    return arr


def _restore_step(ckpt_dir: str, template: Any,
                  step: int) -> tuple[Any, int, dict]:
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CorruptCheckpointError(f"{d}: unreadable meta.json: {e!r}")
    manifest = meta["manifest"]

    leaves = []
    for key, tmpl in _flatten(template):
        entry = manifest[key]
        fname = entry["file"] if isinstance(entry, dict) else entry
        try:
            arr = np.load(os.path.join(d, fname))
        except (OSError, ValueError) as e:           # missing or torn .npy
            raise CorruptCheckpointError(f"{d}: leaf {key!r} "
                                         f"unloadable: {e!r}")
        if isinstance(entry, dict) and "crc32" in entry:
            got = _crc32(arr)
            if got != entry["crc32"]:
                raise CorruptCheckpointError(
                    f"{d}: leaf {key!r} checksum mismatch "
                    f"(got {got:#010x}, want {entry['crc32']:#010x})")
        leaves.append(_as_template(arr, tmpl))
        del arr
    tree = unflatten(template, leaves)
    return tree, meta["step"], meta.get("extra", {})


def restore(ckpt_dir: str, template: Any,
            step: int | None = None) -> tuple[Any, int, dict]:
    """Load into the structure of ``template``; each tensor leaf lands on
    its template leaf's device and dtype (shapes come from the files, so an
    empty tensor is template enough).

    With ``step=None`` (the default), tries the newest step first and
    falls back to earlier steps if a leaf fails its CRC32 check; raises
    ``CorruptCheckpointError`` only when *every* step is corrupt.  An
    explicit ``step`` is loaded strictly — corruption raises."""
    if step is not None:
        return _restore_step(ckpt_dir, template, step)
    steps = all_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    last_err: CorruptCheckpointError | None = None
    for s in reversed(steps):
        try:
            return _restore_step(ckpt_dir, template, s)
        except CorruptCheckpointError as e:
            log.warning("checkpoint step %d corrupt, falling back to the "
                        "previous step: %s", s, e)
            last_err = e
    raise CorruptCheckpointError(
        f"all {len(steps)} checkpoints under {ckpt_dir} are corrupt "
        f"(last error: {last_err})")
