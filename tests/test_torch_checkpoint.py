"""The port's checkpoints (``repro_torch.training.checkpoint``): ports of
``TestCheckpointCRC`` from ``tests/test_resilience.py``, the layout details
(leaf keys, stale tmp sweep, ``keep_last``), and the cross-package
contract — a ``CFState`` checkpoint written by either package is restored
by the other.

Tolerance: none.  Leaves are raw ``.npy`` bytes: every restored leaf must
equal the saved one exactly, in value and dtype.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.training import checkpoint as jckpt
from repro_torch.bridge import state_from_numpy, state_to_numpy
from repro_torch.core import CFState, build_state
from repro_torch.training import checkpoint
from tests.conftest import make_ratings

torch.set_num_threads(2)

CFSTATE_KEYS = {".ratings", ".norms", ".sim_vals", ".sim_idx", ".n_active"}


def _tree(rng, shift=0.0):
    return {"a": torch.as_tensor(rng.normal(size=(8, 8)) + shift,
                                 dtype=torch.float32),
            "b": torch.arange(16, dtype=torch.int32)}


def _corrupt_leaf(ckpt_dir, step, fname="a.npy"):
    path = os.path.join(ckpt_dir, f"step_{step:010d}", fname)
    with open(path, "r+b") as f:
        f.seek(-4, os.SEEK_END)                # flip data bytes, keep
        f.write(b"\xde\xad\xbe\xef")           # the .npy header valid


class TestCheckpointCRC:
    def test_corrupt_leaf_falls_back_to_previous_step(self, tmp_path, rng):
        d = str(tmp_path)
        t1, t2 = _tree(rng), _tree(rng, shift=1.0)
        checkpoint.save(d, 1, t1)
        checkpoint.save(d, 2, t2)
        _corrupt_leaf(d, 2)
        tree, step, _ = checkpoint.restore(d, t1)
        assert step == 1                       # newest was corrupt
        assert torch.equal(tree["a"], t1["a"])
        assert torch.equal(tree["b"], t1["b"])

    def test_explicit_step_raises_on_corruption(self, tmp_path, rng):
        d = str(tmp_path)
        t = _tree(rng)
        checkpoint.save(d, 1, t)
        _corrupt_leaf(d, 1)
        with pytest.raises(checkpoint.CorruptCheckpointError):
            checkpoint.restore(d, t, step=1)

    def test_all_corrupt_raises(self, tmp_path, rng):
        d = str(tmp_path)
        t = _tree(rng)
        checkpoint.save(d, 1, t)
        checkpoint.save(d, 2, t)
        _corrupt_leaf(d, 1)
        _corrupt_leaf(d, 2)
        with pytest.raises(checkpoint.CorruptCheckpointError):
            checkpoint.restore(d, t)

    def test_missing_leaf_file_is_corruption(self, tmp_path, rng):
        d = str(tmp_path)
        t = _tree(rng)
        checkpoint.save(d, 1, t)
        checkpoint.save(d, 2, t)
        os.remove(os.path.join(d, "step_0000000002", "a.npy"))
        _, step, _ = checkpoint.restore(d, t)
        assert step == 1


def test_layout_prune_and_stale_tmp_sweep(tmp_path, rng):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_0000000009.tmp"))   # a crashed save
    for s in (1, 2, 3, 4):
        checkpoint.save(d, s, _tree(rng), extra={"s": s}, keep_last=2)
    assert sorted(os.listdir(d)) == ["step_0000000003", "step_0000000004"]
    assert checkpoint.all_steps(d) == [3, 4]
    assert checkpoint.latest_step(d) == 4
    with open(os.path.join(d, "step_0000000004", "meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 4 and meta["extra"] == {"s": 4}
    assert set(meta["manifest"]) == {"a", "b"}
    assert meta["manifest"]["b"]["dtype"] == "int32"
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), _tree(rng))


def test_cfstate_round_trip_and_leaf_keys(tmp_path, rng):
    st = build_state(torch.as_tensor(make_ratings(rng, n=30, m=12)),
                     capacity_extra=5)
    d = str(tmp_path)
    checkpoint.save(d, 7, st, extra={"n_base": 30})
    with open(os.path.join(d, "step_0000000007", "meta.json")) as f:
        manifest = json.load(f)["manifest"]
    assert set(manifest) == CFSTATE_KEYS
    assert manifest[".n_active"]["dtype"] == "int32"
    assert np.load(os.path.join(d, "step_0000000007",
                                ".n_active.npy")).shape == ()
    template = CFState(*(torch.empty(0, dtype=t.dtype) for t in st[:4]), 0)
    out, step, extra = checkpoint.restore(d, template)
    assert (step, extra) == (7, {"n_base": 30})
    assert out.n_active == st.n_active == 30
    for a, b in zip(out[:4], st[:4]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _jnp_state(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cfstate_checkpoint_across_packages(tmp_path, rng, direction):
    R = make_ratings(rng, n=40, m=14)
    js = jbuild(jnp.asarray(R), capacity_extra=6)
    ref = _jnp_state(js)
    d = str(tmp_path)
    extra = {"n_base": 40, "wal_seq": 3}
    if direction == "jax_to_port":
        jckpt.save(d, 3, js, extra=extra)
        template = CFState(*(torch.empty(0, dtype=dt) for dt in (
            torch.float32, torch.float32, torch.float32, torch.int32)), 0)
        out, step, got = checkpoint.restore(d, template)
        out = state_to_numpy(out)
    else:
        checkpoint.save(d, 3, state_from_numpy(ref, device="cpu"),
                        extra=extra)
        tree, step, got = jckpt.restore(d, js)
        out = _jnp_state(tree)
        assert tree.n_active.dtype == jnp.int32
    assert step == 3 and got == extra
    for key in ("ratings", "norms", "sim_vals", "sim_idx", "n_active"):
        assert out[key].dtype == ref[key].dtype, key
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
