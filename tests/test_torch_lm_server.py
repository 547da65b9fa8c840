"""Port parity of ``repro_torch.serving.LMServer`` against
``repro.serving.LMServer``: both servers get the reference's float32
params of a reduced LM config (``tests/conftest.py::reduced_spec``; the
port's carried with ``bridge.params_from_numpy(device="cpu")``) and the
same batch of prompts with repeats.  ``generate`` must give equal
completions (greedy, so exact) and an equal ``info`` with dedup on and
off; with dedup the repeats share their completions, and for the dense
models the completions with and without dedup are equal.  For the MoE
models (olmoe, llama4-scout) they differ in both packages alike: an
expert's capacity follows the batch's token count, so collapsing twins
changes which choices overflow (a reference quirk; at capacity factor 100
the two agree).  Prompts of 12 tokens
(longer than the reduced window, 8) for the five LM architectures, and
of 4 tokens (shorter: the ring's negative positions) for gemma3-1b.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.models import transformer as jlm
from repro.serving import LMServer as JLMServer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.models import transformer as tlm
from repro_torch.serving import LMServer
from tests.conftest import reduced_spec

torch.set_num_threads(2)

ARCHS = ("gemma3-1b", "gemma-7b", "granite-20b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e")


def _configs(arch):
    j = dataclasses.replace(reduced_spec(arch).config, dtype="float32")
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    if j.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(j.moe))
    return j, LMConfig(**kw)


@pytest.mark.parametrize("arch,S", [(a, 12) for a in ARCHS] +
                         [("gemma3-1b", 4)])
def test_generate_matches_reference(arch, S):
    jcfg, cfg = _configs(arch)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jsrv, srv = JLMServer(jparams, jcfg, max_len=32), LMServer(params, cfg,
                                                               max_len=32)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
    batch = prompts[[0, 1, 0, 2, 1]]
    outs = {}
    for dedup in (True, False):
        got, info = srv.generate(batch, n_new=5, dedup=dedup)
        want, jinfo = jsrv.generate(batch, n_new=5, dedup=dedup)
        assert got.dtype == np.int32 and got.shape == (5, 5)
        assert np.array_equal(got, want)
        assert info == jinfo
        outs[dedup] = got
    if cfg.moe is None:
        assert np.array_equal(outs[True], outs[False])
    assert np.array_equal(outs[True][0], outs[True][2])
    assert np.array_equal(outs[True][1], outs[True][4])


def test_dedup_info_and_greedy_flag():
    """The reference's ``TestLMServer`` case on the port: 4 prompts, 2
    distinct, prefill 2 rows and save half; ``greedy=False`` only turns
    dedup off (decoding stays greedy, as in the reference)."""
    _, cfg = _configs("gemma3-1b")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    srv = LMServer(params, cfg, max_len=64)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = prompts[[0, 1, 0, 0]]
    out_dedup, info = srv.generate(batch, n_new=4, dedup=True)
    out_full, full = srv.generate(batch, n_new=4, dedup=False)
    out_ng, ng = srv.generate(batch, n_new=4, greedy=False)
    assert info == {"prefill_rows": 2, "batch": 4, "dedup_savings": 0.5}
    assert full == ng == {"prefill_rows": 4, "batch": 4,
                          "dedup_savings": 0.0}
    assert np.array_equal(out_dedup, out_full)
    assert np.array_equal(out_dedup, out_ng)
    assert np.array_equal(out_dedup[0], out_dedup[2])


def test_generate_refuses_more_than_max_len():
    _, cfg = _configs("granite-20b")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    srv = LMServer(params, cfg, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        srv.generate(np.zeros((1, 12), np.int32), n_new=5)
    assert srv.device.type == "cpu"


def test_moe_dedup_agrees_when_nothing_overflows():
    """The quirk's cause: at capacity factor 100 no choice is dropped, and
    olmoe's completions with and without dedup are equal."""
    _, cfg = _configs("olmoe-1b-7b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=100.0))
    srv = LMServer(tlm.init_params(torch.Generator().manual_seed(0), cfg),
                   cfg, max_len=32)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 12)).astype(np.int32)
    batch = prompts[[0, 1, 0, 2, 1]]
    assert np.array_equal(srv.generate(batch, 5, dedup=True)[0],
                          srv.generate(batch, 5, dedup=False)[0])
