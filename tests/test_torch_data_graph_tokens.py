"""Port parity: the port's own copies of the graph and token data
(``repro_torch.data.graph``, ``repro_torch.data.tokens``) give the
reference's arrays for the same seeds: ``random_graph``, ``cora_like``,
``molecule_batch``, ``CSR``, ``NeighborSampler`` and ``TokenPipeline``,
whose restart at step k replays the same stream."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data import graph as jgraph
from repro.data import tokens as jtokens
from repro_torch.data import graph as tgraph
from repro_torch.data import tokens as ttokens

torch.set_num_threads(2)


def _equal_dicts(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed,n,e,power,loops", [
    (0, 50, 200, 1.2, True), (1, 300, 1000, 0.8, False),
    (2, 2708, 10_556, 1.2, True)])
def test_random_graph(seed, n, e, power, loops):
    got = tgraph.random_graph(seed, n, e, power, loops)
    want = jgraph.random_graph(seed, n, e, power, loops)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_cora_like(seed):
    _equal_dicts(tgraph.cora_like(seed), jgraph.cora_like(seed))


@pytest.mark.parametrize("seed,batch,n,e,d,c", [(0, 4, 30, 64, 16, 2),
                                                (5, 9, 12, 20, 3, 4)])
def test_molecule_batch(seed, batch, n, e, d, c):
    _equal_dicts(tgraph.molecule_batch(seed, batch, n, e, d, c),
                 jgraph.molecule_batch(seed, batch, n, e, d, c))


def _csrs(seed, n=200, e=800):
    src, dst = jgraph.random_graph(seed, n, e, add_self_loops=False)
    isolated = np.isin(np.arange(n), src, invert=True).any()
    return (tgraph.CSR(src, dst, n), jgraph.CSR(src, dst, n), isolated)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr(seed):
    t, j, _ = _csrs(seed)
    np.testing.assert_array_equal(t.col, j.col)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    assert t.indptr.dtype == j.indptr.dtype and t.n_nodes == j.n_nodes


@pytest.mark.parametrize("seed,fanouts", [(0, (5, 3)), (1, (15, 10))])
def test_neighbor_sampler(seed, fanouts):
    t, j, isolated = _csrs(seed)
    assert isolated                      # the self-loop fallback runs
    ts = tgraph.NeighborSampler(t, fanouts, seed=seed)
    js = jgraph.NeighborSampler(j, fanouts, seed=seed)
    roots = np.random.default_rng(seed).choice(200, 16, replace=False)
    for step in (0, 1, 7):
        _equal_dicts(ts(step, roots), js(step, roots))


@pytest.mark.parametrize("vocab,batch,seq,seed", [(64, 3, 16, 0),
                                                  (1000, 4, 40, 7)])
def test_token_pipeline_and_restart_replay(vocab, batch, seq, seed):
    tp = ttokens.TokenPipeline(vocab, batch, seq, seed)
    jp = jtokens.TokenPipeline(vocab, batch, seq, seed)
    np.testing.assert_array_equal(tp._table, jp._table)
    stream = [tp(step) for step in range(5)]
    for step, got in enumerate(stream):
        _equal_dicts(got, jp(step))
    assert tp.state(3) == jp.state(3) == {"seed": seed, "next_step": 3}
    # A restart from the saved state replays the same stream.
    st = tp.state(3)
    again = ttokens.TokenPipeline(vocab, batch, seq, st["seed"])
    for step in range(st["next_step"], 5):
        _equal_dicts(again(step), stream[step])
