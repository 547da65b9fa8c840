"""Port parity of ``repro_torch.data.recsys_stream``: ``CTRStream`` and
``TwoTowerStream`` give the reference's batches bit for bit (keys, dtypes,
shapes, values) for several configs, seeds and steps, including a replay
of a step after others (stateless generation)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.data import recsys_stream as jrs
from repro_torch.data import recsys_stream as trs
from tests.conftest import reduced_spec

torch.set_num_threads(2)


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("arch", ["xdeepfm", "autoint", "bst"])
def test_ctr_stream_bit_identical(arch, seed):
    cfg = reduced_spec(arch).config
    got, want = trs.CTRStream(cfg, 48, seed), jrs.CTRStream(cfg, 48, seed)
    for step in (0, 1, 5, 1):
        _same(got(step), want(step))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_two_tower_stream_bit_identical(seed):
    cfg = reduced_spec("two-tower-retrieval").config
    got = trs.TwoTowerStream(cfg, 40, seed)
    want = jrs.TwoTowerStream(cfg, 40, seed)
    for step in (0, 2, 9, 0):
        _same(got(step), want(step))


@pytest.mark.parametrize("arch", ["xdeepfm", "two-tower-retrieval"])
def test_streams_at_the_registered_widths(arch):
    from repro.configs import get_arch as jget
    from repro_torch.configs import get_arch
    cfg, jcfg = get_arch(arch).config, jget(arch).config
    cls = "TwoTowerStream" if cfg.variant == "two_tower" else "CTRStream"
    _same(getattr(trs, cls)(cfg, 64, 2)(3), getattr(jrs, cls)(jcfg, 64,
                                                               2)(3))
