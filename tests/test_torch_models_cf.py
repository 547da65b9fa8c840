"""Port parity: the CF model family (``repro_torch.models.cf``) against
``repro.models.cf``.

  * ``build_step`` in float32 and bfloat16: sorted values within 1e-5, ids
    exact except across near-ties within it (``bridge.lists_match``);
  * ``onboard_step`` with ``distributed`` off (the buffered burst) and on
    (the sharded burst, one gloo rank, against the reference's
    ``mesh_info`` path on a one-device mesh): flags exact, lists within
    2e-5;
  * ``onboard_traditional_step``: lists within 1e-6;
  * ``state_structs`` and ``input_structs`` on the meta device: the
    reference's shapes and dtypes for all four ``CF_SHAPES``.
Probes come from JAX."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.configs import get_arch as jget_arch
from repro.configs.base import CF_SHAPES as JCF_SHAPES
from repro.core import build_state as jbuild
from repro.core import twinsearch as jts
from repro.models import cf as jcf
from repro_torch.bridge import lists_match, state_from_numpy
from repro_torch.configs import get_arch
from repro_torch.configs.base import CF_SHAPES
from repro_torch.distributed import local_state
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import cf
from tests.conftest import make_ratings

torch.set_num_threads(2)

STATS = ("found", "twin_idx", "n_candidates", "overflowed")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed,n,m", [(0, 96, 40), (1, 130, 57),
                                      (2, 300, 120)])
def test_build_step_matches_reference(dtype, seed, n, m):
    jd, td = DTYPES[dtype]
    R = make_ratings(np.random.default_rng(seed), n=n, m=m)
    R[n - 1] = R[5]                                   # an exact tie
    jv, ji = jcf.build_step(jnp.asarray(R, dtype=jd))
    tv, ti = cf.build_step(torch.as_tensor(R).to(td))
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tv.shape == ti.shape == (n, n)
    assert lists_match(_np(jv), _np(ji), tv.numpy(), ti.numpy(),
                       1e-5) is None
    assert (torch.diff(tv, dim=1) >= 0).all()


def test_build_step_sorts_in_row_slices(monkeypatch):
    """Sorted in slices of a few rows, the lists equal one sort over all
    rows, bit for bit."""
    R = torch.as_tensor(make_ratings(np.random.default_rng(4), n=70, m=30))
    whole = cf.build_step(R)
    monkeypatch.setattr(cf, "SORT_CHUNK_ROWS", 9)
    sliced = cf.build_step(R)
    assert torch.equal(whole[0], sliced[0])
    assert torch.equal(whole[1], sliced[1])


def _burst_case(seed, n=96, m=32, c=8):
    rng = np.random.default_rng(seed)
    R = make_ratings(rng, n=n, m=m)
    fresh = make_ratings(np.random.default_rng(seed + 7), n=3, m=m)
    R_new = np.stack([R[4], fresh[0], R[40], fresh[0], fresh[1], R[4],
                      fresh[2]])
    js = jbuild(jnp.asarray(R), capacity_extra=0)
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(seed),
                                        R_new.shape[0], c, n))
    arrays = {k: np.asarray(getattr(js, k)) for k in
              ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}
    return js, arrays, R_new, probes


@pytest.fixture
def group1():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _assert_burst(jout, tout):
    jv, ji, jst = jax.device_get(jout[:3])
    tv, ti, tst = tout[:3]
    for name in STATS:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert lists_match(jv, ji, tv.numpy(), ti.numpy(), 2e-5) is None


@pytest.mark.parametrize("seed", [0, 3])
def test_onboard_step_buffered(seed):
    cfg, jcfg = get_arch("twinsearch-cf").config, \
        jget_arch("twinsearch-cf").config
    js, arrays, R_new, probes = _burst_case(seed)
    jout = jcf.onboard_step(js, jnp.asarray(R_new), jnp.asarray(probes),
                            jcfg)
    tout = cf.onboard_step(state_from_numpy(arrays, "cpu"),
                           torch.as_tensor(R_new), probes, cfg)
    _assert_burst(jout, tout)
    assert bool(tout[2].found.any()) and not bool(tout[2].found.all())


@pytest.mark.parametrize("seed", [0, 3])
def test_onboard_step_distributed(group1, seed):
    cfg, jcfg = get_arch("twinsearch-cf").config, \
        jget_arch("twinsearch-cf").config
    js, arrays, R_new, probes = _burst_case(seed)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jout = jcf.onboard_step(js, jnp.asarray(R_new), jnp.asarray(probes),
                            jcfg, mesh_info=(("data",), mesh))
    local = local_state(state_from_numpy(arrays, "cpu"), 0, 1)
    tmesh = make_mesh((1,), ("data",), device_type="cpu")
    tout = cf.onboard_step(local, torch.as_tensor(R_new), probes, cfg,
                           mesh_info=(("data",), tmesh))
    _assert_burst(jout, tout)
    buffered = cf.onboard_step(state_from_numpy(arrays, "cpu"),
                               torch.as_tensor(R_new), probes, cfg)
    assert torch.equal(tout[0], buffered[0])
    assert torch.equal(tout[1], buffered[1])


def test_onboard_step_distributed_needs_a_group():
    cfg = get_arch("twinsearch-cf").config
    _, arrays, R_new, probes = _burst_case(0)
    with pytest.raises(RuntimeError, match="process group"):
        cf.onboard_step(state_from_numpy(arrays, "cpu"),
                        torch.as_tensor(R_new), probes, cfg,
                        mesh_info=(("data",), None))


@pytest.mark.parametrize("seed,n,m,k", [(0, 60, 24, 5), (1, 90, 33, 8)])
def test_onboard_traditional_step(seed, n, m, k):
    rng = np.random.default_rng(seed)
    R = make_ratings(rng, n=n, m=m)
    R_new = np.concatenate([R[[3, 9]], make_ratings(rng, n=k - 2, m=m)])
    js = jbuild(jnp.asarray(R), capacity_extra=k)
    arrays = {f: np.asarray(getattr(js, f)) for f in
              ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}
    jv, ji = jcf.onboard_traditional_step(js, jnp.asarray(R_new))
    tv, ti = cf.onboard_traditional_step(state_from_numpy(arrays, "cpu"),
                                         torch.as_tensor(R_new))
    assert tv.shape == ti.shape == (k, n + k)
    assert lists_match(_np(jv), _np(ji), tv.numpy(), ti.numpy(),
                       1e-6) is None


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape_name", [s.name for s in JCF_SHAPES])
def test_input_structs_match_reference(shape_name):
    cfg, jcfg = get_arch("twinsearch-cf").config, \
        jget_arch("twinsearch-cf").config
    got = cf.input_structs(cfg, get_arch("twinsearch-cf").shape(shape_name))
    want = jcf.input_structs(jcfg,
                             jget_arch("twinsearch-cf").shape(shape_name))
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        leaves = (zip(g, w) if key == "state" else [(g, w)])
        for a, b in leaves:
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape), key
            assert _dt(a) == str(b.dtype), key


@pytest.mark.parametrize("n_base,m,k", [(512, 64, 0), (100, 7, 30)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_state_structs_match_reference(n_base, m, k, dtype):
    jd, td = DTYPES[dtype]
    got = cf.state_structs(n_base, m, k, td)
    want = jcf.state_structs(n_base, m, k, jd)
    for a, b in zip(got, want):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert _dt(a) == str(b.dtype)
    assert got.capacity == n_base + k


def test_cf_shape_names_are_the_reference():
    assert [s.name for s in CF_SHAPES] == [s.name for s in JCF_SHAPES]
