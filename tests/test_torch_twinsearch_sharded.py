"""Port parity: the sharded TwinSearch burst on ``torch.distributed``
(``core.twinsearch_sharded``) against the JAX reference's ``shard_map``
version, and against the port's own buffered burst.

  * World size 1, in this process (gloo over a ``HashStore``): against JAX
    ``onboard_batch_sharded`` on a one-device mesh, and bit for bit
    against the port's ``onboard_batch_buffered``, for both ``maintain``
    values.
  * World size 2, two spawned ranks (gloo over a ``FileStore``) against
    the JAX function on a 2-device host mesh in a subprocess (the device
    count must be set before JAX starts, as in ``tests/test_distributed.py``),
    including an arena with two copies of a row: the last shard's twin
    wins (``pmax``), where the buffered burst takes the lowest id.
  * The collective bytes per user, counted by wrapping the collectives,
    equal ``payload_bytes``, the figure the module's docstring states.
  * An uneven row split raises ``ValueError``; no process group raises
    ``RuntimeError``; ``onboard_batch_resilient`` heals a NaN row from its
    replicas bit for bit.

Tolerances: ``found``, ``twin_idx``, ``n_candidates`` and ``overflowed``
exact; lists within 2e-5 (``tests/test_distributed.py``'s bound), ids exact
except across near-ties (``bridge.lists_match``).  Every spawned process
is joined with a timeout and killed on expiry, so a hung rendezvous fails
the test instead of stalling the suite.  Probes come from JAX.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from repro.core import build_state as jbuild
from repro.core import twinsearch as jts
from repro.core import twinsearch_sharded as jsh
from repro.core.types import CFState as JState
from repro.distributed.replication import ReplicatedArena as JArena
from repro.distributed.replication import ReplicationConfig as JRepCfg
from repro.serving.guard import RetryPolicy as JRetry
from repro_torch.bridge import lists_match, state_from_numpy
from repro_torch.configs import get_arch
from repro_torch.core import onboard_batch_buffered, set0_cap
from repro_torch.core import twinsearch_sharded as tsh
from repro_torch.core.types import CFState
from repro_torch.distributed import (ReplicatedArena, ReplicationConfig,
                                     cf_shardings, local_state, mesh_axes,
                                     named)
from repro_torch.distributed.sharding import Rows
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.guard import RetryPolicy
from tests.conftest import make_ratings

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5
ARRAYS = ("ratings", "norms", "sim_vals", "sim_idx", "n_active")
STATS = ("found", "twin_idx", "n_candidates", "overflowed")
SPAWN_TIMEOUT_S = 240


@pytest.fixture
def group1():
    """A one-rank gloo process group in this process, torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _case(name: str) -> dict:
    """Base arena (built by JAX), burst and JAX probes for a named case."""
    if name == "duplicate_twin":
        rng = np.random.default_rng(11)
        R = make_ratings(rng, n=64, m=32)
        R[50] = R[10]
        R_new = np.stack([R[10], R[10]])
        c, seed = 4, 2
    else:
        n, m, c, seed = {"planted": (128, 32, 6, 1),
                         "wide_probes": (96, 24, 8, 4)}[name]
        rng = np.random.default_rng(seed)
        R = make_ratings(rng, n=n, m=m)
        fresh = make_ratings(np.random.default_rng(seed + 50), n=4, m=m)
        R_new = np.stack([R[17], fresh[0], R[17], fresh[0], R[3], fresh[1],
                          fresh[2], R[60], fresh[1], fresh[3]])
    n = R.shape[0]
    js = jbuild(jnp.asarray(R), capacity_extra=0)
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(seed),
                                        R_new.shape[0], c, n))
    out = {k: np.asarray(getattr(js, k)) for k in ARRAYS}
    out.update(R_new=R_new, probes=probes, s_max=np.int64(set0_cap(n)))
    return out


CASES = ("planted", "wide_probes", "duplicate_twin")


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


def _tstate(case) -> CFState:
    return state_from_numpy(case, "cpu")


def _jstate(case) -> JState:
    return JState(*(jnp.asarray(case[k]) for k in ARRAYS))


def _assert_stats(t_stats, j_stats) -> None:
    for name in STATS:
        np.testing.assert_array_equal(
            np.asarray(getattr(t_stats, name)),
            np.asarray(getattr(j_stats, name)), err_msg=name)


# ---------------------------------------------------------------------------
# World size 1, in process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maintain", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_one_rank_matches_jax_and_buffered(group1, cases, name, maintain):
    case = cases[name]
    s_max = int(case["s_max"])
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jout = jax.device_get(jsh.onboard_batch_sharded(
        _jstate(case), jnp.asarray(case["R_new"]),
        jnp.asarray(case["probes"]), s_max=s_max, axes=("data",), mesh=mesh,
        maintain=maintain))
    st = _tstate(case)
    tout = tsh.onboard_batch_sharded(
        local_state(st, 0, 1), torch.as_tensor(case["R_new"]),
        case["probes"], s_max=s_max, maintain=maintain)
    assert len(tout) == len(jout) == (4 if maintain else 3)
    _assert_stats(tout[2], jout[2])
    assert tout[1].dtype == torch.int32
    assert lists_match(jout[0], jout[1], tout[0].numpy(), tout[1].numpy(),
                       TOL) is None
    if maintain:
        (jmv, jmi), (tmv, tmi) = jout[3], tout[3]
        assert lists_match(jmv, jmi, tmv.numpy(), tmi.numpy(), TOL) is None
        n, k = st.capacity, case["R_new"].shape[0]
        for t in range(k):
            assert ((tmi.numpy() == n + t).sum(axis=1) == 1).all()
    # One rank holds every row: the buffered burst, bit for bit.
    bout = onboard_batch_buffered(st, torch.as_tensor(case["R_new"]),
                                  case["probes"], s_max=s_max,
                                  maintain=maintain)
    for name_ in STATS:
        assert torch.equal(getattr(tout[2], name_), getattr(bout[2], name_))
    assert torch.equal(tout[0], bout[0]) and torch.equal(tout[1], bout[1])
    if maintain:
        assert torch.equal(tout[3][0], bout[3][0])
        assert torch.equal(tout[3][1], bout[3][1])


def test_burst_covers_every_branch(group1, cases):
    case = cases["planted"]
    n = case["ratings"].shape[0]
    _, _, st = tsh.onboard_batch_sharded(
        local_state(_tstate(case), 0, 1), torch.as_tensor(case["R_new"]),
        case["probes"], s_max=int(case["s_max"]))
    found, twin = st.found.numpy(), st.twin_idx.numpy()
    assert (found & (twin < n)).any() and (found & (twin >= n)).any()
    assert (~found).any()


class _Counter:
    """Wraps the collectives the module calls and records the bytes of the
    tensor each is called with (a gather: its output)."""

    def __init__(self, monkeypatch):
        self.calls: list[tuple[str, int]] = []
        for name in ("all_reduce", "all_gather_into_tensor"):
            monkeypatch.setattr(dist, name,
                                self._wrap(name, getattr(dist, name)))

    def _wrap(self, name, fn):
        def counted(tensor, *args, **kwargs):
            self.calls.append((name, tensor.numel() * tensor.element_size()))
            return fn(tensor, *args, **kwargs)
        return counted

    @property
    def total(self) -> int:
        return sum(b for _, b in self.calls)


def _branch(found: bool, twin: int, n: int) -> str:
    return "fallback" if not found else ("base" if twin < n else "new")


@pytest.mark.parametrize("name", CASES)
def test_collective_bytes_per_user(group1, cases, monkeypatch, name):
    case = cases[name]
    st = _tstate(case)
    N, c = st.capacity, case["probes"].shape[1]
    counter = _Counter(monkeypatch)
    _, _, stats = tsh.onboard_batch_sharded(
        local_state(st, 0, 1), torch.as_tensor(case["R_new"]),
        case["probes"], s_max=int(case["s_max"]))
    branches = [_branch(f, t, N) for f, t in zip(stats.found.tolist(),
                                                 stats.twin_idx.tolist())]
    assert counter.total == sum(tsh.payload_bytes(N, c, b)
                                for b in branches)
    # The docstring's figure for a base twin, against the reference's
    # claim of about (c+2)·N·4.
    base = tsh.payload_bytes(N, c, "base")
    assert base == (2 * c + 2) * N * 4 + 4 * c + 16 > (c + 2) * N * 4


def test_one_user_at_a_time_bytes(group1, cases, monkeypatch):
    """Each branch alone: a base twin, a fresh user (the fallback), and a
    repeat of it (a twin inside the burst)."""
    case = cases["planted"]
    st = local_state(_tstate(case), 0, 1)
    N, c = st.capacity, case["probes"].shape[1]
    R_new = torch.as_tensor(case["R_new"])
    fresh = int(np.flatnonzero(
        ~np.all(case["R_new"][:, None] == case["ratings"][None], axis=2)
        .any(axis=1))[0])
    counter = _Counter(monkeypatch)
    tsh.onboard_batch_sharded(st, R_new[:1], case["probes"][:1],
                              s_max=int(case["s_max"]))
    assert counter.total == tsh.payload_bytes(N, c, "base")
    counter.calls.clear()
    pair = R_new[[fresh, fresh]]
    tsh.onboard_batch_sharded(st, pair, case["probes"][[fresh, fresh]],
                              s_max=int(case["s_max"]))
    assert counter.total == (tsh.payload_bytes(N, c, "fallback")
                             + tsh.payload_bytes(N, c, "new"))


def test_uneven_split_raises(group1, cases):
    st = _tstate(cases["planted"])            # 128 rows
    with pytest.raises(ValueError, match="evenly"):
        local_state(st, 0, 3)
    with pytest.raises(ValueError, match="evenly"):
        Rows(5).slice(128, 1)
    short = st._replace(ratings=st.ratings[:100], norms=st.norms[:100],
                        sim_vals=st.sim_vals[:100], sim_idx=st.sim_idx[:100])
    with pytest.raises(ValueError, match="rows"):
        tsh.onboard_batch_sharded(short, torch.as_tensor(
            cases["planted"]["R_new"]), cases["planted"]["probes"], s_max=8)


def test_no_process_group_raises(cases):
    assert not dist.is_initialized()
    case = cases["planted"]
    st = _tstate(case)
    with pytest.raises(RuntimeError, match="process group"):
        tsh.onboard_batch_sharded(st, torch.as_tensor(case["R_new"]),
                                  case["probes"], s_max=8)
    with pytest.raises(RuntimeError, match="process group"):
        tsh.onboard_batch_resilient(st, torch.as_tensor(case["R_new"]),
                                    case["probes"], s_max=8)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("kind", ["build", "onboard"])
def test_cf_shardings_rows(world, kind):
    """On a (world, 1) mesh (a fake process group) the arena's leaves split
    by even row slices over every axis; ``n_active``, the burst and its
    probes are replicated."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg = get_arch("twinsearch-cf").config
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = make_mesh((world, 1), ("data", "model"), device_type="cpu")
        spec = cf_shardings(cfg, mesh_axes(mesh), kind)
        with pytest.raises(ValueError):
            cf_shardings(cfg, mesh_axes(mesh), "train")
    finally:
        dist.destroy_process_group()
    n = 64
    if kind == "build":
        leaves = [spec["inputs"]["R"], *spec["out"]]
        replicated = []
    else:
        st = spec["inputs"]["state"]
        leaves = [st.ratings, st.norms, st.sim_vals, st.sim_idx]
        replicated = [st.n_active, spec["inputs"]["R_new"],
                      spec["inputs"]["probes"]]
    for leaf in leaves:
        sh = named(mesh, leaf)
        got = [sh.indices((n, n)[:len(leaf)], r)[0] for r in range(world)]
        assert got == [slice(r * n // world, (r + 1) * n // world)
                       for r in range(world)]
    for leaf in replicated:
        sh = named(mesh, leaf)
        assert all(s == slice(None) for r in range(world)
                   for s in sh.indices((n, n)[:len(leaf)], r))


def test_local_state_cuts_views(cases):
    st = _tstate(cases["planted"])
    parts = [local_state(st, r, 4) for r in range(4)]
    assert torch.equal(torch.cat([p.sim_vals for p in parts]), st.sim_vals)
    assert torch.equal(torch.cat([p.ratings for p in parts]), st.ratings)
    assert all(p.sim_vals.shape == (32, 128) for p in parts)
    assert parts[1].sim_idx.data_ptr() == st.sim_idx[32:].data_ptr()
    part = local_state(st._replace(n_active=40), 1, 4)
    assert part.n_active == 8


# ---------------------------------------------------------------------------
# onboard_batch_resilient
# ---------------------------------------------------------------------------

def _no_sleep_retry(cls):
    return cls(max_attempts=2, base_delay_s=1e-4, deadline_s=60.0,
               sleep=lambda s: None)


def test_resilient_heals_a_nan_row_bit_exact(group1, cases):
    case = cases["planted"]
    s_max = int(case["s_max"])
    st = _tstate(case)
    clean = st.sim_vals.clone()
    replicas = ReplicatedArena(st, ReplicationConfig(n_shards=4, r=2))
    st.sim_vals[5] = float("nan")                # a dead shard's garbage
    healed, (vals, idx, stats) = tsh.onboard_batch_resilient(
        st, torch.as_tensor(case["R_new"]), case["probes"], s_max=s_max,
        replicas=replicas, retry=_no_sleep_retry(RetryPolicy))
    assert replicas.repaired_rows == 1
    assert torch.equal(healed.sim_vals, clean)
    # The reference's wrapper on a one-device mesh, the same poison.
    jst = _jstate(case)
    jarena = JArena(jst, JRepCfg(n_shards=4, r=2))
    sv = case["sim_vals"].copy()
    sv[5] = np.nan
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jhealed, (jv, ji, jstats) = jsh.onboard_batch_resilient(
        jst._replace(sim_vals=jnp.asarray(sv)), jnp.asarray(case["R_new"]),
        jnp.asarray(case["probes"]), s_max=s_max, axes=("data",), mesh=mesh,
        replicas=jarena, retry=_no_sleep_retry(JRetry))
    assert jarena.repaired_rows == 1
    np.testing.assert_array_equal(np.asarray(jhealed.sim_vals),
                                  healed.sim_vals.numpy())
    _assert_stats(stats, jax.device_get(jstats))
    assert lists_match(np.asarray(jv), np.asarray(ji), vals.numpy(),
                       idx.numpy(), TOL) is None


def test_resilient_refuses_an_unrecoverable_row(group1, cases):
    case = cases["planted"]
    st = _tstate(case)
    replicas = ReplicatedArena(st, ReplicationConfig(n_shards=4, r=2))
    replicas.kill_node(0)
    replicas.kill_node(1)                         # both copies of shard 0
    st.sim_vals[5] = float("nan")
    before = st.sim_vals.clone()
    with pytest.raises(RuntimeError, match="unrecoverable"):
        tsh.onboard_batch_resilient(st, torch.as_tensor(case["R_new"]),
                                    case["probes"],
                                    s_max=int(case["s_max"]),
                                    replicas=replicas)
    # Nothing was written: the poisoned row is still NaN, the rest as it was.
    assert torch.isnan(st.sim_vals[5]).all()
    keep = torch.arange(st.capacity) != 5
    assert torch.equal(st.sim_vals[keep], before[keep])


# ---------------------------------------------------------------------------
# World size 2: spawned ranks against a 2-device JAX mesh
# ---------------------------------------------------------------------------

_JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.types import CFState
from repro.core.twinsearch import onboard_batch_buffered
from repro.core.twinsearch_sharded import onboard_batch_sharded
src, dst = sys.argv[1], sys.argv[2]
data = np.load(src)
names = sorted({k.split("/")[0] for k in data.files})
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
out = {}
for name in names:
    g = lambda k: data[f"{name}/{k}"]
    st = CFState(*(jnp.asarray(g(k)) for k in
                   ("ratings", "norms", "sim_vals", "sim_idx", "n_active")))
    args = (st, jnp.asarray(g("R_new")), jnp.asarray(g("probes")))
    s_max = int(g("s_max"))
    for maintain in (False, True):
        res = jax.device_get(onboard_batch_sharded(
            *args, s_max=s_max, axes=("data",), mesh=mesh,
            maintain=maintain))
        tag = f"{name}/m{int(maintain)}"
        out[f"{tag}/vals"], out[f"{tag}/idx"] = res[0], res[1]
        for f in ("found", "twin_idx", "n_candidates", "overflowed"):
            out[f"{tag}/{f}"] = np.asarray(getattr(res[2], f))
        if maintain:
            out[f"{tag}/mvals"], out[f"{tag}/midx"] = res[3]
    bt = jax.device_get(onboard_batch_buffered(*args, s_max=s_max)[2])
    out[f"{name}/buffered_twin"] = np.asarray(bt.twin_idx)
np.savez(dst, **out)
"""

_RANK_SCRIPT = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.bridge import state_from_numpy
from repro_torch.core.twinsearch_sharded import onboard_batch_sharded
from repro_torch.distributed import local_state
src, store_path, rank, dst = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
data = np.load(src)
names = sorted({k.split("/")[0] for k in data.files})
out = {}
for name in names:
    g = {k.split("/", 1)[1]: data[k] for k in data.files
         if k.startswith(name + "/")}
    st = local_state(state_from_numpy(g, "cpu"), rank, 2)
    for maintain in (False, True):
        res = onboard_batch_sharded(st, torch.as_tensor(g["R_new"]),
                                    g["probes"], s_max=int(g["s_max"]),
                                    maintain=maintain)
        tag = f"{name}/m{int(maintain)}"
        out[f"{tag}/vals"], out[f"{tag}/idx"] = res[0].numpy(), \
            res[1].numpy()
        for f in ("found", "twin_idx", "n_candidates", "overflowed"):
            out[f"{tag}/{f}"] = getattr(res[2], f).numpy()
        if maintain:
            out[f"{tag}/mvals"] = res[3][0].numpy()
            out[f"{tag}/midx"] = res[3][1].numpy()
dist.destroy_process_group()
np.savez(dst, **out)
"""


def _run_all(procs: list[subprocess.Popen], timeout_s: float) -> list[str]:
    """Join every process within ``timeout_s``; kill them all on expiry
    (a hung rendezvous) and fail.  Returns each one's stderr."""
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout_s)
            errs.append(err)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"spawned processes did not finish in {timeout_s} s")
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return errs


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    """Every case through the JAX 2-device mesh and through two gloo
    ranks, all four processes at once."""
    tmp = tmp_path_factory.mktemp("sharded2")
    src = tmp / "inputs.npz"
    np.savez(src, **{f"{name}/{k}": v for name, case in cases.items()
                     for k, v in case.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jdst = tmp / "jax.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(src), str(jdst)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, cwd=str(ROOT))]
    store = tmp / "store"
    for rank in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_SCRIPT, str(src), str(store),
             str(rank), str(tmp / f"rank{rank}.npz")], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            cwd=str(ROOT)))
    _run_all(procs, SPAWN_TIMEOUT_S)
    return (dict(np.load(jdst)),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)])


@pytest.mark.parametrize("maintain", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_jax_two_devices(two_ranks, name, maintain):
    jout, ranks = two_ranks
    tag = f"{name}/m{int(maintain)}"
    for r, tout in enumerate(ranks):
        for f in STATS:
            np.testing.assert_array_equal(tout[f"{tag}/{f}"],
                                          jout[f"{tag}/{f}"],
                                          err_msg=f"rank {r} {f}")
        # Every rank returns the same burst lists.
        assert lists_match(jout[f"{tag}/vals"], jout[f"{tag}/idx"],
                           tout[f"{tag}/vals"], tout[f"{tag}/idx"],
                           TOL) is None
    for f in ("vals", "idx"):
        np.testing.assert_array_equal(ranks[0][f"{tag}/{f}"],
                                      ranks[1][f"{tag}/{f}"])
    if maintain:
        mv = np.concatenate([t[f"{tag}/mvals"] for t in ranks])
        mi = np.concatenate([t[f"{tag}/midx"] for t in ranks])
        assert lists_match(jout[f"{tag}/mvals"], jout[f"{tag}/midx"], mv,
                           mi, TOL) is None
        n, k = mv.shape[0], jout[f"{tag}/found"].shape[0]
        for t in range(k):
            assert ((mi == n + t).sum(axis=1) == 1).all()


def test_two_ranks_last_shard_twin_wins(two_ranks):
    """R[50] = R[10] in a 64-row arena: shard 0 verifies 10, shard 1
    verifies 50, and MAX across the ranks picks 50, as the reference's
    ``pmax``; the buffered burst takes the lowest id, 10."""
    jout, ranks = two_ranks
    for maintain in (0, 1):
        tag = f"duplicate_twin/m{maintain}"
        assert jout[f"{tag}/twin_idx"].tolist() == [50, 50]
        for tout in ranks:
            assert tout[f"{tag}/twin_idx"].tolist() == [50, 50]
            assert tout[f"{tag}/found"].all()
    assert jout["duplicate_twin/buffered_twin"].tolist() == [10, 10]
