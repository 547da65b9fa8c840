"""The seeded generator: shapes, the exact rating count, the per-user
floor, the value set, and the same matrix for the same seed; the
configurations' own sizes by arithmetic."""
import json

import pytest
import torch

from cfbench import data
from cfbench.bench import HERE

CONFIGS = sorted((HERE / "configs").glob("*.json"))


def small(name: str, **kw) -> dict:
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update({"n_users": 200, "n_items": 300, "n_ratings": 9000}, **kw)
    return cfg


@pytest.mark.parametrize("name", ["douban-32k", "ml20m-41k"])
def test_shape_count_floor_values(name):
    cfg = small(name)
    R = data.synth_ratings(cfg, 12345678901, "cpu")
    assert R.shape == (200, 300) and R.dtype == torch.float32
    assert int((R != 0).sum()) == 9000
    floor = min(cfg["min_per_user"], 9000 // 200)
    assert int((R != 0).sum(dim=1).min()) >= floor
    levels = set(data.rating_levels(cfg).tolist())
    assert set(R[R != 0].unique().tolist()) <= levels
    if cfg["rating_step"] == 0.5:
        assert any(v % 1 for v in R[R != 0].unique().tolist())


def test_same_seed_same_matrix_other_seed_other():
    cfg = small("douban-32k")
    a = data.synth_ratings(cfg, 2**40 + 7, "cpu")
    b = data.synth_ratings(cfg, 2**40 + 7, "cpu")
    c = data.synth_ratings(cfg, 2**40 + 8, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_floor_from_the_count_when_sparse():
    cfg = small("ml20m-41k", n_ratings=1000)       # 5 a user < floor 20
    R = data.synth_ratings(cfg, 3, "cpu")
    assert int((R != 0).sum()) == 1000
    assert int((R != 0).sum(dim=1).min()) >= 5


def test_popular_items_rated_more():
    cfg = small("douban-32k")
    R = data.synth_ratings(cfg, 5, "cpu")
    per_item = (R != 0).sum(dim=0).float()
    assert per_item[:30].mean() > 2 * per_item[-100:].mean()


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_config_sizes_by_arithmetic(path):
    cfg = json.loads(path.read_text())
    pub = cfg["published"]
    n, m, total = cfg["n_users"], cfg["n_items"], cfg["n_ratings"]
    assert m == pub["n_items"], "widths are never cut"
    assert total == int(pub["n_ratings"] * n / pub["n_users"]), "density kept"
    assert n * min(cfg["min_per_user"], total // n) <= total <= n * m
    cap = n + cfg["server"]["capacity_extra"]
    mem = cfg["memory"]
    # f32 ratings, and (N, N) f32 values plus int32 ids
    assert mem["capacity"] == cap
    assert mem["ratings_bytes"] == 4 * cap * m
    assert mem["lists_bytes"] == 8 * cap * cap
    assert mem["state_bytes"] == 4 * cap * m + 8 * cap * cap
    assert set(cfg["reduced"]) == {k for k in pub if pub[k] != cfg.get(k)
                                   and k != "n_ratings"}


def test_fresh_profiles_and_pool():
    cfg = small("douban-32k")
    gen = data.generator("cpu", 9)
    fresh = data.fresh_profiles(cfg, 7, gen, "cpu")
    per = max(8, int(0.002 * cfg["n_items"]))
    assert fresh.shape == (7, 300)
    assert ((fresh != 0).sum(dim=1) == per).all()
    assert set(fresh[fresh != 0].unique().tolist()) <= set(
        data.rating_levels(cfg).tolist())
    R = data.synth_ratings(cfg, 1, "cpu")
    pool = data.twin_pool(R, 16, 40, gen)
    assert pool.unique().numel() == 16
    assert ((R[pool] != 0).sum(dim=1) >= 40).all()


def test_arrivals_and_ranks_same_multiset_every_seed():
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    a = data.exponential_gaps(500, 70.0, 7.0, g1)
    b = data.exponential_gaps(500, 70.0, 7.0, g2)
    assert not torch.equal(a, b)
    assert torch.allclose(a.sort().values, b.sort().values)
    assert abs(float(a.sum()) - 7.0) < 1e-9
    r1 = data.zipf_ranks(1000, 50, 1.1, g1)
    r2 = data.zipf_ranks(1000, 50, 1.1, g2)
    assert torch.equal(r1.sort().values, r2.sort().values)
    assert int((r1 == 0).sum()) > int((r1 == 49).sum())


@pytest.mark.parametrize("arrivals", ["poisson", "periodic"])
def test_due_times_span_the_window(arrivals):
    mix = {"arrivals": arrivals, "rate_per_s": 4.0}
    due = data.due_times(mix, 200, 50.0, torch.Generator().manual_seed(3))
    assert len(due) == 200 and due[0] == 0.0
    assert all(b >= a for a, b in zip(due, due[1:]))
    assert 49.0 < due[-1] < 50.0
    if arrivals == "periodic":
        assert max(abs(b - a - 0.25) for a, b in zip(due, due[1:])) < 1e-9
    with pytest.raises(ValueError):
        data.due_times({"arrivals": "bursty", "rate_per_s": 4.0}, 5, 1.0,
                       torch.Generator())


def test_coo_round_trip():
    cfg = small("ml20m-41k")
    R = data.synth_ratings(cfg, 4, "cpu")
    assert torch.equal(data.dense_rows(data.to_coo(R), 200, 300, "cpu"), R)
