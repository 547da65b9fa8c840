"""The harness's judgement with the timed path broken underneath.

Each test drives a whole run of a cell at a tiny size on the CPU (the
look for a chip is ``main``'s, and is skipped here), with one fault
planted in the program, and sees ``correct`` come out false.  The faults
are the ones these cells can have: a step that returns its state
unchanged, half of a batch left out and the mean of the rest in its
place, and an answer altered where it is produced.  (No cell spans
chips, so no exchange between chips can be left out.)"""
import pytest
import torch

from cfbench.bench import load_cell
from cfbench.run import run_cell

CELLS = ("douban-onboard", "douban-onboard-fresh", "ml20m-onboard",
         "douban-read", "douban-build")


def run(cell_name, tiny, seed=77):
    cell = load_cell(cell_name, overrides=tiny)
    result, _, checks = run_cell(cell, seed, 1.0, False, "cpu")
    return result, {c.name: c for c in checks}


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_run_is_correct(cell_name, tiny):
    result, checks = run(cell_name, tiny)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def test_onboard_state_unchanged(tiny, monkeypatch):
    """An onboard that appends the user but never writes its lists."""
    from repro_torch.core import baseline

    def unchanged(state, r0, vals, idx):
        slot = state.n_active
        state.ratings[slot] = r0.float()
        state.norms[slot] = torch.linalg.vector_norm(r0.float())
        return state._replace(n_active=slot + 1)

    monkeypatch.setattr(baseline, "append_user", unchanged)
    result, checks = run("douban-onboard", tiny)
    assert not result["correct"]
    assert not checks["list_id_rows"].ok


def test_onboard_answer_altered(tiny, monkeypatch):
    """An onboard whose list's top value is off by 1e-3."""
    from repro_torch.core import baseline
    sound = baseline.append_user

    def altered(state, r0, vals, idx):
        vals = vals.clone()
        vals[-1] += 1e-3
        return sound(state, r0, vals, idx)

    monkeypatch.setattr(baseline, "append_user", altered)
    result, checks = run("ml20m-onboard", tiny)
    assert not result["correct"]
    assert not checks["sim_gap"].ok


def _half_mean_topn(sound):
    def half(ratings, w, nbrs, users, n_rec=10):
        h = max(1, users.shape[0] // 2)
        vals, items = sound(ratings, w[:h], nbrs[:h], users[:h], n_rec)
        if users.shape[0] > h:
            fill = vals.mean(dim=0, keepdim=True).expand(
                users.shape[0] - h, -1)
            vals = torch.cat([vals, fill])
            items = torch.cat([items, items[:1].expand(
                users.shape[0] - h, -1)])
        return vals, items
    return half


def test_read_half_the_batch(tiny, monkeypatch):
    """Scores for half the unique rows; the mean of theirs for the rest."""
    from repro_torch.serving import cf_server
    monkeypatch.setattr(cf_server, "knn_recommend_topn",
                        _half_mean_topn(cf_server.knn_recommend_topn))
    result, checks = run("douban-read", tiny)
    assert not result["correct"]


def test_read_answer_altered(tiny, monkeypatch):
    """One recommended item of each call swapped for another."""
    from repro_torch.serving import cf_server
    sound = cf_server.knn_recommend_topn

    def altered(ratings, w, nbrs, users, n_rec=10):
        vals, items = sound(ratings, w, nbrs, users, n_rec)
        items = items.clone()
        items[0, 0] = (items[0, 0] + 1) % ratings.shape[1]
        return vals, items

    monkeypatch.setattr(cf_server, "knn_recommend_topn", altered)
    result, checks = run("douban-read", tiny)
    assert not result["correct"]


def test_build_state_unchanged(tiny, monkeypatch):
    """A build that returns its output buffers as they were: zeros."""
    from repro_torch.models import cf
    n = tiny["config"]["n_users"]

    def unchanged(R):
        ids = torch.arange(n, dtype=torch.int32).expand(n, n).contiguous()
        return torch.zeros((n, n)), ids

    monkeypatch.setattr(cf, "build_step", unchanged)
    result, checks = run("douban-build", tiny)
    assert not result["correct"]
    assert not checks["sim_gap"].ok


def test_build_half_the_rows(tiny, monkeypatch):
    """The product for the first half of the rows; the mean of those rows
    in place of the rest."""
    from repro_torch.models import cf
    sound = cf.cosine_similarity

    def half(Q, R, qn, rn):
        h = Q.shape[0] // 2
        S = sound(Q[:h], R, qn[:h], rn)
        return torch.cat([S, S.mean(dim=0, keepdim=True).expand(
            Q.shape[0] - h, -1)])

    monkeypatch.setattr(cf, "cosine_similarity", half)
    result, checks = run("douban-build", tiny)
    assert not result["correct"]


def test_build_answer_altered(tiny, monkeypatch):
    """One similarity of every build off by 1e-3 where it is produced."""
    from repro_torch.models import cf
    sound = cf.cosine_similarity

    def altered(Q, R, qn, rn):
        S = sound(Q, R, qn, rn)
        S[:, 0] += 1e-3
        return S

    monkeypatch.setattr(cf, "cosine_similarity", altered)
    result, checks = run("douban-build", tiny)
    assert not result["correct"]
    assert not checks["sim_gap"].ok
