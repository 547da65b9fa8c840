"""The plain reference held to ``repro_torch`` at a tiny size on the CPU:
sorted cosine lists (the server's float32 build and onboards, the bf16
build step) and kNN recommendations.  The test imports both; the
reference imports neither."""
import json

import pytest
import torch

from cfbench import data, reference
from cfbench.bench import HERE


def ratings(n=120, m=90, total=1500, seed=3, name="douban-32k"):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(n_users=n, n_items=m, n_ratings=total)
    return data.synth_ratings(cfg, seed, "cpu")


@pytest.mark.parametrize("name", ["douban-32k", "ml20m-41k"])
def test_server_build_lists_match_exact_cosine(name):
    from repro_torch.core.knn import build_state
    R = ratings(name=name)
    st = build_state(R, capacity_extra=8)
    rows = torch.arange(R.shape[0])
    cols = reference.expected_columns(rows, R.shape[0])
    e = reference.judge_lists(rows, R, cols, "exact", st.sim_vals[rows],
                              st.sim_idx[rows])
    assert e["id_rows"] == 0 and e["unsorted_rows"] == 0
    assert e["gap"] < 1e-5


def test_onboarded_rows_and_rotation_match():
    from repro_torch.serving import CFServer, ServerConfig
    R = ratings()
    srv = CFServer(R, ServerConfig(capacity_extra=4), device="cpu")
    fresh = ratings(n=6, total=200, seed=9)
    new = [R[7].numpy(), R[11].numpy(), R[7].numpy()] + [
        fresh[i].numpy() for i in range(6)]
    for r in new:
        assert srv.onboard_user(r).ok
    F = torch.cat([R, torch.as_tensor(__import__("numpy").stack(new))])
    rows = torch.arange(F.shape[0])
    cols = reference.expected_columns(rows, srv.n_base)
    assert srv.n_base == R.shape[0] + 8            # rotated twice
    e = reference.judge_lists(rows, F, cols, "exact",
                              srv.state.sim_vals[rows],
                              srv.state.sim_idx[rows])
    assert e == {"gap": e["gap"], "unsorted_rows": 0, "id_rows": 0,
                 "rows": F.shape[0]}
    assert e["gap"] < 1e-5


def test_bf16_build_step_matches_bf16_reference():
    from repro_torch.models.cf import build_step
    Rb = ratings().to(torch.bfloat16)
    vals, idx = build_step(Rb)
    rows = torch.arange(Rb.shape[0])
    e = reference.judge_lists(rows, Rb, torch.full_like(rows, Rb.shape[0]),
                              "bfloat16", vals, idx)
    assert e["id_rows"] == 0 and e["unsorted_rows"] == 0
    assert e["gap"] < 1e-6
    exact = reference.judge_lists(rows, Rb, torch.full_like(rows, 120),
                                  "exact", vals, idx)
    assert exact["gap"] > 10 * e["gap"], "bf16 rounding shows in the exact"


def test_recommendations_match_reference():
    from repro_torch.serving import CFServer, ServerConfig
    R = ratings(n=200, m=150, total=4000)
    srv = CFServer(R, ServerConfig(capacity_extra=8), device="cpu")
    users = list(range(0, 200, 3))
    served = srv.recommend_batch(users, n=10, k_neighbors=20)
    u = torch.tensor(users)
    cand = torch.arange(200)[None, :] < 200
    cand = cand.repeat(len(users), 1)
    cand[torch.arange(len(users)), u] = False
    scores, amb = reference.knn_scores(
        reference.cosine_rows(R[u], R, "exact"), cand, R, u, 20, 1e-5)
    keep = [i for i in range(len(users)) if not bool(amb[i])]
    assert len(keep) > len(users) // 2
    g = reference.recommendation_gaps([served[i] for i in keep],
                                      scores[keep], 10)
    assert g["malformed"] == 0
    assert g["score_gap"] < 1e-4 and g["rank_gap"] < 1e-4
    # The reference's own answer judges as exact.
    own = reference.recommendation_gaps(
        reference.served_from_reference(scores[keep], 10), scores[keep], 10)
    assert own["score_gap"] < 1e-5 and own["rank_gap"] < 1e-5


def test_list_errors_catch_ids_order_and_values():
    R = ratings(n=40, m=60, total=600)
    rows = torch.arange(40)
    cols = torch.full_like(rows, 40)
    truth = reference.cosine_rows(R, R, "exact")
    v, i = reference.sorted_lists(truth, cols, 44)
    assert reference.list_errors(v, i, truth, cols)["gap"] < 1e-6
    i2 = i.clone()
    i2[3, -1] = i2[3, -2]                              # an id twice
    assert reference.list_errors(v, i2, truth, cols)["id_rows"] == 1
    v2 = v.clone()
    v2[5, -1], v2[5, -2] = v[5, -2], v[5, -1] + 1e-3   # out of order
    e = reference.list_errors(v2, i, truth, cols)
    assert e["unsorted_rows"] == 1 and e["gap"] >= 1e-3


def test_round_tf32_to_nearest_even():
    x = torch.tensor([1.0, 3.0, 0.1, 1.0 + 2**-11, 1.0 + 3 * 2**-11])
    y = reference.round_tf32(x)
    assert y[0] == 1.0 and y[1] == 3.0
    assert y[3] == 1.0                        # a tie rounds to even
    assert y[4] == 1.0 + 2**-9                # up to the even neighbour
    assert abs(float(y[2]) - 0.1) <= 0.1 * 2**-11
