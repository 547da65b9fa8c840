"""The paper's contribution (TwinSearch onboarding) and the CF substrate it
lives in, on PyTorch tensors."""
from repro_torch.core.types import (CFState, OnboardStats, TwinResult,
                                    SENTINEL, SENTINEL_GATE, active_mask,
                                    clone_state, set0_cap)
from repro_torch.core.similarity import (cosine_matrix, cosine_vs_all,
                                         pearson_matrix,
                                         adjusted_cosine_matrix,
                                         similarity_matrix, row_norms)
from repro_torch.core.knn import (build_state, sort_rows, top_k_neighbors,
                                  top_k_neighbors_batch, predict,
                                  predict_from_neighbors, predict_batch,
                                  recommend, recommend_from_neighbors,
                                  recommend_batch)
from repro_torch.core.baseline import (build_list, append_user,
                                       onboard_traditional,
                                       onboard_batch_traditional)
from repro_torch.core.twinsearch import (twinsearch_find, onboard_twinsearch,
                                         onboard_batch,
                                         onboard_batch_buffered, make_probes,
                                         probe_sims, candidate_mask,
                                         verify_candidates)
from repro_torch.core.maintenance import (insert_into_lists,
                                          insert_batch_into_lists,
                                          merge_new_users_into_base,
                                          splice_twin, splice_twins,
                                          twin_sims_block)
from repro_torch.core.rotation import (RotationPlan, rotate_arena,
                                       rotate_arena_frozen, unsorted_rows)

__all__ = [
    "CFState", "OnboardStats", "TwinResult", "SENTINEL", "SENTINEL_GATE",
    "active_mask", "clone_state", "set0_cap", "cosine_matrix",
    "cosine_vs_all", "pearson_matrix", "adjusted_cosine_matrix",
    "similarity_matrix", "row_norms", "build_state", "sort_rows",
    "top_k_neighbors", "top_k_neighbors_batch", "predict",
    "predict_from_neighbors", "predict_batch", "recommend",
    "recommend_from_neighbors", "recommend_batch", "build_list",
    "append_user", "onboard_traditional", "onboard_batch_traditional",
    "twinsearch_find", "onboard_twinsearch", "onboard_batch",
    "onboard_batch_buffered", "make_probes",
    "probe_sims", "candidate_mask", "verify_candidates",
    "insert_into_lists", "insert_batch_into_lists",
    "merge_new_users_into_base", "splice_twin", "splice_twins",
    "twin_sims_block", "RotationPlan", "rotate_arena", "rotate_arena_frozen",
    "unsorted_rows",
]
