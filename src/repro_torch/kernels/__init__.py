"""Hand-written CUDA kernels, each with its plain PyTorch version beside it.

  similarity/    cosine-similarity product, fused norm epilogue (the
                 traditional burst; replaces ``similarity_pallas``)
  twin_probe/    c-probe interval intersection + |Set_0| count (replaces
                 ``twin_probe_pallas``)
  verify_rows/   masked row-equality verification (replaces
                 ``verify_rows_pallas``), beside the plain arena health
                 checks
  embedding_bag/ weighted row-gather bag sum (the recsys substrate;
                 replaces ``embedding_bag_pallas``)
  list_merge/    k-way merge-insert of sorted inserts (arena rotation;
                 replaces ``merge_insert_pallas``)
  knn_score/     batched kNN item scoring by neighbour gather (the read
                 path; replaces ``knn_scores_pallas``)
  key_dedup/     twin dedup of the read path's keys on the card, a probe
                 hash then an exact verify (replaces no Pallas kernel:
                 ``serving/dedup.py``'s host route on the CF read path)

``kernel.py`` binds ``csrc/<name>.cu``, ``ref.py`` holds the plain
version, and ``ops.py`` dispatches: the kernel for CUDA tensors, the plain
version for CPU tensors.  ``_lib.launch_counts()`` reports how often each
kernel was launched.
"""
from repro_torch.kernels._lib import (KERNELS, build_all, launch_counts,
                                      reset_launch_counts)
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.kernels.twin_probe.ops import twin_probe
from repro_torch.kernels.verify_rows.ops import verify_rows
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.list_merge.ops import merge_insert
from repro_torch.kernels.knn_score.ops import knn_scores, knn_recommend_topn

__all__ = ["KERNELS", "build_all", "launch_counts", "reset_launch_counts",
           "cosine_similarity", "twin_probe", "verify_rows", "embedding_bag",
           "merge_insert", "knn_scores", "knn_recommend_topn"]
