"""Shared set-up of the benchmark's own tests (run with
``python -m pytest cfbench/tests`` from the repository root)."""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

torch.set_num_threads(2)

# Every cell cut to a size the CPU runs in seconds: 300 users x 400 items
# and a write region of 16 (so windows of a second rotate several times).
TINY = {"config": {"n_users": 300, "n_items": 400, "n_ratings": 12000,
                   "server": {"capacity_extra": 16, "c_probes": 8,
                              "sim_tol": 1e-6, "probe_seed": 0,
                              "snapshot_every": 16, "check_every": 8,
                              "rotation_headroom": 1.0,
                              "rotation_budget_rows": 0}},
        "mix": {"rate_per_s": 60.0, "pool_size": 8, "pool_min_ratings": 30,
                "check_base_rows": 64, "write_region_onboards": 16,
                "sample_rows": 16}}



@pytest.fixture
def tiny():
    return copy.deepcopy(TINY)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
