"""Guards on the port's package boundary and its device contract.

  * no file of ``src/repro_torch/`` (nor ``chip_smoke.py``) imports
    ``jax`` or the ``repro`` package;
  * importing the port's serving surface loads no JAX;
  * ``CFServer(device="cuda")`` and ``state_from_numpy`` (whose default is
    the card) raise where there is no card, instead of sliding onto the
    CPU;
  * each kernel wrapper runs its plain version on CPU tensors, launches
    nothing and counts nothing, and raises on a device it does not serve
    (``meta`` it serves: the kernel's empty output, for a dry run);
  * ``repro_torch.kernels`` names every function of ``repro.kernels``.
"""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.kernels
from repro_torch.bridge import state_from_numpy
from repro_torch.kernels import (embedding_bag, launch_counts, twin_probe,
                                 verify_rows)
from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.key_dedup.kernel import probe_cuda, verify_cuda
from repro_torch.kernels.key_dedup.ops import first_twins
from repro_torch.kernels.knn_score.kernel import knn_scores_cuda
from repro_torch.kernels.knn_score.ops import knn_scores
from repro_torch.kernels.list_merge.kernel import merge_sorted_cuda
from repro_torch.kernels.list_merge.ops import merge_insert
from repro_torch.kernels.similarity.kernel import similarity_cuda
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.kernels.twin_probe.kernel import twin_probe_cuda
from repro_torch.kernels.verify_rows.kernel import verify_rows_cuda
from repro_torch.serving import CFServer
from tests.conftest import make_ratings

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "import repro_torch.serving\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__,"
            " 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                         "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_cuda_server_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    R = make_ratings(np.random.default_rng(0), n=20, m=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        CFServer(R)


def test_state_from_numpy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    R = make_ratings(np.random.default_rng(0), n=6, m=4)
    arrays = {"ratings": R, "norms": np.linalg.norm(R, axis=1),
              "sim_vals": np.zeros((6, 6), np.float32),
              "sim_idx": np.zeros((6, 6), np.int32), "n_active": 6}
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy(arrays)
    assert state_from_numpy(arrays, device="cpu").ratings.device.type == \
        "cpu"


def test_port_names_every_reference_kernel_function():
    import repro.kernels
    missing = set(repro.kernels.__all__) - set(repro_torch.kernels.__all__)
    assert not missing, sorted(missing)


def _cases():
    rng = np.random.default_rng(0)
    Q = torch.as_tensor(rng.normal(size=(3, 9)).astype(np.float32))
    R = torch.as_tensor(make_ratings(rng, n=12, m=9))
    vals = torch.sort(torch.rand(4, 10)).values
    idx = torch.arange(40, dtype=torch.int32).reshape(4, 10)
    ins = torch.rand(4, 3)
    w = torch.rand(2, 3)
    nbrs = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    users = torch.tensor([6, 7], dtype=torch.int32)
    return {
        "similarity": (cosine_similarity, (Q, Q)),
        "list_merge": (merge_insert, (vals, idx, ins,
                                      torch.tensor([7, 8, 9]))),
        "knn_score": (knn_scores, (R, w, nbrs, users)),
        "twin_probe": (twin_probe, (vals, vals[:, 3])),
        "verify_rows": (verify_rows, (R, R[2], torch.ones(12, dtype=bool))),
        "embedding_bag": (embedding_bag, (R, nbrs, w)),
        "key_dedup": (first_twins, (w, nbrs, R, users.long())),
    }


KERNEL_NAMES = ["similarity", "list_merge", "knn_score", "twin_probe",
                "verify_rows", "embedding_bag", "key_dedup"]


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_runs_plain_version_on_cpu(name):
    fn, args = _cases()[name]
    before = launch_counts()
    fn(*args)
    assert launch_counts() == before


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_raises_on_unserved_device(name):
    """``meta`` is served since the dry run (the kernel's empty output and
    its cost); a device the port has no kernel for, ``xpu`` (fake tensors
    here), raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args = _cases()[name]
    with FakeTensorMode():
        xpu = [torch.empty(a.shape, dtype=a.dtype, device="xpu")
               for a in args]
        with pytest.raises(ValueError, match="device"):
            fn(*xpu)


def test_kernel_bindings_refuse_cpu_tensors():
    fn_args = [(similarity_cuda, (torch.ones(2, 3), torch.ones(4, 3),
                                  torch.ones(2), torch.ones(4))),
               (merge_sorted_cuda, (torch.zeros(2, 5),
                                    torch.zeros(2, 5, dtype=torch.int32),
                                    torch.zeros(2, 1),
                                    torch.zeros(2, 1, dtype=torch.int32))),
               (knn_scores_cuda, (torch.zeros(4, 3), torch.zeros(1, 2),
                                  torch.zeros(1, 2, dtype=torch.int32),
                                  torch.zeros(1, dtype=torch.int32))),
               (twin_probe_cuda, (torch.zeros(2, 5), torch.zeros(2), 1e-6)),
               (verify_rows_cuda, (torch.zeros(2, 5), torch.zeros(5),
                                   torch.ones(2, dtype=torch.bool))),
               (embedding_bag_cuda, (torch.zeros(4, 3),
                                     torch.zeros(2, 2, dtype=torch.int32),
                                     torch.zeros(2, 2))),
               (probe_cuda, (torch.zeros(2, 3),
                             torch.zeros(2, 3, dtype=torch.int32),
                             torch.zeros(2, 1))),
               (verify_cuda, (torch.zeros(2, 3),
                              torch.zeros(2, 3, dtype=torch.int32),
                              torch.zeros(2, 1), None,
                              torch.zeros(2, dtype=torch.int64)))]
    for fn, args in fn_args:
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
