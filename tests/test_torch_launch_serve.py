"""The port's serving launcher, ``python -m repro_torch.launch.serve``:
``--service cf --device cpu`` at 200 users x 80 items onboards 8 planted
twins of user 3, and TwinSearch finds every one; ``--service lm --device
cpu`` serves the reference's tiny shrink of each LM architecture (5
prompts, 2 distinct: 60% dedup savings) with the reference's completions
for the same weights; a non-LM ``--arch`` exits with a message."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--service", "cf", "--device", "cpu", "--users", "200", "--items",
        "80"]


def test_serve_cf_finds_every_planted_twin():
    srv = serve.main(ARGS)
    s = srv.stats.summary()
    assert s["onboarded"] == s["twin_hits"] == 8
    assert s["fallbacks"] == 0
    assert srv.state.n_active == 208
    assert srv.state.ratings.device.type == "cpu"


def test_serve_defaults_to_the_card():
    args = serve.parser().parse_args(["--service", "cf"])
    assert args.device == "cuda" and (args.users, args.items) == (2000, 800)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.serve_cf(serve.parser().parse_args(
                ["--users", "200", "--items", "80"]))


def test_lm_service_exits_with_a_message():
    """``--service lm`` serves the lm family only."""
    with pytest.raises(SystemExit, match="not an LM"):
        serve.main(["--service", "lm", "--arch", "xdeepfm", "--device",
                    "cpu"])


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_lm_service_serves_with_dedup(arch):
    out, info = serve.main(["--service", "lm", "--arch", arch, "--device",
                            "cpu", "--n-new", "4"])
    assert out.shape == (5, 4) and out.dtype == np.int32
    assert info == {"prefill_rows": 2, "batch": 5, "dedup_savings": 0.6}
    assert np.array_equal(out[0], out[2]) and np.array_equal(out[1], out[3])


def test_lm_service_defaults():
    args = serve.parser().parse_args(["--service", "lm"])
    assert (args.arch, args.n_new, args.device) == ("gemma3-1b", 8, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--service", "lm"])


def test_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *ARGS], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'twin_hits': 8" in out.stderr
