"""The port's serving launcher, ``python -m repro_torch.launch.serve``:
``--service cf --device cpu`` at 200 users x 80 items onboards 8 planted
twins of user 3, and TwinSearch finds every one; ``--service lm`` exits
with a message until the LM server is ported."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

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
    with pytest.raises(SystemExit, match="LM server"):
        serve.main(["--service", "lm", "--device", "cpu"])


def test_module_runs_as_a_script():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          *ARGS], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "'twin_hits': 8" in out.stderr
