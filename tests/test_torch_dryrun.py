"""The port's dry run (``repro_torch.launch.dryrun``) and ``jit_cell``'s
trace against the reference's dry run: the cell list, the record's keys,
each (family, kind)'s model FLOPs per device on the (2, 16, 16) mesh, and
the collective census of two small OLMoE cells on the (2, 2, 2) debug
mesh (the reference compiled on 8 host devices in a subprocess)."""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import MoEConfig, ShapeSpec
from repro_torch.launch import dryrun, trace
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.roofline import analyze
from repro_torch.launch.steps import build_cell, jit_cell

torch.set_num_threads(2)

# One cell of each (family, kind).
FAMILY_KINDS = [("gemma3-1b", "train_4k"), ("gemma3-1b", "prefill_32k"),
                ("gemma3-1b", "decode_32k"), ("gat-cora", "full_graph_sm"),
                ("gat-cora", "minibatch_lg"), ("gat-cora", "molecule"),
                ("xdeepfm", "train_batch"), ("xdeepfm", "serve_p99"),
                ("two-tower-retrieval", "retrieval_cand"),
                ("twinsearch-cf", "ml_build"),
                ("twinsearch-cf", "douban_onboard")]

_REF_DRYRUN = """
import json
import repro.launch.dryrun as d
from repro.configs import get_arch
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell
rec = d.run_cell("twinsearch-cf", "ml_build", False, verbose=False)
out = {"all_cells": d.all_cells(), "status": rec["status"],
       "keys": sorted(rec), "memory": sorted(rec["memory"]),
       "roofline": sorted(rec["roofline"]), "model_flops": {}}
mesh = make_production_mesh(multi_pod=True)
for a, s in CELLS:
    spec = get_arch(a)
    cell = build_cell(spec, spec.shape(s), mesh)
    out["model_flops"][a + "/" + s] = cell.model_flops / mesh.devices.size
print("JSON" + json.dumps(out))
"""

# The reference's compile test (tests/test_distributed.py), unrolled so
# that the census counts every layer; each all-to-all's element count.
_REF_OLMOE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, math
from repro.configs import get_arch
from repro.configs.base import ShapeSpec, MoEConfig as MC
from repro.launch.mesh import make_debug_mesh
from repro.launch.roofline import _COLL_RE, _SHAPE_RE, analyze
from repro.launch.steps import build_cell, jit_cell
mesh = make_debug_mesh(multi_pod=True)
spec = get_arch("olmoe-1b-7b")
small = dataclasses.replace(spec.config, n_layers=2, d_model=128, n_heads=4,
                            n_kv_heads=4, head_dim=32, vocab_size=512,
                            moe=MC(n_experts=4, top_k=2, d_ff_expert=64))
spec = dataclasses.replace(spec, config=small)
out = {}
for kind in ("train", "decode"):
    sh = ShapeSpec(kind[0], kind, {"seq_len": 256, "global_batch": 8})
    cell = build_cell(spec, sh, mesh, unroll=True)
    with mesh:
        c = jit_cell(cell, mesh).lower(*cell.args).compile()
    a2a = []
    for m in _COLL_RE.finditer(c.as_text()):
        if m.group(2) == "all-to-all":
            dims = [[int(d) for d in ds.split(",") if d]
                    for _, ds in _SHAPE_RE.findall(m.group(1))]
            a2a.append([sum(math.prod(d) for d in dims),
                        max(len(d) for d in dims)])
    out[kind] = {"census": analyze(c).collectives, "all_to_all": a2a}
print("JSON" + json.dumps(out))
"""


def _run_reference(script: str) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=600)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON")]
    assert line, out.stdout[-2000:] + out.stderr[-2000:]
    return json.loads(line[-1][4:])


@pytest.fixture(scope="module")
def ref():
    return _run_reference(f"CELLS = {FAMILY_KINDS!r}\n" + _REF_DRYRUN)


def test_all_cells_match_reference(ref):
    assert [list(c) for c in dryrun.all_cells()] == ref["all_cells"]
    assert len(dryrun.all_cells()) == 44


def test_record_keys_match_reference(ref):
    rec = dryrun.run_cell("twinsearch-cf", "ml_build", False, verbose=False)
    assert rec["status"] == ref["status"] == "ok"
    assert sorted(rec) == ref["keys"]
    assert sorted(rec["memory"]) == ref["memory"]
    assert sorted(rec["roofline"]) == ref["roofline"]
    # The build runs whole on one rank: no collectives are counted.
    assert rec["method"] == "direct, collectives not derived"
    assert rec["n_devices"] == 256


def test_skipped_record_matches_reference():
    rec = dryrun.run_cell("gemma-7b", "long_500k", True, verbose=False)
    spec = get_arch("gemma-7b")
    assert rec == {"arch": "gemma-7b", "shape": "long_500k",
                   "mesh": "2x16x16", "kind": "decode", "status": "skipped",
                   "reason": spec.skip_shapes["long_500k"]}


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a, s in FAMILY_KINDS])
def test_model_flops_per_device_match_reference(ref, cell):
    arch, shape = cell.split("/")
    rec = dryrun.run_cell(arch, shape, True, verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    r = rec["roofline"]
    assert r["model_flops_per_device"] == ref["model_flops"][cell]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    counted = (get_arch(arch).family == "lm"
               or rec["kind"] in ("train_full", "onboard"))
    assert rec["method"] == ("direct" if counted
                             else "direct, collectives not derived")
    if not counted:
        assert r["t_collective_s"] == 0.0


def test_douban_build_counts_the_similarity_formula():
    """The build cell's FLOPs are the similarity kernel's 2·n²·m on the
    ratings padded to the shard boundary (129,536 rows), per device; its
    model FLOPs the reference's 2·129,490²·58,541."""
    rec = dryrun.run_cell("twinsearch-cf", "douban_build", False,
                          verbose=False)
    r = rec["roofline"]
    assert r["model_flops_per_device"] == 2.0 * 129_490 ** 2 * 58_541 / 256
    assert r["flops_per_device"] == 2.0 * 129_536 ** 2 * 58_541 / 256
    spec = get_arch("twinsearch-cf")
    with trace.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        cell = build_cell(spec, spec.shape("douban_build"), mesh)
        compiled = jit_cell(cell, mesh).lower(*cell.args).compile()
    assert compiled.kernels["similarity"]["calls"] == 1
    assert compiled.kernels["similarity"]["flops"] == \
        2.0 * 129_536 ** 2 * 58_541
    assert compiled.cost_analysis()["flops f32"] == 0.0     # bf16 product


def test_cli_writes_records_without_jax(tmp_path):
    out = tmp_path / "dry.jsonl"
    code = ("import runpy, sys\n"
            f"sys.argv = ['dryrun', '--arch', 'xdeepfm', '--shape', "
            f"'serve_p99', '--out', {str(out)!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "print('NO_JAX')\n")
    env = dict(os.environ, PYTHONPATH="src")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "dry-run complete: all cells ok" in res.stdout
    assert "NO_JAX" in res.stdout
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [(r["mesh"], r["status"]) for r in recs] == [("16x16", "ok"),
                                                        ("2x16x16", "ok")]
    assert recs[0]["roofline"]["flops_per_device"] == pytest.approx(
        2 * recs[1]["roofline"]["flops_per_device"])


def test_cli_exits_with_the_count_of_failures(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "xdeepfm",
                                      "--shape", "serve_p99", "--out", ""])
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a, **k: {"status": "error"})
    with pytest.raises(SystemExit, match="2 cells failed"):
        dryrun.main()


# ---------------------------------------------------------------------------
# The reference's compile test through jit_cell, and its census
# ---------------------------------------------------------------------------

def _small_olmoe():
    spec = get_arch("olmoe-1b-7b")
    small = dataclasses.replace(
        spec.config, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        head_dim=32, vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64))
    return dataclasses.replace(spec, config=small)


@pytest.fixture(scope="module")
def olmoe_census():
    """The port's (2, 2, 2) census of the small OLMoE train and decode
    cells, and the reference's."""
    spec = _small_olmoe()
    port = {}
    with trace.fake_world(8):
        mesh = make_debug_mesh(multi_pod=True, device_type="cpu")
        for kind in ("train", "decode"):
            sh = ShapeSpec(kind[0], kind, {"seq_len": 256,
                                           "global_batch": 8})
            cell = build_cell(spec, sh, mesh)
            compiled = jit_cell(cell, mesh).lower(*cell.args).compile()
            port[kind] = (analyze(compiled, cell.model_flops / 8),
                          compiled)
    return port, _run_reference(_REF_OLMOE)


def test_olmoe_cells_compile_through_jit_cell(olmoe_census):
    port, _ = olmoe_census
    for kind, (terms, compiled) in port.items():
        assert terms.flops > 0 and terms.bytes_hbm > 0, kind
        mem = compiled.memory_analysis()
        assert mem.argument_size_in_bytes > 0
        assert mem.peak_memory_in_bytes >= mem.argument_size_in_bytes - \
            mem.alias_size_in_bytes
        assert set(terms.collectives) <= {"all-gather", "all-reduce",
                                          "reduce-scatter", "all-to-all"}


def test_olmoe_all_to_alls_match_reference(olmoe_census):
    """The expert exchange: the same number of all-to-alls of the same
    (E·C, d) blocks as the reference's explicit pair (dispatch and
    combine, each in the forward, the ``remat`` recompute and the
    backward).  The reference's census also holds all-to-alls that GSPMD
    adds to reshard activations (rank > 2), which the port's rule does not
    derive, and XLA on the host moves them in float32 where the port's are
    bf16; PERF.md records both censuses per kind."""
    port, ref = olmoe_census
    terms, compiled = port["train"]
    moe = [n for n, rank in ref["train"]["all_to_all"] if rank == 2]
    assert terms.collectives["all-to-all"]["count"] == len(moe) == 12
    port_elems = [math.prod(int(d) for d in re.search(
        r"= [a-z0-9]+\[([0-9,]*)\]", ln).group(1).split(","))
        for ln in compiled.as_text().splitlines() if "all-to-all(" in ln]
    assert port_elems == moe
    assert "all-to-all" not in port["decode"][0].collectives
    assert "all-to-all" not in ref["decode"]["census"]
