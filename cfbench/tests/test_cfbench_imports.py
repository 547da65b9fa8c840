"""Nothing a run loads may have the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the port), and
the yardsticks import nothing of the program at all."""
import ast
import json
import subprocess
import sys

from cfbench.bench import FORBIDDEN_MODULES, HERE, ROOT

# The benchmark's own modules that must not touch the program.
YARDSTICKS = ("bench", "data", "reference", "roofline", "trace",
              "openloop")

WALK = r"""
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
torch.set_num_threads(1)
import cfbench.run, cfbench.sweep, cfbench.control
from cfbench.bench import HERE, load_module, load_cell
for p in sorted((HERE / "drivers").glob("*.py")):
    load_module(p, "walk_driver_" + p.stem)
for p in sorted((HERE / "metrics").glob("*.py")):
    load_module(p, "walk_metric_" + p.stem.replace(".", "_"))
cell = load_cell({cell!r}, overrides=json.loads({tiny!r}))
cfbench.run.run_cell(cell, 5, 0.5, True, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_every_module_a_run_loads(tiny):
    for cell in ("douban-onboard", "douban-read", "douban-build"):
        code = WALK.format(root=str(ROOT), cell=cell, tiny=json.dumps(tiny))
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
        assert "repro_torch" in tops
        assert not tops & set(FORBIDDEN_MODULES), tops & set(
            FORBIDDEN_MODULES)


def test_forbidden_names_compared_whole(monkeypatch):
    from cfbench import run
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_loaded() == ["jax", "repro"]


def imported(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_yardsticks_import_nothing_of_the_program():
    for name in YARDSTICKS:
        got = imported(HERE / f"{name}.py")
        assert not got & {"repro_torch", *FORBIDDEN_MODULES}, (name, got)
    for path in sorted((HERE / "metrics").glob("*.py")):
        assert not imported(path) & {"repro_torch", *FORBIDDEN_MODULES}


def test_no_file_of_the_benchmark_imports_jax_or_repro():
    for path in sorted(HERE.rglob("*.py")):
        assert not imported(path) & set(FORBIDDEN_MODULES), path
