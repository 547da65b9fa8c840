"""Multi-pod dry run (PyTorch port of ``repro.launch.dryrun``).

Counts every (architecture x input-shape) cell on the production meshes,
(16, 16) single-pod and (2, 16, 16) two-pod, without allocating memory or
needing a card: the process is rank 0 of a 256- or 512-rank process group
on PyTorch's ``"fake"`` backend (``launch.trace.fake_world``; its store is
a private PyTorch API), every argument is a ``meta`` tensor, and
``launch.steps.jit_cell(cell, mesh).lower(*cell.args).compile()`` traces
the step under the counters of ``launch.trace`` (the port's stand-in for
XLA's compile).  Each record carries the per-device ``memory`` (the
fits-proof) and the ``roofline`` terms (``launch.roofline``).

How the counts are taken (``Compiled`` in ``launch.steps`` states it in
full): compute and HBM bytes from one trace at global shapes as the card
runs the step on a (1, 1) mesh, divided by the devices (the ideal
partition); the explicit collectives of the sharded burst, ``gnn_ep`` and
``moe_ep`` recorded at per-rank shapes on the fake group; for the LM cells
the collectives GSPMD would insert, derived leaf by leaf from the specs.

The reference compiles looped cells twice more at shallow depth and
extrapolates per layer (per user for the CF burst), because XLA prices a
loop body once and unrolling a deep step takes its partitioner minutes.
An eager trace runs every layer and every user and costs no compile, so
every cell here is counted at full depth, and ``method`` is ``"direct"``;
``"direct, collectives not derived"`` marks a cell whose step runs whole on
one rank with no rule for what a partitioned program would exchange (the
recsys cells, the CF build, the GNN cells but ``train_full``): its
``t_collective_s`` is 0 and bounds nothing.  Per-device compute, bytes
and, for those cells, temporaries are the global trace's divided by the
devices, a lower estimate where a partitioned program repeats work.
A decode cell's position, read on the host, is the last of its cache; a
sharded burst's users each take the costliest branch (``core.
twinsearch_sharded``).

Usage:
  python -m repro_torch.launch.dryrun --all        # every cell, both meshes
  python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k \\
      --multi-pod
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import trace
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import analyze
from repro_torch.launch.steps import build_cell, jit_cell


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_path: str | None = None, verbose: bool = True) -> dict:
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                 "kind": shape.kind}

    if shape_name in spec.skip_shapes:
        rec.update(status="skipped", reason=spec.skip_shapes[shape_name])
        _emit(rec, out_path, verbose)
        return rec

    t0 = time.time()
    n_dev = 512 if multi_pod else 256
    try:
        with trace.fake_world(n_dev):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            cell = build_cell(spec, shape, mesh)
            compiled = jit_cell(cell, mesh).lower(*cell.args).compile()
        mem = compiled.memory_analysis()
        terms = analyze(compiled, cell.model_flops / n_dev)
        t_full = time.time() - t0
        rec.update(
            status="ok",
            n_devices=n_dev,
            compile_s=round(t_full, 1),
            full_compile_s=round(t_full, 1),
            method=("direct" if compiled.collectives_counted
                    else "direct, collectives not derived"),
            memory={
                "argument_bytes": mem.argument_size_in_bytes,
                "output_bytes": mem.output_size_in_bytes,
                "temp_bytes": mem.temp_size_in_bytes,
                "alias_bytes": mem.alias_size_in_bytes,
                "peak_bytes": mem.peak_memory_in_bytes,
            },
            roofline=terms.as_dict(),
        )
    except Exception as e:                              # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    _emit(rec, out_path, verbose)
    return rec


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}TB"


def _emit(rec: dict, out_path: str | None, verbose: bool) -> None:
    if verbose:
        tag = f"[{rec['arch']}/{rec['shape']}@{rec['mesh']}]"
        if rec["status"] == "skipped":
            print(f"{tag} SKIP: {rec['reason']}", flush=True)
        elif rec["status"] == "error":
            print(f"{tag} ERROR: {rec['error']}", flush=True)
        else:
            m = rec["memory"]
            r = rec["roofline"]
            print(f"{tag} ok {rec['compile_s']}s ({rec['method']}) | "
                  f"per-device: args={_fmt_bytes(m['argument_bytes'])} "
                  f"temp={_fmt_bytes(m['temp_bytes'])} "
                  f"out={_fmt_bytes(m['output_bytes'])} | "
                  f"flops={r['flops_per_device']:.3e} "
                  f"t_comp={r['t_compute_s']*1e3:.2f}ms "
                  f"t_mem={r['t_memory_s']*1e3:.2f}ms "
                  f"t_coll={r['t_collective_s']*1e3:.2f}ms "
                  f"dom={r['dominant']} useful={r['useful_fraction']:.2f}",
                  flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        slim = {k: v for k, v in rec.items() if k != "traceback"}
        with open(out_path, "a") as f:
            f.write(json.dumps(slim) + "\n")


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch_id in list_archs():
        spec = get_arch(arch_id)
        for shape in spec.shapes:
            cells.append((arch_id, shape.name))
    return cells


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    args = ap.parse_args()

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    n_err = 0
    for arch_id, shape_name in cells:
        for mp in meshes:
            rec = run_cell(arch_id, shape_name, mp, out_path=args.out)
            n_err += rec["status"] == "error"
    if n_err:
        raise SystemExit(f"{n_err} cells failed")
    print("dry-run complete: all cells ok")


if __name__ == "__main__":
    main()
