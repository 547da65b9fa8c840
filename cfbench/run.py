"""Run one cell of ``BENCHMARK.json`` once.

    python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m cfbench.run`` from the repository root).  Set-up (data,
server or first build, warm-up) is timed from the process's start to the
first timed request; then the window runs for ``--seconds`` and, once
it has closed and the device's peak memory has been read, the program's
state is freed and its answers are judged against the plain reference.

Standard error ends with each number compared beside its limit; the
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` a ``breakdown``, and ``checks`` last.

Exits 2 without a result when the cell's CUDA devices are missing, and 3
when a JAX module or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

HOST_THREADS = 2


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    from cfbench.bench import FORBIDDEN_MODULES
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             *, controls: tuple = (), t_start: float | None = None
             ) -> tuple[dict, list[str], list]:
    """Set up, run the window and judge it.  Returns the result object,
    the notes for standard error and the checks.  Each precision in
    ``controls`` also judges the reference at that precision put in the
    program's place (``result["controls"]``; never in a benchmark run)."""
    import torch
    from cfbench.bench import Ctx, read_metric
    from cfbench.trace import Tracer

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    ctx = Ctx(cell, int(seed), float(seconds), bool(trace), dev)
    ctx.t_lap = t_start
    ctx.lap("imports and device start")
    start, length = cell.mix["trace_slice"]
    tracer = Tracer(ctx.trace, dev, start * ctx.seconds,
                    length * ctx.seconds)
    st = cell.driver.setup(ctx, tracer)
    ctx.lap("warm-up")
    setup_s = time.perf_counter() - t_start
    records = cell.driver.window(ctx, st, tracer)
    records["setup_s"] = setup_s
    records["traced_from_s"] = tracer.start_s if ctx.trace else None
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    records["trace"] = tracer.summary() if ctx.trace else None
    tracer = None
    checks = cell.driver.check(ctx, st, records)

    wanted = cell.per_layer if ctx.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = read_metric(m["name"], records)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else dev.type),
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": all(c.ok for c in checks),
              "attempted": records["attempted"],
              "failed": records["failed"], "metrics": metrics,
              "device": device_info}
    tr = records["trace"]
    if tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
        ctx.note("idle by host span (s): " + json.dumps(tr["idle_by_span"]))
    ctx.note(f"set-up {setup_s:.4f} s; window of {ctx.seconds} s; "
             f"{records['attempted']} attempted, {records['failed']} failed")
    if controls:
        result["controls"] = {
            p: {c.name: c.value
                for c in cell.driver.check(ctx, st, records, control=p)}
            for p in controls}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, ctx.notes, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from cfbench.bench import load_cell
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"cfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    result, notes, checks = run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda",
                                     t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        print(f"cfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
