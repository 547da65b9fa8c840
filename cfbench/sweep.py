"""Find the highest rate an open-loop cell sustains.

    python3 cfbench/sweep.py --workload <cell> --rates 80,100,120 \\
        --seconds <s> --seed <n> [--out <file>]

Runs the cell's set-up and window once per rate, in one process, each
from a fresh server on the same seed's data, and reports for each the
latency (median and 95th percentile from due time to return), the mean
queue wait over the first and the last quarter of arrivals, and the
slope of the wait against the due time.  A rate is sustained when the
wait does not grow over the window: slope below ``MAX_SLOPE`` (a backlog
growing by 2% of the elapsed time).  Each mix file states its rate as a
share of the highest sustained one.  Needs a CUDA device.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

MAX_SLOPE = 0.02


def slope(xs, ys) -> float:
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0


def point(workload: str, rate: float, seconds: float, seed: int,
          device: str = "cuda", overrides: dict | None = None) -> dict:
    """One rate: set-up, window, and the queue's behaviour."""
    import torch
    from cfbench.bench import Ctx, load_cell, percentile
    from cfbench.trace import Tracer
    ov = {"config": dict((overrides or {}).get("config", {})),
          "mix": dict((overrides or {}).get("mix", {}), rate_per_s=rate)}
    cell = load_cell(workload, overrides=ov)
    dev = torch.device(device)
    ctx = Ctx(cell, seed, seconds, False, dev)
    tracer = Tracer(False, dev)
    t0 = time.perf_counter()
    st = cell.driver.setup(ctx, tracer)
    setup_s = time.perf_counter() - t0
    reqs = cell.driver.window(ctx, st, tracer)["requests"]
    lat = [(r["end"] - r["due"]) * 1e3 for r in reqs]
    wait = [r["start"] - r["due"] for r in reqs]
    q = max(1, len(reqs) // 4)
    out = {"rate_per_s": rate, "requests": len(reqs), "setup_s": setup_s,
           "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95),
           "wait_first_quarter_ms": sum(wait[:q]) / q * 1e3,
           "wait_last_quarter_ms": sum(wait[-q:]) / q * 1e3,
           "wait_slope": slope([r["due"] for r in reqs], wait),
           "drain_s": reqs[-1]["end"] - seconds}
    out["sustained"] = out["wait_slope"] < MAX_SLOPE
    del st
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cfbench.sweep: needs a CUDA device", file=sys.stderr)
        return 2
    points = []
    for rate in (float(r) for r in args.rates.split(",")):
        points.append(point(args.workload, rate, args.seconds, args.seed))
        print(json.dumps(points[-1]), flush=True)
    ok = [p["rate_per_s"] for p in points if p["sustained"]]
    summary = {"workload": args.workload, "seconds": args.seconds,
               "seed": args.seed, "device": torch.cuda.get_device_name(0),
               "knee_per_s": max(ok) if ok else None, "points": points}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary) + "\n")
    print(json.dumps({k: summary[k] for k in ("workload", "knee_per_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
