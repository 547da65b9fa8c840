"""Readings that set a cell's limits: the program's, and its control's.

    python3 cfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--out <file>]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at the cell's own load, the program's answers judged (the
lower readings), then the reference computed one precision step below
the configuration's (the mix's ``control``: TF32 for float32 with TF32
off, float8 e4m3 for bfloat16) put in the program's place and judged
the same way (the upper readings).  Prints one JSON line per seed and a
last line with, per number, the largest program reading and the
smallest control reading.  Needs the cell's CUDA devices.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def readings(workload: str, seeds, seconds: float, device: str = "cuda",
             overrides: dict | None = None, spec: dict | None = None
             ) -> dict:
    """Program and control readings of every compared number over
    ``seeds`` (``spec`` as for ``bench.load_cell``)."""
    import torch
    from cfbench.bench import load_cell
    from cfbench.run import run_cell
    cell = load_cell(workload, overrides=overrides, spec=spec)
    ctrl = cell.mix["control"]
    per_seed = []
    for seed in seeds:
        res, notes, checks = run_cell(cell, seed, seconds, False, device,
                                      controls=(ctrl,))
        per_seed.append({"seed": seed, "correct": res["correct"],
                         "program": {c.name: c.value for c in checks},
                         "control": res["controls"][ctrl],
                         "notes": notes})
        print(json.dumps(per_seed[-1]), flush=True)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    names = per_seed[0]["program"]
    return {"workload": workload, "control": ctrl, "seeds": list(seeds),
            "lower": {k: max(s["program"][k] for s in per_seed)
                      for k in names},
            "upper": {k: min(s["control"][k] for s in per_seed)
                      for k in names},
            "limits": {c.name: c.limit for c in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("cfbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = readings(args.workload, seeds, args.seconds)
    line = json.dumps(summary)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
