"""Where a benchmark cell's requests spend their time, by the port's own
spans (``repro_torch.spans``), and what the span recorder costs.

    python span_report.py cost [--spans 100000] [--out FILE]
    python span_report.py cell --workload <cell> --seed <n> \\
        --seconds <s> [--trace 0|1] [--out FILE]

``cost`` times the recorder on the card: a request with no spans, host
spans and device spans (CUDA events, on the current stream and on a
given one), each over ``--spans`` spans in requests of ten, and a span
opened outside any request.  ``cell`` runs one cell of
``BENCHMARK.json`` through ``cfbench/run.py``'s own ``main`` (its output
unchanged, the result line last), then writes the window's per-span
breakdown: for each span name, how many a request and the host, self and
device ms a request, over the window's calls, and the spans a request
opened, host and device, which times the unit costs give the recorder's
cost a request.  Both write their JSON to ``--out`` as well (under
``results/`` by default).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

REQUEST = {"onboard": "cf_server.onboard_user",
           "read": "cf_server.recommend_batch", "build": "cf.build_step"}


def card() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import torch
    out = {"device": torch.cuda.get_device_name(0)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["power_limit"] = f"unread: {e!r}"
    return out


def cost(spans: int) -> dict:
    """ns per request (no spans), per host span, per device span and per
    span outside a request, on the card."""
    import torch
    from repro_torch.spans import Recorder
    rec = Recorder()
    x = torch.zeros(1, device="cuda")
    per, n_req = 10, spans // 10
    torch.cuda.synchronize()

    def timed(body) -> float:
        t0 = time.perf_counter_ns()
        body()
        return float(time.perf_counter_ns() - t0)

    def requests():
        for _ in range(n_req):
            with rec.request("cost.request"):
                pass

    def host():
        for _ in range(n_req):
            with rec.request("cost.request"):
                for _ in range(per):
                    with rec.span("cost.host"):
                        pass

    def device_block(n, device=True):
        for _ in range(n):
            with rec.request("cost.request"):
                for _ in range(per):
                    with rec.span("cost.device", device=device):
                        pass

    def null():
        for _ in range(spans):
            with rec.span("cost.null"):
                pass

    def loop():
        for _ in range(n_req):
            for _ in range(per):
                pass

    x.add_(1)
    device_block(1)                 # the event pool is made here
    rec.clear()
    empty = timed(loop)
    req_ns = timed(requests) / n_req
    host_ns = (timed(host) - empty - req_ns * n_req) / spans
    def device_ns(device) -> float:
        # In blocks that fit the pool, read after each block (the reads are
        # not timed), so no span takes a pair still unread.
        block = rec.event_pairs // per
        total, done = 0.0, 0
        while done < n_req:
            n = min(block, n_req - done)
            total += timed(lambda: device_block(n, device))
            torch.cuda.synchronize()
            rec.resolve()
            done += n
        return (total - empty - req_ns * n_req) / spans

    dev_ns = device_ns(True)
    # A kernel's launch passes its stream (no current-stream lookup).
    dev_stream_ns = device_ns(torch.cuda.current_stream())
    null_ns = (timed(null) - empty) / spans
    assert rec.device_lost == 0
    # What a device span's two events cost: finding the current stream
    # (device=True only) and recording an event on it.
    stream = torch.cuda.current_stream()
    event = torch.cuda.Event(enable_timing=True)
    n = spans // 10
    stream_ns = timed(lambda: [torch.cuda.current_stream()
                               for _ in range(n)]) / n
    record_ns = timed(lambda: [event.record(stream) for _ in range(n)]) / n
    torch.cuda.synchronize()
    return {"spans": spans, "request_ns": req_ns, "host_span_ns": host_ns,
            "device_span_ns": dev_ns, "device_span_stream_ns": dev_stream_ns,
            "null_span_ns": null_ns,
            "current_stream_ns": stream_ns, "event_record_ns": record_ns,
            **card()}


def window_spans(kind: str, attempted: int) -> dict:
    """The breakdown of the window's ``attempted`` calls and the spans a
    call opened."""
    from repro_torch.spans import RECORDER, breakdown
    entries = RECORDER.entries(REQUEST[kind])[-attempted:]
    n = max(1, len(entries))
    host = sum(len(e.children) for e in entries)
    dev = sum(c[4] is not None for e in entries for c in e.children)
    return {"request": REQUEST[kind], "calls": len(entries),
            "dropped": RECORDER.dropped, "device_lost": RECORDER.device_lost,
            "spans_per_call": host / n, "device_spans_per_call": dev / n,
            "breakdown": breakdown(entries)}


def cell(args) -> dict:
    """Run the cell by ``cfbench.run.main``, exiting with its code if it
    failed, and read the window's spans."""
    from cfbench import run
    from cfbench.bench import load_cell
    run.T_START = T_START           # set-up counts from this script's start
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds),
                       "--trace", str(args.trace)])
    sys.stdout.write(out.getvalue())
    sys.stdout.flush()
    if rc != 0:
        raise SystemExit(rc)
    result = json.loads(out.getvalue().splitlines()[-1])
    kind = load_cell(args.workload).mix["kind"]
    return {"workload": args.workload, "seed": args.seed,
            "trace": args.trace, "result": result,
            "spans": window_spans(kind, result["attempted"]), **card()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    a = sub.add_parser("cost")
    a.add_argument("--spans", type=int, default=100_000)
    a.add_argument("--out", default="results/span_cost.json")
    b = sub.add_parser("cell")
    b.add_argument("--workload", required=True)
    b.add_argument("--seed", type=int, required=True)
    b.add_argument("--seconds", type=float, required=True)
    b.add_argument("--trace", type=int, choices=(0, 1), default=0)
    b.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.what == "cost":
        out = cost(args.spans)
        print(json.dumps(out), flush=True)
        path = args.out
    else:
        out = cell(args)
        path = args.out or (f"results/spans_{args.workload}_"
                            f"{args.seed}_t{args.trace}.json")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
