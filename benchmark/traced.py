"""Run one cell once as ``run.py --trace 1`` does, with the program's own
spans recorded and merged into the trace, and print after run.py's line
one more JSON line with what only the spans tell.

    python3 benchmark/traced.py --workload <name> --seed <n> --seconds <s>
                                [--dump <path.json.gz>]

The second line holds the span readers' values (``metrics/`` files that
read ``harness/spans.py``), the window's alignment (device events paired
with their CUDA call, and those that slid before it), the window's
device-idle time by the innermost span of each of the service's threads
(only where the window is aligned), and the clocks' agreement: each decode
kernel's start less the start of the ``decode.launch`` span that holds its
CUDA call, and the end of its batch's ``service.sync`` less the kernel's
end.  ``--dump`` writes the spans, the paired device events and the idle
intervals.  It does not run in the benchmark's own runs; once ``run.py
--trace 1`` records the spans itself, what is left here becomes a
``run.py`` option.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402

READERS = ("queue_wait_p95_ms.serve", "launch_host_ms.serve", "complete_host_ms.serve",
           "idle_in_launch_pct.serve", "predict_host_ms.serve", "predict_host_ms.offline")
MARKERS = ("greedy_kernel", "beam_kernel")
THREADS = ("caption-service-worker", "caption-service-completer", "MainThread")


def _range(xs):
    return [min(xs), statistics.median(xs), max(xs)] if xs else None


def _holder(spans):
    """A function of ``t``: the span of ``spans`` (one thread's, not
    overlapping) that holds ``t``, else None."""
    spans = sorted(spans, key=lambda x: x[2])
    starts = [x[2] for x in spans]

    def holding(t):
        i = bisect.bisect_right(starts, t) - 1
        return spans[i] if i >= 0 and spans[i][3] >= t else None
    return holding


def clocks(summary, marker: str, lag_us: float = 1000.0):
    """For each decode kernel in the window whose CUDA call lies in a
    ``decode.launch`` span: the kernel's start less the span's start, and
    the end of the ``service.sync`` of the batch whose ``service.launch``
    holds the call less the kernel's end (us); the share of kernels that
    start after their span and of those whose sync lag is in [0, lag_us]."""
    launches = _holder(x for x in summary.spans if x[0] == "decode.launch")
    batches = _holder(x for x in summary.spans if x[0] == "service.launch")
    syncs = {x[4]["batch"]: x for x in summary.spans if x[0] == "service.sync"}
    rows = []
    for name, start, end, call in summary.launched:
        span = launches(call) if marker in name else None
        if span is None:
            continue
        batch = batches(call)
        sync = syncs.get(batch[4].get("batch")) if batch else None
        rows.append((start - call, start - span[2], None if sync is None else sync[3] - end))
    if not rows:
        return None
    lags = [lag for _, _, lag in rows if lag is not None]
    return {"kernels": len(rows),
            "after_call_us": _range([c for c, _, _ in rows]),
            "start_us": _range([st for _, st, _ in rows]),
            "start_after_share": sum(st >= 0 for _, st, _ in rows) / len(rows),
            "sync_lag_us": _range(lags),
            "sync_lag_share": sum(0 <= x <= lag_us for x in lags) / len(lags) if lags else None}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)

    from benchmark.harness import spans, spec

    path = os.path.join(tempfile.gettempdir(), f"bench-trace-{os.getpid()}.json")
    run.Context.profiler = lambda ctx: spans.Profiler(path) if ctx.trace else None
    seen = {}
    result = run.result

    def keep(cell, ctx, outcome, record):
        seen.update(ctx=ctx, outcome=outcome)
        return result(cell, ctx, outcome, record)

    run.result = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    s = seen["outcome"].summary if seen else None
    if rc or not isinstance(s, spans.SpanSummary):
        return rc or 1
    ctx, outcome = seen["ctx"], seen["outcome"]
    line = {"span_readers": {name: spec.reader(name)(ctx, outcome) for name in READERS},
            "n_spans": len(s.spans), "dropped": s.dropped,
            "launched": len(s.launched), "slid": s.slid, "aligned": s.aligned,
            "idle_s": sum(b - a for a, b in s.idle) * 1e-6,
            "clocks": {m: clocks(s, m) for m in MARKERS}}
    if s.aligned:
        line.update(idle_by_span={th: spans.idle_by_span(s, th) for th in THREADS},
                    idle_by_any_span=spans.idle_by_span(s))
    if args.dump:
        with gzip.open(args.dump, "wt") as f:
            json.dump({"spans": s.spans, "launched": s.launched, "idle": s.idle,
                       "window": s.window}, f)
    print(json.dumps(run._finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
