"""The knee of a serving cell, found once by a sweep on the card: the p95
from the due time at one request in flight (closed loop), and at each of
a list of offered rates (open loop) the p50/p95/p99, the generator's
lateness and whether the backlog grew (the p95 of the window's last
third against its first).

    python3 benchmark/sweep.py --workload <name> --rates 500,1000,2000 --seconds 8

One JSON line per measurement on standard output.  The rate and the
limit found are written into the cell's traffic file by hand.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def pct(x, q):
    import numpy as np

    s = np.sort(x)
    return float(s[max(0, math.ceil(q * len(s)) - 1)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma list of requests/s")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--windows", type=int, default=3, help="windows a rate, seeds seed+k")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--single", type=int, default=400, help="closed-loop requests")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchmark.harness import serve, spec

    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    setup = serve.Setup(cell.config, cell.mix, args.seed, device)
    load = serve.Load(cell.mix, 1.0, args.seed, rate=args.single)
    lat = []
    for i in range(args.single):
        row, t = int(load.pool_rows[i]), int(load.lengths[i])
        t0 = time.perf_counter()
        setup.service.submit(setup.visual[row, :t], setup.audio[row, :t]).result()
        lat.append(time.perf_counter() - t0)
    lat = np.array(lat)
    limit_ms = 3e3 * pct(lat, .95)
    print(json.dumps({"in_flight": 1, "requests": len(lat), "p50_ms": 1e3 * pct(lat, .5),
                      "p95_ms": 1e3 * pct(lat, .95), "limit_ms": limit_ms}), flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        for k in range(args.windows):
            load = serve.Load(cell.mix, args.seconds, args.seed + k, rate=rate)
            res = serve.drive(setup, load, args.seconds)
            lat = res["latency"]
            third = len(lat) // 3
            p95, last = 1e3 * pct(lat, .95), 1e3 * pct(lat[-third:], .95)
            print(json.dumps({
                "rate": rate, "seed": args.seed + k, "requests": len(lat),
                "failed": int(np.isinf(lat).sum()), "p50_ms": 1e3 * pct(lat, .5),
                "p95_ms": p95, "p99_ms": 1e3 * pct(lat, .99),
                "first_third_p95_ms": 1e3 * pct(lat[:third], .95), "last_third_p95_ms": last,
                "holds": bool(p95 <= limit_ms and last <= limit_ms),
                "late_max_ms": 1e3 * float(res["late"].max()),
                "batches": res["stats"]["batches"], "rows": res["stats"]["mean_batch_occupancy"],
                "completed_per_s": float(np.isfinite(lat).sum()) / (res["t_last"] - res["t0"])}),
                flush=True)
    setup.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
