"""The readings a cell's limits are set from: the program's number and the
control's on many seeds, in one process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 --seconds 3

For each seed a whole run of the cell (set-up, a window of ``--seconds``
at the cell's own load, the check), then the control: the plain reference
put in the program's place with its matrix products in TF32, the
precision below the configuration's, judged by the same comparison.  One
JSON line a seed on standard output.  The benchmark's own runs never run
the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import run
    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cell.config.get("tf32", False))
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = run.Context(cell, seed, args.seconds, False, device, time.perf_counter(),
                          control=True)
        torch.cuda.reset_peak_memory_stats(device)
        out = spec.runner(cell.mix).run(ctx)
        line = {"workload": args.workload, "seed": seed, "correct": out.correct,
                "failed": out.failed, "checks": {n: v for n, v, _ in out.checks},
                "control": out.layer.get("control"), "by_tie": out.layer.get("by_tie"),
                "metrics": out.metrics,
                "setup_s": out.setup_s, "memory_peak_bytes": out.memory_peak_bytes,
                "notes": out.notes}
        print(json.dumps(run._finite(line)), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
