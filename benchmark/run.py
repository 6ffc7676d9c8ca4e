"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is the ``workloads`` entry ``<name>`` of ``BENCHMARK.json``; its
configuration, traffic mix, limits and per-layer readers are files under
``benchmark/`` found by name (``harness/spec.py``).  The run makes its
weights and inputs from ``--seed``, warms every shape its traffic uses
(set-up, ``setup_s``), measures for ``--seconds``, then checks what the
window produced against the plain reference (``reference/``).  With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` the window runs under ``torch.profiler`` and the result
holds its per-layer metrics, the device's busy time and a breakdown.

Standard output's last line is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared with its limit);
the numbers compared are also standard error's last lines.  Without a
card, with fewer cards than the cell asks for, or with a JAX module or
the JAX package loaded when the window has closed, it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

# The program builds its kernels into ROOT/build/mvc_tpu_torch/, inside the checkout.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# libraries the port may import load neither Flax nor TensorFlow
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, ROOT)

from benchmark.harness import imports  # noqa: E402


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class Context:
    """What a runner needs of this run."""

    def __init__(self, cell, seed, seconds, trace, device, t_start, fault=None, control=False):
        self.config, self.mix, self.limits = cell.config, cell.mix, cell.limits
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t_start, self.fault = device, t_start, fault
        # the control's reading after the check (readings.py and the tests only)
        self.control = control

    def profiler(self):
        """A profiler of the window in a traced run, else None."""
        if not self.trace:
            return None
        from benchmark.harness.trace import Profiler

        return Profiler(os.path.join(tempfile.gettempdir(), f"bench-trace-{os.getpid()}.json"))

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))


def device_record(device, chips):
    """The card's name and count, and its power limit from ``nvidia-smi``:
    read after the window, so the query's own seconds are not set-up."""
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        rec["power_limit"] = smi[device.index or 0].rsplit(",", 1)[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        rec["power_limit"] = "not read"
    return rec


def per_layer(cell, ctx, outcome):
    """{metric: {value, unit}} of the cell's per-layer metrics whose reader
    finds something to read."""
    from benchmark.harness import spec

    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(ctx, outcome)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell, ctx, outcome, record):
    """The result line's object, ``check`` last."""
    if ctx.trace:
        metrics = per_layer(cell, ctx, outcome)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in outcome.metrics.items()}
        metrics["setup_s"] = {"value": float(outcome.setup_s), "unit": units["setup_s"]}
    device = dict(record, memory_peak_bytes=outcome.memory_peak_bytes)
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    s = outcome.summary
    if ctx.trace and s is not None:
        device.update(busy_s=s.busy_s, window_s=s.window_s)
        line["breakdown"] = {"device_ops": [[n, v] for n, v in s.device_ops],
                             "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    line["check"] = {name: {"value": value, "limit": limit}
                     for name, value, limit in outcome.checks}
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import spec

    cell = spec.cell(args.workload)
    chips = int(cell.workload["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"run: the cell asks for {chips} CUDA device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    found = imports.forbidden()
    if found:
        log(f"run: JAX or the JAX package is loaded: {found}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    tf32 = bool(cell.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    log(f"run: {args.workload} seed {args.seed}; interpreter, imports and the card's "
        f"context took {time.perf_counter() - T_START:.3f} s")
    ctx = Context(cell, args.seed, args.seconds, args.trace, device, T_START)
    outcome = spec.runner(cell.mix).run(ctx)
    found = imports.forbidden()
    if found:
        log(f"run: JAX or the JAX package was loaded by the end of the window: {found}")
        return 3
    record = device_record(device, chips)
    log(f"run: on {record}")
    line = result(cell, ctx, outcome, record)
    for note in outcome.notes:
        log(f"run: {note}")
    log(f"run: setup_s {outcome.setup_s:.4f}; memory peak {outcome.memory_peak_bytes} bytes")
    for name, value, limit in outcome.checks:
        log(f"check {name} = {value!r} (limit {limit!r})")
    log(f"check failed requests = {outcome.failed} (limit 0); correct {outcome.correct}")
    print(json.dumps(_finite(line), allow_nan=False), flush=True)
    return 0


def _finite(x):
    """The line with every non-finite number (a failed run's latency) as null."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())
