"""A cell of the benchmark shrunk to run on the CPU: the configuration's
widths and the mix's sizes cut down, the program's plain path in place
of the kernels, the cell's own limits."""

import time

import torch

from benchmark import run
from benchmark.harness import spec

WIDTHS = {2048: 12, 128: 4, 2176: 16}


def shrink(cell):
    c = dict(cell.config, embedding_size=8, hidden_size=16, attn_size=8, vocab_size=64,
             features={"audio": 4, "visual": 12})
    c["decoders"] = {k: WIDTHS[v] for k, v in cell.config["decoders"].items()}
    cell.config = c
    m = dict(cell.mix)
    if m["runner"] == "serve":
        # a longer batching wait, so batches hold several rows at this rate
        m.update(rate_per_s=150.0, pool_clips=16, check_requests=8,
                 service=dict(m["service"], max_wait_ms=50.0))
    elif m["runner"] == "offline":
        m.update(clips=150, check_clips=16)
    cell.mix = m
    return cell


def run_small(name, seed=3, seconds=0.6, trace=False, fault=None, control=False):
    """One shrunk run of the cell ``name`` (or a ``spec.Cell``) on the CPU:
    (cell, ctx, outcome)."""
    torch.manual_seed(0)
    cell = shrink(spec.cell(name) if isinstance(name, str) else name)
    ctx = run.Context(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(),
                      fault=fault, control=control)
    return cell, ctx, spec.runner(cell.mix).run(ctx)


def workloads():
    return [w["name"] for w in spec.benchmark()["workloads"]]
