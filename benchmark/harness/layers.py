"""Arithmetic the per-layer readers share: a decode kernel's share of its
roofline and the model's share of the float32 peak."""

from __future__ import annotations

from typing import Optional

from benchmark.harness import common, counts, trace


def decode_shape(mix: dict):
    """(rows a clip, steps a row, token columns out) of the mix's decode."""
    s = mix.get("service", mix)
    L = int(s["max_caption_len"])
    if s["mode"] == "beam":
        return int(s["beam_width"]), L + 1, L + 2
    return 1, L - 1, L


def decode_roofline(ctx, outcome, marker: str) -> Optional[float]:
    """The traced calls' least time at the published peaks (their counted
    FLOPs and bytes at the launched shapes) over the device time of every
    kernel they launched (``trace.per_call``: a call ends with the kernel
    whose name holds ``marker``), in %; None without a traced call."""
    s = outcome.summary
    seconds = trace.per_call(s, marker) if s is not None else []
    if not seconds:
        return None
    rows_per_clip, steps, cols = decode_shape(ctx.mix)
    decs = common.decs(ctx.config)
    dim = common.feature_dim(ctx.config)
    calls = outcome.layer["calls"]
    bound = device = 0.0
    for (B, T), sec in zip(calls, seconds):
        bound += counts.bound_seconds(counts.decode_flops(decs, T, B, rows_per_clip, steps),
                                      counts.decode_bytes(decs, dim, B, T, cols))
        device += sec
    return 100.0 * bound / device


def busy_mfu(outcome) -> Optional[float]:
    """Useful model FLOPs over the device's busy time at the float32 peak, %."""
    s = outcome.summary
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * outcome.layer["useful_flops"] / (s.busy_s * counts.PEAK_F32_FLOPS)


def window_mfu(outcome) -> Optional[float]:
    """Useful model FLOPs over the window at the float32 peak, %."""
    w = outcome.layer.get("window_s")
    if not w:
        return None
    return 100.0 * outcome.layer["useful_flops"] / (w * counts.PEAK_F32_FLOPS)


def idle_pct(outcome) -> Optional[float]:
    s = outcome.summary
    return None if s is None else s.idle_pct
