"""What a ``torch.profiler`` trace of the window says: the device's busy
time as the union of its kernel, copy and memset intervals (work that
overlaps on several streams counts once), the device time of each call
the harness marked, the operations that took most time, and the longest
idle gaps with what the host was doing meanwhile.

The harness marks the traced window with a ``bench.window`` range
(``torch.profiler.record_function``).  The program's calls run one after
another on one stream, so the kernels of a call are those from the end of
the previous call's decode kernel to the end of its own (``per_call``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
WINDOW = "bench.window"


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, merged [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


@dataclass
class Summary:
    """Seconds throughout."""

    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)  # name, start, end (us)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def per_call(summary: Summary, marker: str) -> List[float]:
    """Device seconds of each call in the window, in launch order: the union
    of its kernels' intervals, a call ending with the kernel whose name
    holds ``marker`` (its decode kernel).  Kernels after the last such one
    belong to no whole call."""
    out, iv = [], []
    for name, s, e in summary.kernels:
        iv.append((s, e))
        if marker in name:
            out.append(covered(iv) * 1e-6)
            iv = []
    return out


def summarize(events: Sequence[dict], top: int = 10) -> Optional[Summary]:
    """The summary of a Chrome trace's complete events (``ph == "X"``);
    None when the trace holds no ``bench.window`` range or no device
    event inside it."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in xs if e.get("name") == WINDOW]
    if not windows:
        return None
    w = windows[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    dev_iv = clip([(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device], lo, hi)
    if not dev_iv:
        return None
    busy = union(dev_iv)
    by_name: Dict[str, float] = {}
    for e in device:
        s, t = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi)
        if t > s:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    kernels = sorted((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in device if e.get("cat") == "kernel"
                     and float(e["ts"]) >= lo and float(e["ts"]) + float(e["dur"]) <= hi)
    kernels.sort(key=lambda k: k[1])

    # idle gaps inside the window, labelled by the innermost host range at
    # the gap's middle
    gaps = []
    edges = [(lo, lo)] + busy + [(hi, hi)]
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in xs if e.get("cat") in HOST_CATS and e.get("name") != WINDOW]
    idle = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inside = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = min(inside, key=lambda e: float(e["dur"]))["name"] if inside else "host idle"
        idle.append((f"{label} @{(a - lo) * 1e-6:.4f}s", (b - a) * 1e-6))
    return Summary(window_s=(hi - lo) * 1e-6, busy_s=covered(busy) * 1e-6,
                   kernels=kernels, device_ops=ops,
                   idle_gaps=idle)


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


class Profiler:
    """A ``torch.profiler`` of CPU and CUDA activity around the traced part
    of a window; ``summary()`` after ``stop()``."""

    def __init__(self, out_path: str):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._path = out_path
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._record = record_function
        self._window = None

    def start(self):
        self._prof.start()
        self._window = self._record(WINDOW)
        self._window.__enter__()

    def stop(self, sync):
        sync()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self._prof.export_chrome_trace(self._path)

    def summary(self) -> Optional[Summary]:
        """The trace's summary; the trace file is removed once read."""
        try:
            return summarize(load(self._path))
        finally:
            os.remove(self._path)
