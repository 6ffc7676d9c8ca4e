"""The program's own host spans (``mvc_tpu_torch/utils/tracing.py``) in a
traced window, and the arithmetic of the per-layer readers that read them.

``Profiler`` records the program's spans while the window runs under
``torch.profiler`` (``trace.Profiler``).  The recorder stamps them on the
wall clock, the clock the profiler puts its host events on, so a span
lands on the trace's timeline at ``ts = (t_ns - baseTimeNanoseconds) /
1e3``, on the threads that the profiler does not follow too (the caption
service's worker and completer start before it).  Before the summary is
taken the spans join the trace's events as ``user_annotation`` ranges of
their thread, which only ever label idle gaps: every reader of the
device's events reads the same with them or without.  A request's
``service.queue`` span stays out of the merge (a request waiting labels
no gap).  The summary (``SpanSummary``) keeps every span, the window and
its idle intervals for the readers.

The card's activity records can slide against the host's timeline for
seconds (by up to milliseconds), and then an idle interval no longer lies
under the host work that left the device idle.  Each device event carries
the correlation id of the CUDA call that queued it, a host event on the
host's timeline, and starts after that call begins; a window in which
one starts more than ``SLIDE_US`` before its call has slid.  Its spans
label no gap and ``idle_under_pct`` reads nothing there; so too where the
trace pairs no device event with its call, as nothing then shows the
records in place.

A span is in the window when it ends inside it.  A reader reads nothing
(None) when the window holds none of its spans or when the recording
dropped spans past its limit.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.harness import trace

QUEUE = "service.queue"
CATEGORY = "user_annotation"
CALL_CATS = ("cuda_runtime", "cuda_driver")    # the host calls that queue device work
SLIDE_US = 50.0     # a device event this far before its own call has slid (normally 4-10 us after)

Interval = Tuple[float, float]


@dataclass
class SpanSummary(trace.Summary):
    """``trace.Summary`` with the program's spans, microseconds on the
    trace's timeline: (name, thread, start, end, ids)."""

    spans: List[Tuple[str, str, float, float, dict]] = field(default_factory=list)
    dropped: int = 0
    window: Interval = (0.0, 0.0)
    idle: List[Interval] = field(default_factory=list)
    # the window's device events paired with their CUDA call: name, start, end, call's start (us)
    launched: List[Tuple[str, float, float, float]] = field(default_factory=list)

    @property
    def slid(self) -> int:
        return slid(self.launched)

    @property
    def aligned(self) -> bool:
        return aligned(self.launched)


def mapped(spans, base_ns: int):
    """The recorder's spans on the trace's timeline (microseconds)."""
    return [(name, thread, (s - base_ns) / 1e3, (e - base_ns) / 1e3, ids)
            for name, thread, s, e, ids in spans]


def merged(events: Sequence[dict], spans) -> List[dict]:
    """The trace's events and the mapped spans as host ranges of their
    thread, a request's queue wait left out."""
    return list(events) + [
        {"ph": "X", "cat": CATEGORY, "name": name, "ts": s, "dur": e - s, "pid": "program",
         "tid": thread, "args": ids}
        for name, thread, s, e, ids in spans if name != QUEUE]


def idle_intervals(events: Sequence[dict]) -> Tuple[Interval, List[Interval]]:
    """(the window, its intervals with no kernel, copy or memset running)."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    w = [e for e in xs if e.get("name") == trace.WINDOW][0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    busy = trace.union(trace.clip([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                                   for e in xs if e.get("cat") in trace.DEVICE_CATS], lo, hi))
    edges = [(lo, lo)] + busy + [(hi, hi)]
    return (lo, hi), [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]


def launched(events: Sequence[dict], window: Interval) -> List[Tuple[str, float, float, float]]:
    """The device events that start in the window and whose CUDA call the
    trace holds (the same ``correlation``): (name, start, end, the call's
    start), microseconds, by start."""
    calls = {e["args"]["correlation"]: float(e["ts"]) for e in events
             if e.get("ph") == "X" and e.get("cat") in CALL_CATS
             and "correlation" in (e.get("args") or {})}
    lo, hi = window
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        call = calls.get((e.get("args") or {}).get("correlation"))
        start = float(e["ts"])
        if call is not None and lo <= start <= hi:
            out.append((e["name"], start, start + float(e["dur"]), call))
    return sorted(out, key=lambda x: x[1])


def slid(calls) -> int:
    """The device events of ``launched`` that start more than ``SLIDE_US``
    before their own call."""
    return sum(start < call - SLIDE_US for _, start, _, call in calls)


def aligned(calls) -> bool:
    """Whether ``launched`` shows the device's records in place on the
    host's timeline."""
    return bool(calls) and not slid(calls)


def summarize(events: Sequence[dict], base_ns: Optional[int], spans,
              dropped: int = 0) -> Optional[SpanSummary]:
    """``trace.summarize`` of the events with the spans merged where the
    window is aligned, the spans kept; None where ``trace.summarize`` finds
    no window or no device work.  Without the trace's base time the spans
    cannot be placed and are left out."""
    placed = mapped(spans, base_ns) if base_ns is not None else []
    if not any(e.get("ph") == "X" and e.get("name") == trace.WINDOW and "dur" in e
               for e in events):
        return None
    window, idle = idle_intervals(events)
    calls = launched(events, window)
    s = trace.summarize(merged(events, placed) if aligned(calls) else events)
    if s is None:
        return None
    return SpanSummary(**vars(s), spans=placed, dropped=dropped, window=window, idle=idle,
                       launched=calls)


class Profiler(trace.Profiler):
    """``trace.Profiler`` that records the program's spans in the window
    and merges them into the trace it summarises."""

    def __init__(self, out_path: str):
        super().__init__(out_path)
        self._spans, self._dropped = [], 0

    def start(self):
        from mvc_tpu_torch.utils import tracing

        tracing.enable()
        super().start()

    def stop(self, sync):
        from mvc_tpu_torch.utils import tracing

        try:
            super().stop(sync)
        finally:
            tracing.disable()
            self._spans, self._dropped = tracing.take()

    def summary(self) -> Optional[SpanSummary]:
        """The summary; the trace file is removed once read."""
        try:
            with open(self._path) as f:
                doc = json.load(f)
        finally:
            os.remove(self._path)
        base = doc.get("baseTimeNanoseconds")
        return summarize(doc["traceEvents"], int(base) if base is not None else None,
                         self._spans, self._dropped)


# ------------------------------------------------------------- the readers


def in_window(summary, name: str) -> Optional[list]:
    """The window's spans named ``name``; None where the run kept no
    spans, dropped some, or the window holds none of them."""
    spans = getattr(summary, "spans", None)
    if not spans or summary.dropped:
        return None
    lo, hi = summary.window
    out = [x for x in spans if x[0] == name and lo <= x[3] <= hi]
    return out or None


def mean_ms(summary, name: str) -> Optional[float]:
    """Mean duration of the window's ``name`` spans, ms."""
    xs = in_window(summary, name)
    return None if xs is None else 1e-3 * sum(e - s for _, _, s, e, _ in xs) / len(xs)


def p95_ms(summary, name: str) -> Optional[float]:
    """Nearest-rank 95th percentile of the window's ``name`` spans, ms."""
    xs = in_window(summary, name)
    if xs is None:
        return None
    d = sorted(e - s for _, _, s, e, _ in xs)
    return 1e-3 * d[max(0, math.ceil(0.95 * len(d)) - 1)]


def self_ms(summary, name: str, child: str) -> Optional[float]:
    """Mean self time of the window's ``name`` spans, ms: each one's
    duration less the part of it that its batch's ``child`` spans cover."""
    xs = in_window(summary, name)
    if xs is None:
        return None
    kids: Dict[int, List[Interval]] = {}
    for n, _, s, e, ids in summary.spans:
        if n == child and "batch" in ids:
            kids.setdefault(ids["batch"], []).append((s, e))
    total = 0.0
    for _, _, s, e, ids in xs:
        total += (e - s) - trace.covered(trace.clip(kids.get(ids.get("batch"), []), s, e))
    return 1e-3 * total / len(xs)


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two sorted, merged interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under_pct(summary, name: str) -> Optional[float]:
    """The window's device-idle time under ``name`` spans, over the window,
    %; None where the window is not aligned."""
    spans = getattr(summary, "spans", None)
    if not spans or summary.dropped or not summary.aligned:
        return None
    lo, hi = summary.window
    under = trace.union(trace.clip([(s, e) for n, _, s, e, _ in spans if n == name], lo, hi))
    if not under:
        return None
    return 100.0 * overlap(summary.idle, under) / (hi - lo)


def idle_by_span(summary, thread: Optional[str] = None) -> Dict[str, float]:
    """The window's device-idle seconds by the innermost (shortest)
    program span covering each instant (on ``thread``, else on any
    thread; a request's queue wait never), ``"none"`` where none does."""
    spans = [(s, e, e - s, n) for n, th, s, e, _ in getattr(summary, "spans", [])
             if n != QUEUE and (thread is None or th == thread)]
    cuts = sorted({x for a, b in summary.idle for x in (a, b)}
                  | {x for s, e, _, _ in spans for x in (s, e)})
    spans.sort()
    out: Dict[str, float] = {}
    open_: List[Tuple[float, float, str]] = []       # (duration, end, name) of spans begun
    k = 0
    idle = summary.idle
    g = 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(spans) and spans[k][0] <= a:
            open_.append((spans[k][2], spans[k][1], spans[k][3]))
            k += 1
        open_ = [o for o in open_ if o[1] > a]
        while g < len(idle) and idle[g][1] <= a:
            g += 1
        if g == len(idle) or idle[g][0] > a:
            continue
        label = min(open_)[2] if open_ else "none"
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out
