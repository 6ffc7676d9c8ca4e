"""The program's spans in a traced window (``harness/spans.py``) on the CPU:
the span readers on a synthetic trace against a hand count, every reader
of the device's events unchanged by the merge, the idle gaps labelled by
the program's spans but never by a request's queue wait, and the harness
as it runs the cells never turns the recorder on."""

import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import run  # noqa: E402
from benchmark.harness import common, spans, spec, trace  # noqa: E402
from benchmark.tests import small  # noqa: E402
from mvc_tpu_torch.utils import tracing  # noqa: E402

BASE_NS = 1_790_000_000_000_000_000
W, C = "caption-service-worker", "caption-service-completer"


def _x(name, cat, ts, dur, correlation=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if correlation is not None:
        e["args"] = {"correlation": correlation}
    return e


# a window of 1000 us: device busy [100, 350] and [600, 800]; each device
# event after its CUDA call (the same correlation id)
EVENTS = [_x(trace.WINDOW, "user_annotation", 0.0, 1000.0),
          _x("cudaLaunchKernel", "cuda_runtime", 95.0, 3.0, 1),
          _x("void greedy_kernel<2>", "kernel", 100.0, 200.0, 1),
          _x("cudaMemcpyAsync", "cuda_runtime", 295.0, 60.0, 2),
          _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 300.0, 50.0, 2),
          _x("cuLaunchKernel", "cuda_driver", 590.0, 3.0, 3),
          _x("beam_kernel", "kernel", 600.0, 200.0, 3),
          _x("aten::copy_", "cpu_op", 880.0, 10.0)]


def _slid(events, by_us):
    """The trace with the beam kernel's record ``by_us`` earlier than it ran."""
    return [dict(e, ts=e["ts"] - by_us) if e["name"] == "beam_kernel" else e for e in events]


def _span(name, thread, start_us, end_us, **ids):
    return (name, thread, BASE_NS + int(start_us * 1000), BASE_NS + int(end_us * 1000), ids)


SPANS = [
    _span("service.queue", W, -50, -10, request=0, batch=0),      # ends before the window
    _span("service.queue", W, 5, 20, request=1, batch=1),
    _span("service.pad", W, 20, 60, batch=1),
    _span("service.h2d", W, 60, 90, batch=1),
    _span("model.predict_tokens", W, 90, 115),
    _span("decode.launch", W, 92, 112),
    _span("service.backpressure", W, 115, 120, batch=1),
    _span("service.launch", W, 20, 120, batch=1),
    _span("service.queue", W, 150, 400, request=2, batch=2),
    _span("service.queue", W, 390, 400, request=3, batch=2),
    _span("service.collect", W, 120, 400, batch=2),
    _span("service.sync", C, 300, 352, batch=1),
    _span("service.complete", C, 300, 380, batch=1),
    _span("service.queue", W, 460, 490, request=4, batch=3),      # shortest range at 475
    _span("service.pad", W, 400, 500, batch=2),
    _span("service.h2d", W, 500, 560, batch=2),
    _span("model.predict_tokens", W, 560, 610),
    _span("decode.launch", W, 580, 605),
    _span("service.backpressure", W, 610, 620, batch=2),
    _span("service.launch", W, 400, 620, batch=2),
    _span("service.sync", C, 800, 805, batch=2),
    _span("service.complete", C, 800, 850, batch=2),
]

READERS = {"queue_wait_p95_ms.serve": 0.25,          # of 10, 15, 30, 250 us: the 4th
           "launch_host_ms.serve": 0.16,             # (100 + 220) / 2 us
           "complete_host_ms.serve": 0.0365,         # (80 - 52 + 50 - 5) / 2 us
           "idle_in_launch_pct.serve": 28.0,         # (80 + 200) us of idle under them / 1000
           "predict_host_ms.serve": 0.0375,          # (25 + 50) / 2 us
           "predict_host_ms.offline": 0.0375}


def _outcome(summary):
    out = common.Outcome(setup_s=1.0, metrics={}, attempted=1, failed=0, checks=[])
    out.layer = {"batch_rows": 12.0, "padded_frame_pct": 90.0, "calls": [(64, 16), (64, 8)],
                 "useful_flops": 1e9, "window_s": 0.001}
    out.summary = summary
    return out


def _ctx(name):
    cell = spec.cell(name)
    return cell, run.Context(cell, 1, 1.0, True, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("name,want", sorted(READERS.items()))
def test_each_span_reader_reads_a_hand_count(name, want):
    s = spans.summarize(EVENTS, BASE_NS, SPANS)
    assert s.window == (0.0, 1000.0) and s.idle == [(0.0, 100.0), (350.0, 600.0), (800.0, 1000.0)]
    got = spec.reader(name)(None, _outcome(s))
    assert got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_span_reader_reads_nothing_without_its_spans(name):
    read = spec.reader(name)
    assert read(None, _outcome(trace.summarize(EVENTS))) is None           # the plain profiler
    assert read(None, _outcome(None)) is None
    assert read(None, _outcome(spans.summarize(EVENTS, BASE_NS, []))) is None
    assert read(None, _outcome(spans.summarize(EVENTS, BASE_NS, SPANS, dropped=1))) is None
    outside = [x[:2] + (x[2] + 10 ** 9, x[3] + 10 ** 9) + x[4:] for x in SPANS]
    assert read(None, _outcome(spans.summarize(EVENTS, BASE_NS, outside))) is None


@pytest.mark.parametrize("cell", small.workloads())
def test_every_accepted_reader_reads_the_same_with_the_spans_merged(cell):
    plain, merged = trace.summarize(EVENTS), spans.summarize(EVENTS, BASE_NS, SPANS)
    for field in ("window_s", "busy_s", "kernels", "device_ops", "idle_pct"):
        assert getattr(plain, field) == getattr(merged, field), field
    assert [v for _, v in plain.idle_gaps] == [v for _, v in merged.idle_gaps]
    c, ctx = _ctx(cell)
    names = [m["name"] for m in c.per_layer]
    assert names
    for name in names:
        a = spec.reader(name)(ctx, _outcome(plain))
        assert a is not None and a == spec.reader(name)(ctx, _outcome(merged)), name


def test_idle_gaps_take_the_programs_labels_but_never_a_queue_wait():
    s = spans.summarize(EVENTS, BASE_NS, SPANS)
    labels = [n.split(" @")[0] for n, _ in s.idle_gaps]
    # 250 us under service.pad (a queue wait is the shortest range there),
    # 200 us under nothing, 100 us under service.pad
    assert labels == ["service.pad", "host idle", "service.pad"]
    assert [round(v * 1e6) for _, v in s.idle_gaps] == [250, 200, 100]


def test_the_idle_time_splits_by_the_innermost_span():
    s = spans.summarize(EVENTS, BASE_NS, SPANS)
    got = {k: round(v * 1e6, 6) for k, v in spans.idle_by_span(s, W).items()}
    assert got == {"none": 220.0, "service.pad": 140.0, "service.h2d": 90.0,
                   "model.predict_tokens": 22.0, "decode.launch": 28.0,
                   "service.collect": 50.0}
    assert sum(spans.idle_by_span(s).values()) == pytest.approx(550e-6)
    got = {k: round(v * 1e6, 6) for k, v in spans.idle_by_span(s, C).items()}
    assert got == {"none": 470.0, "service.complete": 28.0 + 45.0, "service.sync": 2.0 + 5.0}


@pytest.mark.parametrize("events", [_slid(EVENTS, 100.0),
                                    [e for e in EVENTS if e.get("cat") != "cuda_runtime"
                                     and e.get("cat") != "cuda_driver"]],
                         ids=["slid", "unpaired"])
def test_a_window_not_shown_aligned_reads_no_idle_and_labels_no_gap(events):
    """A device event that starts before its own CUDA call (the records
    slid), or no event paired with its call: the idle time is not put
    under any span, while the spans' durations still read."""
    s = spans.summarize(events, BASE_NS, SPANS)
    assert not s.aligned
    assert spans.idle_under_pct(s, "service.launch") is None
    assert s.idle_gaps == trace.summarize(events).idle_gaps
    assert spans.mean_ms(s, "service.launch") == pytest.approx(0.16)
    assert spans.summarize(_slid(EVENTS, 40.0), BASE_NS, SPANS).aligned     # within SLIDE_US


def test_the_clocks_pair_each_decode_kernel_with_its_launch_span():
    from benchmark import traced

    s = spans.summarize(EVENTS, BASE_NS, SPANS)
    assert s.slid == 0 and [c for *_, c in s.launched] == [95.0, 295.0, 590.0]
    got = traced.clocks(s, "greedy_kernel")
    assert got["kernels"] == 1 and got["after_call_us"] == [5.0, 5.0, 5.0]
    assert got["start_us"] == [8.0, 8.0, 8.0] and got["start_after_share"] == 1.0
    assert got["sync_lag_us"] == [52.0, 52.0, 52.0] and got["sync_lag_share"] == 1.0
    got = traced.clocks(s, "beam_kernel")
    assert got["start_us"] == [20.0, 20.0, 20.0] and got["sync_lag_us"] == [5.0, 5.0, 5.0]


def test_without_the_base_time_the_spans_are_left_out():
    s = spans.summarize(EVENTS, None, SPANS)
    assert s.spans == [] and all("host idle" in n or "aten" in n for n, _ in s.idle_gaps)


def test_the_harness_never_turns_the_recorder_on(tmp_path):
    """Untraced and traced with the accepted profiler, the run records no
    span; the span profiler records only inside its window."""
    for traced in (False, True):
        small.run_small("dual-serve-direct", trace=traced)
        assert not tracing.enabled() and tracing.take() == ([], 0)
    cell = small.shrink(spec.cell("dual-serve-direct"))
    ctx = run.Context(cell, 3, 0.6, True, torch.device("cpu"), time.perf_counter())
    made = []

    def profiler():
        made.append(spans.Profiler(str(tmp_path / "trace.json")))
        return made[0]

    ctx.profiler = profiler
    out = spec.runner(cell.mix).run(ctx)
    assert out.correct and out.summary is None           # no device work on the CPU
    assert not tracing.enabled() and tracing.take() == ([], 0)
    names = {x[0] for x in made[0]._spans}
    assert {"service.collect", "service.launch", "service.pad", "service.h2d",
            "model.predict_tokens", "service.complete", "service.sync",
            "service.queue"} <= names
