"""The benchmark's yardstick: hand-worked FLOP counts at small shapes, the
formulation chosen by shape, bytes, and the device's busy time as a union
of intervals."""

import itertools
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import counts, trace  # noqa: E402

SMALL = counts.Dec(F=3, E=2, H=1, A=2, V=5)     # 4 gates: GH = 4


def test_one_step_takes_the_context_first():
    # keys 2*T*F*A = 24; a row-step: query 2HA 4, energies 2TA 8, gates
    # 2E*GH 16 + 2H*GH 8, vocab 2HV 10 = 46; context first 2TF + 2F*GH = 36
    # against frames projected 2TF*GH + 2T*GH = 64
    assert counts.decode_flops([SMALL], T=2, clips=1, rows_per_clip=1, steps=1) == 24 + 46 + 36


def test_ten_steps_take_the_frames_projected_once():
    # context first 10 * 36 = 360 against projected once 48 + 10 * 16 = 208
    assert counts.decode_flops([SMALL], T=2, clips=1, rows_per_clip=1, steps=10) == \
        24 + 460 + 208


def test_beam_rows_share_one_projection_a_clip():
    # 2 clips, W=3, 10 steps: 60 row-steps; projected once a clip: 2 * 48 + 60 * 16
    want = 2 * 24 + 60 * 46 + min(60 * 36, 2 * 48 + 60 * 16)
    assert counts.decode_flops([SMALL], T=2, clips=2, rows_per_clip=3, steps=10) == want


@pytest.mark.parametrize("T,steps,rows", list(itertools.product((1, 4, 64, 1024), (1, 8, 31),
                                                                 (1, 5))))
def test_the_count_is_the_cheaper_formulation(T, steps, rows):
    """No implementation of either exact formulation can do less work than
    is counted, so a share of the peak cannot pass 100 %."""
    for d in (counts.Dec(2048, 300, 512, 256, 4000), counts.Dec(128, 300, 512, 256, 4000)):
        GH = 4 * d.H
        rs = 3 * rows * steps
        first = rs * (2 * T * d.F + 2 * d.F * GH)
        projected = 3 * 2 * T * d.F * GH + rs * 2 * T * GH
        rest = 3 * 2 * T * d.F * d.A + rs * (2 * d.H * d.A + 2 * T * d.A + 2 * d.E * GH
                                             + 2 * d.H * GH + 2 * d.H * d.V)
        got = counts.decode_flops([d], T, 3, rows, steps)
        assert got == rest + min(first, projected)
        assert got <= rest + first and got <= rest + projected


def test_decoder_parameters_match_the_published_model():
    """The dual model with global reconstructors has 40,887,872 parameters."""
    v = counts.Dec(2048, 300, 512, 256, 4000)
    a = counts.Dec(128, 300, 512, 256, 4000)
    rec = sum(2 * 512 * 4 * F + F * 4 * F + 2 * 4 * F for F in (2048, 128))
    assert v.params + a.params + rec == 40_887_872


def test_bytes_and_bound():
    nbytes = counts.decode_bytes([SMALL], 3, B=2, T=2, out_cols=4)
    assert nbytes == 2 * 2 * 3 * 4 + 2 * 2 * 4 + SMALL.params * 4 + 2 * 4 * 4
    assert counts.bound_seconds(67e12, 1.0) == pytest.approx(1.0)
    assert counts.bound_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_train_step_is_three_forwards():
    d = [counts.Dec(2048, 300, 512, 256, 4000)]
    fwd = counts.decode_flops(d, 10, 4, 1, 7) + counts.reconstructor_flops(2048, 512, 7, 4)
    assert counts.train_step_flops(d, T=10, L=8, B=4) == 3 * fwd


def test_overlapping_intervals_count_once():
    assert trace.covered([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert trace.union([(5, 15), (0, 10), (15, 16)]) == [(0, 16)]


def _ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def test_trace_summary_unions_streams_and_splits_calls():
    events = [
        _ev("bench.window", "user_annotation", 1000, 1000),
        _ev("gemm", "kernel", 1200, 100, tid=7),
        _ev("decode_kernel<float>", "kernel", 1250, 150, tid=8),    # overlaps gemm
        _ev("cast", "kernel", 1410, 20, tid=7),                     # the next call's
        _ev("decode_kernel<float>", "kernel", 1430, 50, tid=7),
        _ev("gemm", "kernel", 1500, 10, tid=7),                     # no whole call
        _ev("Memcpy HtoD", "gpu_memcpy", 1600, 100, tid=7),
        _ev("aten::copy_", "cpu_op", 1500, 400),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx(380e-6)           # [200, 400), [410, 480), [500, 510), [600, 700)
    assert trace.per_call(s, "decode_kernel") == [pytest.approx(200e-6), pytest.approx(70e-6)]
    assert s.idle_pct == pytest.approx(62.0)
    assert s.idle_gaps[0][1] == pytest.approx(300e-6)       # [700, 1000), the longest
    assert s.idle_gaps[0][0].startswith("aten::copy_")
    assert [n for n, _ in s.device_ops][:2] == ["decode_kernel<float>", "gemm"]


def test_trace_without_device_work_reads_nothing():
    assert trace.summarize([_ev("bench.window", "user_annotation", 0, 10)]) is None
