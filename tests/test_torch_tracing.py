"""The span recorder (``mvc_tpu_torch/utils/tracing.py``) and the spans and
counters of the caption service, on the CPU; the decode wrappers' spans on
the card (skipped inside the test where there is none)."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mvc_tpu_torch.config import DecoderConfig
from mvc_tpu_torch.data import Vocabulary
from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual
from mvc_tpu_torch.serving import CaptionService, ServiceConfig
from mvc_tpu_torch.utils import tracing

A_DIM, V_DIM = 4, 6
TINY_V = dict(rnn_type="LSTM", in_feature_size=V_DIM, rnn_hidden_size=8, embedding_size=4,
              attn_size=4)
TINY_A = dict(rnn_type="LSTM", in_feature_size=A_DIM, rnn_hidden_size=6, embedding_size=4,
              attn_size=4)


@pytest.fixture
def recording():
    """A recording for the test; nothing left on after it."""
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.take()


def _vocab():
    v = Vocabulary(freq_threshold=1)
    v.build_vocabulary(["a man plays a guitar", "a dog runs on grass"])
    return v


def _dual(device, vocab_size):
    model = AVCaptioningDual(vocab_size=vocab_size, reconstructor_type="none", device=device,
                             visual_decoder_config=DecoderConfig(**TINY_V),
                             audio_decoder_config=DecoderConfig(**TINY_A))
    return model, model.init(torch.Generator().manual_seed(0))


def _clips(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(t, V_DIM)).astype(np.float32),
             rng.normal(size=(t, A_DIM)).astype(np.float32)) for t in lengths]


def _within(inner, outer):
    return outer[1] == inner[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def test_off_records_nothing_and_hands_out_one_shared_object():
    assert not tracing.enabled()
    a, b = tracing.span("x"), tracing.span("y", batch=3, request=4)
    assert a is b
    with a as s:
        assert s is a
    tracing.record("z", 1, 2, batch=1)
    assert tracing.traced("f")(lambda x: x + 1)(1) == 2
    assert tracing.take() == ([], 0)


def test_spans_carry_thread_ids_and_nest_by_time(recording):
    @tracing.traced("outer.fn")
    def fn():
        with tracing.span("inner", batch=7, request=9):
            time.sleep(0.001)
        return 5

    assert fn() == 5
    t = tracing.now()
    tracing.record("after.the.fact", t - 3000, t, request=2)
    wall = time.time_ns()
    spans, dropped = tracing.take()
    assert dropped == 0
    by = {s[0]: s for s in spans}
    assert [s[0] for s in spans] == ["inner", "outer.fn", "after.the.fact"]   # by end
    assert by["inner"][4] == {"batch": 7, "request": 9} and by["outer.fn"][4] == {}
    _, _, s, e, ids = by["after.the.fact"]
    assert ids == {"request": 2} and abs((e - s) - 3000) <= 1 and 0 <= wall - e < 1_000_000
    assert _within(by["inner"], by["outer.fn"])
    assert by["inner"][3] - by["inner"][2] >= 1_000_000
    assert all(s[1] == threading.current_thread().name for s in spans)
    tracing.disable()
    with tracing.span("off"):
        pass
    assert tracing.take() == ([], 0)


def test_the_limit_counts_what_does_not_fit_under_many_threads(monkeypatch):
    """More threads than cores, a short switch interval: every span is
    either kept or counted, none lost."""
    threads, each, limit = 32, 200, 2500
    monkeypatch.setattr(tracing, "LIMIT", limit)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    tracing.enable()
    try:
        def work():
            for i in range(each):
                with tracing.span("s", batch=i):
                    pass

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
        spans, dropped = tracing.take()
    finally:
        tracing.disable()
        sys.setswitchinterval(old)
    assert len(spans) == limit and dropped == threads * each - limit
    assert tracing.take() == ([], 0)


def _serve(lengths, config, trace):
    vocab = _vocab()
    model, params = _dual("cpu", len(vocab))
    if trace:
        tracing.enable()
    try:
        with CaptionService(model, params, vocab, config, device="cpu") as svc:
            futs = [svc.submit(v, a) for v, a in _clips(lengths)]
            caps = [f.result(timeout=120) for f in futs]
            stats = svc.stats()
            svc.reset_stats()
            after = svc.stats()
    finally:
        tracing.disable()
    spans, dropped = tracing.take()
    return caps, stats, after, spans, dropped


SERVICE = dict(max_batch=4, max_wait_ms=200.0, frame_buckets=(8, 16), max_caption_len=5,
               audio_dim=A_DIM, visual_dim=V_DIM)


def test_every_batch_has_its_spans_and_every_request_its_queue_wait():
    lengths = [5, 8, 3, 7, 6, 2, 8, 4, 5]          # all in the 8-frame bucket
    caps, stats, after, spans, dropped = _serve(lengths, ServiceConfig(**SERVICE), trace=True)
    assert len(caps) == len(lengths) and dropped == 0
    named = {}
    for s in spans:
        named.setdefault(s[0], []).append(s)
    launches = {s[4]["batch"]: s for s in named["service.launch"]}
    assert len(launches) == stats["batches"] >= 3
    assert all(s[1] == "caption-service-worker" for s in named["service.launch"])
    # one collect per batch launched (the last one ends at close, with no batch)
    collects = {s[4]["batch"] for s in named["service.collect"]}
    assert set(launches) <= collects and len(collects) == len(launches) + 1
    for child in ("service.pad", "service.h2d", "service.backpressure"):
        kids = {s[4]["batch"]: s for s in named[child]}
        assert set(kids) == set(launches)
        assert all(_within(kids[b], launches[b]) for b in launches)
    predicts = named["model.predict_tokens"]
    assert len(predicts) == len(launches)
    assert all(sum(_within(p, launch) for p in predicts) == 1 for launch in launches.values())
    completes = {s[4]["batch"]: s for s in named["service.complete"]}
    syncs = {s[4]["batch"]: s for s in named["service.sync"]}
    assert set(completes) == set(syncs) == set(launches)
    assert all(_within(syncs[b], completes[b]) for b in launches)
    assert all(s[1] == "caption-service-completer" for s in completes.values())
    assert all(completes[b][2] >= launches[b][2] for b in launches)
    queue = named["service.queue"]
    assert sorted(s[4]["request"] for s in queue) == list(range(1, len(lengths) + 1))
    assert all(s[4]["batch"] in launches and s[2] <= s[3] for s in queue)
    # a request waits in the queue until its batch's collect takes it
    for s in queue:
        coll = [c for c in named["service.collect"] if c[4]["batch"] == s[4]["batch"]][0]
        assert coll[2] <= s[3] <= coll[3]
    assert "decode.prepare" not in named          # the CPU path launches no kernel


def test_the_new_counters_equal_a_hand_count_and_reset():
    lengths = [5, 8, 3, 7, 6, 2, 8, 4, 5]
    caps, stats, after, spans, _ = _serve(lengths, ServiceConfig(**SERVICE), trace=False)
    assert spans == []
    assert stats["frames_real"] == sum(lengths)
    assert stats["frames_launched"] == stats["batches"] * SERVICE["max_batch"] * 8
    assert 0.0 <= stats["queue_wait_ms_p50"] <= stats["queue_wait_ms_p95"]
    assert stats["queue_wait_ms_p95"] <= stats["latency_ms_p95"]
    assert stats["queue_depth"] == 0
    assert after["frames_launched"] == after["frames_real"] == 0
    assert after["queue_wait_ms_p50"] is None and after["queue_wait_ms_p95"] is None


def test_the_queue_wait_ends_where_a_batch_takes_the_request():
    """One request at a time: each waits about nothing; a batch held by a
    long window makes the first request wait out the window."""
    cfg = ServiceConfig(**dict(SERVICE, max_wait_ms=150.0))
    vocab = _vocab()
    model, params = _dual("cpu", len(vocab))
    with CaptionService(model, params, vocab, cfg, device="cpu") as svc:
        for v, a in _clips([4, 4, 4, 4]):
            svc.submit(v, a).result(timeout=120)
        st = svc.stats()
    assert st["requests"] == 4 and st["batches"] == 4
    # a lone request is taken at once; the window that follows is not queue wait
    assert st["queue_wait_ms_p95"] < 100.0 < st["latency_ms_p50"]


def test_untraced_service_records_nothing():
    caps, stats, _, spans, dropped = _serve([4, 6], ServiceConfig(**SERVICE), trace=False)
    assert len(caps) == 2 and spans == [] and dropped == 0 and not tracing.enabled()


def test_program_spans_land_on_the_profilers_clock(tmp_path, recording):
    """A span around a main-thread ``record_function`` range lies within
    1 ms of it in the exported trace, once mapped by baseTimeNanoseconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with tracing.span("program.span"):
            with record_function("profiler.range"):
                time.sleep(0.005)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    ev = [e for e in doc["traceEvents"] if e.get("name") == "profiler.range"][0]
    spans, _ = tracing.take()
    (_, _, s, e, _), = [x for x in spans if x[0] == "program.span"]
    start_us, end_us = (s - base) / 1e3, (e - base) / 1e3
    assert abs(start_us - float(ev["ts"])) < 1000.0
    assert abs(end_us - (float(ev["ts"]) + float(ev["dur"]))) < 1000.0
    assert start_us <= float(ev["ts"]) + 1.0 and end_us >= float(ev["ts"]) + float(ev["dur"]) - 1.0


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("mode", ["direct", "beam"])
def test_decode_wrappers_record_prepare_then_launch_on_the_card(single, mode, recording):
    """On the card, each kernel call is ``decode.prepare`` then
    ``decode.launch`` inside ``model.predict_tokens``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode kernels run only there")
    dev = torch.device("cuda", 0)
    V, B, T = 20, 3, 6
    if single:
        model = AVCaptioning(vocab_size=V, reconstructor_type="none", device=dev,
                             decoder_config=DecoderConfig(**dict(TINY_V,
                                                                 in_feature_size=A_DIM + V_DIM)))
    else:
        model = AVCaptioningDual(vocab_size=V, reconstructor_type="none", device=dev,
                                 visual_decoder_config=DecoderConfig(**TINY_V),
                                 audio_decoder_config=DecoderConfig(**TINY_A))
    params = model.init(torch.Generator().manual_seed(0))
    audio = torch.randn(B, T, A_DIM, device=dev)
    visual = torch.randn(B, T, V_DIM, device=dev)
    tracing.take()
    model.predict_tokens(params, audio, visual, max_caption_len=5, mode=mode, beam_width=3)
    torch.cuda.synchronize(dev)
    spans, dropped = tracing.take()
    assert dropped == 0
    assert [s[0] for s in spans] == ["decode.prepare", "decode.launch", "model.predict_tokens"]
    prepare, launch, predict = spans
    assert prepare[3] <= launch[2]
    assert _within(prepare, predict) and _within(launch, predict)
