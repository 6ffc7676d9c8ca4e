"""Online captioning: an open loop of Poisson arrivals submitted in-process
to ``CaptionService.submit`` (traffic runner ``serve``).

Each request is timed from when it was due to the moment its caption is
in hand (its future resolved); one that fails counts as missing.  Clips
are slices of a pool of seeded clips, at lengths from the mix's
distribution.  After the window, a sample of the finished requests drawn
from the seed, the longest among them, is held against the plain
reference: the widest gap by which a served token's log-prob lies below
the reference's best at its step (``reference.recnet.greedy_gaps``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.harness import common, counts, traffic
from benchmark.reference import recnet

DRAIN_S = 60.0          # how long past the window's close a request may still finish
# a decoder's own pick within this many nats of a tie goes either way by
# rounding (float32 logits of the kernel and the reference differ by ~1e-6)
TIE_NATS = 3e-5


class Load:
    """The mix's requests for one seed: due times, lengths, pool rows."""

    def __init__(self, mix: dict, seconds: float, seed: int, rate: Optional[float] = None):
        self.rate = float(rate if rate is not None else mix["rate_per_s"])
        n = max(1, int(self.rate * seconds))
        self.due = traffic.poisson_arrivals(self.rate, n, seed, 1)
        self.lengths = traffic.sizes(mix["frames"], n, seed, 2)
        self.pool_rows = traffic.rng(seed, 3).integers(0, mix["pool_clips"], size=n)


def service_config(config: dict, mix: dict):
    from mvc_tpu_torch.serving import ServiceConfig

    s = mix["service"]
    return ServiceConfig(max_batch=s["max_batch"], max_wait_ms=s["max_wait_ms"],
                         frame_buckets=tuple(s["frame_buckets"]), mode=s["mode"],
                         max_caption_len=s["max_caption_len"], transfer=s["transfer"],
                         pipeline_depth=s["pipeline_depth"],
                         visual_dim=config["features"]["visual"],
                         audio_dim=config["features"]["audio"])


class Setup:
    """The service, its weights and the pool of clips, warmed on the
    buckets the mix uses."""

    def __init__(self, config: dict, mix: dict, seed: int, device, fault=None):
        from mvc_tpu_torch.serving import CaptionService

        self.config, self.mix, self.device = config, mix, torch.device(device)
        self.phases = common.Phases()
        self.params = common.weights_for(config, seed, self.device)
        self.vocab = common.vocab(config)
        self.calls = common.Calls(common.model(config, self.device), fault=fault)
        self.phases.mark("weights and model")
        top = int(mix["frames"]["max"])
        self.audio, self.visual = common.clip_features(
            config, mix["pool_clips"], top, [top] * mix["pool_clips"], seed, 4, self.device)
        self.phases.mark("clips")
        self.service = CaptionService(self.calls, self.params, self.vocab,
                                      service_config(config, mix), device=self.device)
        buckets = sorted({traffic.bucket(int(t), mix["service"]["frame_buckets"])
                          for t in traffic.quantiles(mix["frames"], 1000)})
        self.service.warmup(buckets)
        common.sync(self.device)
        self.phases.mark("service and warm-up")

    def close(self):
        self.service.close()


def drive(setup: Setup, load: Load, seconds: float, on_window_start=None) -> Dict[str, object]:
    """Submit the load on its schedule and wait for every answer.  Returns
    latencies (s, inf where a request failed), captions, lateness of the
    generator, window start."""
    n = len(load.due)
    done = np.full(n, np.nan)
    captions: List[Optional[str]] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    finished = threading.Semaphore(0)

    def stamp(i):
        def cb(fut):
            done[i] = time.perf_counter()
            if fut.exception() is None:
                captions[i] = fut.result()
            else:
                errors[i] = fut.exception()
            finished.release()
        return cb

    svc = setup.service
    svc.reset_stats()
    setup.calls.reset()
    if on_window_start is not None:
        on_window_start()
    t0 = time.perf_counter()
    late = np.zeros(n)
    for i in range(n):
        due = t0 + load.due[i]
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
            now = time.perf_counter()
        late[i] = now - due
        row, t = int(load.pool_rows[i]), int(load.lengths[i])
        try:
            fut = svc.submit(setup.visual[row, :t], setup.audio[row, :t])
        except Exception as e:            # refused at submit: a failed request
            errors[i] = e
            done[i] = np.inf
            finished.release()
            continue
        fut.add_done_callback(stamp(i))
    close = t0 + seconds
    for _ in range(n):
        if not finished.acquire(timeout=max(0.0, close + DRAIN_S - time.perf_counter())):
            break
    t_last = time.perf_counter()
    lat = np.where(np.isnan(done), np.inf, done - (t0 + load.due))
    lat[[e is not None for e in errors]] = np.inf
    return {"latency": lat, "captions": captions, "late": late, "t0": t0, "t_last": t_last,
            "stats": svc.stats(), "errors": errors}


def p95(lat: np.ndarray) -> float:
    """Nearest-rank 95th percentile (an infinite latency is a failure)."""
    s = np.sort(lat)
    return float(s[max(0, math.ceil(0.95 * len(s)) - 1)])


def check(setup: Setup, load: Load, res: dict, n_check: int, seed: int):
    """(widest token gap in nats, sampled request ids): a sample of the
    finished requests drawn from the seed, the longest among them, against
    the plain reference at each clip's own length."""
    ok = [i for i, c in enumerate(res["captions"]) if c is not None]
    if not ok:
        return (math.inf, 0, 0), []
    pick = common.sample(ok, load.lengths, n_check, seed)
    return gaps(setup, load, res["captions"], pick), pick


def gaps(setup: Setup, load: Load, captions, pick, decode=None):
    """(widest gap, positions compared, positions served) over the requests
    ``pick`` whose served captions are ``captions``; ``decode`` (the
    control) replaces the served tokens by its own for the same clips."""
    cfg = setup.config
    steps = int(setup.mix["service"]["max_caption_len"]) - 1
    decoders = common.decoder_params(cfg, setup.params)
    worst, compared, total = 0.0, 0, 0
    dev = setup.device
    for T, idx in recnet.by_length([int(load.lengths[i]) for i in pick]).items():
        rows = [int(load.pool_rows[pick[j]]) for j in idx]
        audio = torch.from_numpy(setup.audio[rows, :T]).to(dev)
        visual = torch.from_numpy(setup.visual[rows, :T]).to(dev)
        feats = common.reference_feats(cfg, audio, visual)
        if decode is not None:
            served = decode(decoders, feats, steps)
            lengths = torch.full((len(idx),), steps, device=dev)
        else:
            ids = [common.text_to_ids(captions[pick[j]]) for j in idx]
            lengths = torch.tensor([min(len(x) + 1, steps) for x in ids], device=dev)
            served = torch.tensor([(x + [recnet.EOS_ID])[:steps] + [0] * (steps - len(x) - 1)
                                   for x in ids], device=dev).clamp(min=0)
        with recnet.precision(tf32=False):
            g, n = recnet.greedy_gaps(decoders, feats, served.long(), lengths, TIE_NATS)
        worst = max(worst, float(g.max()))
        compared += int(n.sum())
        total += int(lengths.sum())
    return worst, compared, total


def useful_flops(config: dict, lengths, steps: int) -> float:
    """Model FLOPs of the real rows and frames of the given requests."""
    d = common.decs(config)
    return float(sum(counts.decode_flops(d, int(t), 1, 1, steps) for t in lengths))


def run(ctx) -> "common.Outcome":
    """One run of a ``serve`` cell (``ctx``: see ``run.py``)."""
    mix, cfg = ctx.mix, ctx.config
    setup = Setup(cfg, mix, ctx.seed, ctx.device, fault=ctx.fault)
    load = Load(mix, ctx.seconds, ctx.seed)
    prof = ctx.profiler()
    setup_s = time.perf_counter() - ctx.t_start
    res = drive(setup, load, ctx.seconds, on_window_start=prof.start if prof else None)
    if prof:
        prof.stop(lambda: common.sync(setup.device))
    memory = ctx.memory_peak()
    calls = list(setup.calls.log)
    stats = res["stats"]
    setup.close()
    lat = res["latency"]
    failed = int(np.isinf(lat).sum())
    (gap, compared, total), pick = check(setup, load, res, mix["check_requests"], ctx.seed)
    finite = np.sort(lat[np.isfinite(lat)])
    steps = int(mix["service"]["max_caption_len"]) - 1
    out = common.Outcome(
        setup_s=setup_s, metrics={"caption_p95_ms": 1e3 * p95(lat)}, attempted=len(lat),
        failed=failed, checks=[("token_gap_nats", gap, ctx.limits.get("token_gap_nats"))],
        memory_peak_bytes=memory)
    if len(finite):
        out.notes.append(
            f"requests {len(lat)} at {load.rate:g}/s; latency from due time p50 "
            f"{1e3 * finite[len(finite) // 2]:.3f} ms, p95 {1e3 * p95(lat):.3f} ms, p99 "
            f"{1e3 * finite[min(len(finite) - 1, math.ceil(0.99 * len(finite)) - 1)]:.3f} ms; "
            f"within the mix's {mix['limit_ms']} ms: "
            f"{100.0 * float((lat <= mix['limit_ms'] / 1e3).mean()):.2f} %; generator late by "
            f"at most {1e3 * float(res['late'].max()):.3f} ms; batches {stats['batches']}, "
            f"mean rows {stats['mean_batch_occupancy']}")
    out.notes.append(f"checked {len(pick)} requests: {compared} of {total} served positions "
                     f"(the rest follow a decoder's own pick within {TIE_NATS} nats of a tie)")
    out.notes.append(str(setup.phases))
    launched = sum(rows * frames for rows, frames in calls)
    real = float(load.lengths[np.isfinite(lat)].sum())
    out.layer = {
        "batch_rows": stats["mean_batch_occupancy"],
        "padded_frame_pct": 100.0 * (1.0 - real / launched) if launched else None,
        "calls": calls, "useful_flops": useful_flops(cfg, load.lengths[np.isfinite(lat)], steps),
    }
    out.summary = prof.summary() if prof else None
    if ctx.control:
        out.layer["control"] = gaps(setup, load, None, pick, decode=control_decode)[0]
    return out


def control_decode(decoders, feats, steps):
    """The control: the reference in the program's place, its matrix
    products in TF32, the precision below the configuration's."""
    with recnet.precision(tf32=True):
        return recnet.greedy(decoders, feats, steps)
