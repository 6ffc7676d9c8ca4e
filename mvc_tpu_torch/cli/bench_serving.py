"""Serving load test: closed-loop throughput and open-loop latency percentiles.

    python -m mvc_tpu_torch.cli.bench_serving [--mode direct|beam] [--max_batch 64]
        [--concurrency 1 16 64 256] [--qps-fracs 0.25 0.5 0.9] [--n 2000]
        [--n-open 1000] [--transfer f32|bf16|int8] [--pipeline-depth 2]
        [--skip-ablation] [--http-clients 16] [--http-n 25] [--skip-http]
        [--seed 0] [--device cuda|cpu]

The port of ``scripts/bench_serving.py``: ``CaptionService`` on the card
at the headline decode conditions (the dual model, V=4000, bf16 weights,
T=16 frames, max_len 30, seeded random weights), with the same flags
(``--pallas`` is accepted and changes nothing: the kernels always run on
the card) and the same phases, one JSON line each on stdout (prose on
stderr):

1. closed loop: at most C requests outstanding, for each ``--concurrency``;
2. open loop: Poisson arrivals at ``--qps-fracs`` of the best closed-loop
   rate;
3. HTTP: ``--http-clients`` threads posting ``/caption`` over loopback
   (``serving/http.py``), then the overload phase (``max_queue=1``,
   ``max_batch=1``: what cannot launch at once is shed with 503);
4. the ablation: the top concurrency again at ``pipeline_depth=1``.

Each line keeps the JAX script's keys and adds the card (``device``), the
sample count behind the percentiles (``samples``) and ``attempted``,
``completed`` and ``failed``: completed is a request that got its caption
(in the overload phase, its caption or its 503).  A latency runs from
``submit`` to the caption, as the JAX script times it, also in the open
loop (not from when the request was due; ``late_ms_max`` says how far the
generator fell behind its schedule).  A request that fails makes the run
exit 1 after the lines.  Without a card it exits non-zero and prints
nothing on stdout; ``--device cpu`` runs the plain path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

VOCAB, T, A_DIM, V_DIM, MAX_LEN, WIDTH = 4000, 16, 128, 2048, 30, 5
N_REQUESTS = 64                  # distinct request bodies, reused round robin
HTTP_TIMEOUT_S = 600


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class _ItosDict(dict):
    def __missing__(self, k):
        return f"w{k}"


class _VocabShim:
    """The JAX script's shim: ids -> words, stop at EOS=2."""

    itos = _ItosDict({0: "<PAD>", 1: "<SOS>", 2: "<EOS>", 3: "<UNK>"})

    def __len__(self):
        return VOCAB

    def decode_indexes(self, indexes):
        words = []
        for idx in indexes:
            idx = int(idx)
            if idx == 2:
                break
            words.append(self.itos[idx])
        return " ".join(words)


def pct(lat, p):
    if not lat:
        return None
    lat = sorted(lat)
    return 1e3 * lat[min(len(lat) - 1, int(p * len(lat)))]


class _Tally:
    """Latencies of completed requests and the count of failed ones, from
    future callbacks on the service's completer thread."""

    def __init__(self):
        self.lat, self.failed, self.lock = [], 0, threading.Lock()

    def done(self, t_submit, release):
        def cb(fut):
            with self.lock:
                if fut.exception() is None:
                    self.lat.append(time.perf_counter() - t_submit)
                else:
                    self.failed += 1
            release()
        return cb

    def submit_failed(self, release):
        with self.lock:
            self.failed += 1
        release()


def closed_loop(svc, reqs, concurrency: int, n_total: int):
    """At most ``concurrency`` outstanding requests; returns (rate, tally,
    stats)."""
    svc.reset_stats()
    sem = threading.Semaphore(concurrency)
    tally = _Tally()
    t0 = time.perf_counter()
    for i in range(n_total):
        sem.acquire()
        visual, audio = reqs[i % len(reqs)]
        ts = time.perf_counter()
        try:
            fut = svc.submit(visual, audio)
        except (ValueError, RuntimeError):           # refused at submit: counted
            tally.submit_failed(sem.release)
            continue
        fut.add_done_callback(tally.done(ts, sem.release))
    for _ in range(concurrency):  # drain
        sem.acquire()
    elapsed = time.perf_counter() - t0
    return n_total / elapsed, tally, svc.stats()


def open_loop(svc, reqs, qps: float, n_total: int, rng):
    """Poisson arrivals at ``qps``; latency from submit, by future
    callbacks.  Returns (achieved arrival rate, tally, largest lateness of
    a submit behind its schedule in s)."""
    svc.reset_stats()
    tally = _Tally()
    done = threading.Semaphore(0)
    late = 0.0
    t0 = time.perf_counter()
    next_t = t0
    for i in range(n_total):
        next_t += rng.exponential(1.0 / qps)
        delay = next_t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        visual, audio = reqs[i % len(reqs)]
        ts = time.perf_counter()
        late = max(late, ts - next_t)
        try:
            fut = svc.submit(visual, audio)
        except (ValueError, RuntimeError):
            tally.submit_failed(done.release)
            continue
        fut.add_done_callback(tally.done(ts, done.release))
    t_last_arrival = time.perf_counter()
    for _ in range(n_total):
        done.acquire()
    return n_total / (t_last_arrival - t0), tally, late


def http_load(svc, reqs, n_clients: int, n_per_client: int):
    """Concurrent HTTP clients against the stdlib front end: every request
    is a POST over a loopback socket.  Returns (rate of 200s, latencies,
    codes; None where no reply came)."""
    from mvc_tpu_torch.serving import make_http_server

    server = make_http_server(svc, port=0)
    host, port = server.server_address[:2]
    base = f"http://{host}:{port}"
    t_srv = threading.Thread(target=server.serve_forever, daemon=True)
    t_srv.start()
    payloads = [json.dumps({"visual": v.tolist(), "audio": a.tolist()}).encode()
                for v, a in reqs[: max(8, n_clients)]]
    lat, codes = [], []
    lock = threading.Lock()

    def client(cid):
        for i in range(n_per_client):
            body = payloads[(cid + i) % len(payloads)]
            req = urllib.request.Request(base + "/caption", data=body,
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as resp:
                    resp.read()
                    code = resp.status
            except urllib.error.HTTPError as e:
                code = e.code
            except OSError as e:                 # no reply: counted as failed
                log(f"http client {cid}: {e!r}")
                code = None
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                codes.append(code)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        t_srv.join(timeout=60)
    ok = sum(1 for c in codes if c == 200)
    return ok / wall, sorted(lat), codes


def percentiles(lat):
    return {"p50_ms": pct(lat, 0.5), "p95_ms": pct(lat, 0.95), "p99_ms": pct(lat, 0.99),
            "samples": len(lat)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="direct", choices=["direct", "beam"])
    ap.add_argument("--max_batch", type=int, default=64)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 16, 64, 256])
    ap.add_argument("--qps-fracs", type=float, nargs="*", default=[0.25, 0.5, 0.9])
    ap.add_argument("--n", type=int, default=2000, help="requests per closed-loop point")
    ap.add_argument("--n-open", type=int, default=1000)
    ap.add_argument("--transfer", default="f32", choices=["f32", "bf16", "int8"],
                    help="feature H2D wire format (ServiceConfig.transfer)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="in-flight device batches (ServiceConfig.pipeline_depth)")
    ap.add_argument("--skip-ablation", action="store_true",
                    help="skip the pipeline_depth=1 re-measurement")
    ap.add_argument("--pallas", action="store_true",
                    help="accepted for the JAX command line; the CUDA kernels always run")
    ap.add_argument("--http-clients", type=int, default=16,
                    help="concurrent HTTP client threads for the http phase")
    ap.add_argument("--http-n", type=int, default=25, help="requests per HTTP client")
    ap.add_argument("--skip-http", action="store_true")
    ap.add_argument("--seed", type=int, default=0, help="weights, requests and arrivals")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mvc_tpu_torch.cli.bench import device_record
    from mvc_tpu_torch.models import AVCaptioningDual
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig
    from mvc_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench_serving: {e}") from None
    out = sys.stdout
    results = []

    def emit(entry):
        entry = {**entry, "device": record}
        results.append(entry)
        print(json.dumps(entry), file=out, flush=True)

    with contextlib.redirect_stdout(sys.stderr):
        record = device_record(device)
        log(f"device: {record}")
        model = AVCaptioningDual(vocab_size=VOCAB, dtype=torch.bfloat16, device=device)
        params = model.init(torch.Generator().manual_seed(args.seed))
        vocab = _VocabShim()
        rng = np.random.default_rng(args.seed)
        reqs = [(rng.normal(size=(T, V_DIM)).astype(np.float32),
                 rng.normal(size=(T, A_DIM)).astype(np.float32)) for _ in range(N_REQUESTS)]
        bytes_per_el = {"f32": 4, "bf16": 2, "int8": 1}[args.transfer]
        h2d_mb = args.max_batch * T * (V_DIM + A_DIM) * bytes_per_el / 1e6
        if args.transfer == "int8":  # plus the per-frame f32 scales
            h2d_mb += args.max_batch * T * 2 * 4 / 1e6
        common = dict(max_wait_ms=args.max_wait_ms, frame_buckets=(T,), max_caption_len=MAX_LEN,
                      mode=args.mode, beam_width=WIDTH, audio_dim=A_DIM, visual_dim=V_DIM,
                      transfer=args.transfer)

        def make(depth, **kw):
            cfg = dict(common, max_batch=args.max_batch, pipeline_depth=depth)
            cfg.update(kw)
            svc = CaptionService(model, params, vocab, ServiceConfig(**cfg), device=device)
            svc.warmup([T])
            return svc

        def closed_entry(svc, c, depth):
            n = max(args.n, 4 * c)
            rate, tally, stats = closed_loop(svc, reqs, c, n)
            return {"phase": "closed_loop", "mode": args.mode, "concurrency": c,
                    "captions_per_s": rate, **percentiles(tally.lat),
                    "mean_batch_occupancy": stats["mean_batch_occupancy"],
                    "batches": stats["batches"], "h2d_mb_per_batch": h2d_mb,
                    "max_batch": args.max_batch, "pipeline_depth": depth,
                    "transfer": args.transfer, "attempted": n, "completed": len(tally.lat),
                    "failed": tally.failed}

        best = 0.0
        with make(args.pipeline_depth) as svc:
            for c in args.concurrency:
                e = closed_entry(svc, c, args.pipeline_depth)
                best = max(best, e["captions_per_s"])
                emit(e)
            for frac in args.qps_fracs:
                qps = frac * best
                achieved, tally, late = open_loop(svc, reqs, qps, args.n_open, rng)
                emit({"phase": "open_loop", "mode": args.mode, "target_qps": qps,
                      "achieved_qps": achieved, "frac_of_max": frac, **percentiles(tally.lat),
                      "late_ms_max": 1e3 * late, "max_batch": args.max_batch,
                      "pipeline_depth": args.pipeline_depth, "transfer": args.transfer,
                      "attempted": args.n_open, "completed": len(tally.lat),
                      "failed": tally.failed})

        if not args.skip_http:
            with make(args.pipeline_depth) as svc:
                rate, lat, codes = http_load(svc, reqs, args.http_clients, args.http_n)
                ok = sum(1 for c in codes if c == 200)
                emit({"phase": "http_closed_loop", "mode": args.mode,
                      "clients": args.http_clients, "n": len(codes), "captions_per_s": rate,
                      **percentiles(lat), "http_200": ok, "non_200": len(codes) - ok,
                      "max_batch": args.max_batch, "transfer": args.transfer,
                      "attempted": args.http_clients * args.http_n, "completed": ok,
                      "failed": len(codes) - ok})
            # overload: a one-request queue and max_batch 1, so what cannot
            # launch at once is shed with 503 (the eviction policy is
            # unit-tested; this measures the shed path under HTTP load)
            with make(1, max_batch=1, max_wait_ms=0.5, max_queue=1) as svc:
                rate, lat, codes = http_load(svc, reqs, args.http_clients, args.http_n)
                st = svc.stats()
                ok = sum(1 for c in codes if c == 200)
                shed = sum(1 for c in codes if c == 503)
                emit({"phase": "http_overload", "mode": args.mode,
                      "clients": args.http_clients, "n": len(codes), "served_per_s": rate,
                      "http_200": ok, "http_503_shed": shed, "shed_counter": st["shed"],
                      "max_queue": 1, "attempted": args.http_clients * args.http_n,
                      "completed": ok + shed, "failed": len(codes) - ok - shed})

        if not args.skip_ablation:
            with make(1) as svc:
                emit(closed_entry(svc, max(args.concurrency), 1))
    log("done:", len(results), "measurement points")
    bad = [e["phase"] for e in results if e["completed"] != e["attempted"]]
    if bad:
        raise SystemExit(f"bench_serving: requests failed in {bad}")
    return results


if __name__ == "__main__":
    main()
