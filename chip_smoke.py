#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

1. the card: its name, and ``nvidia-smi``'s name and power limit
2. build every CUDA source of ``mvc_tpu_torch/csrc`` with nvcc for sm_90a
3. each kernel against its plain PyTorch version on the card, at the
   serving shape (B=64, T=16, L=30, V=4000, full widths)
4. serving: ``AVCaptioningDual`` at full width with seeded random weights,
   ``CaptionService(max_batch=64)`` behind ``make_http_server``, a few dozen
   requests through ``POST /caption`` and ``/caption_batch``; the kernels'
   launch counts are set to 0 just before and read just after
5. times with CUDA events (warm-up excluded): kernel, plain version, bound

The line before the last is the kernels' JSON record; the last line is the
device record.  Exits non-zero with no record when no CUDA device is there.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

V, B, T, L = 4000, 64, 16, 30
PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
PEAK_BYTES = 3.35e12         # H100 SXM HBM3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def synthetic_vocab(size):
    from mvc_tpu_torch.data import Vocabulary

    vocab = Vocabulary(freq_threshold=1)
    for i in range(len(vocab), size):
        vocab.itos[i] = f"w{i}"
    vocab.stoi = {w: i for i, w in vocab.itos.items()}
    return vocab


def decode_inputs(seed, device, b=B, t=T):
    g = torch.Generator().manual_seed(seed)
    vf = torch.randn(b, t, 2048, generator=g).to(device)
    af = torch.randn(b, t, 128, generator=g).to(device)
    mask = torch.ones(b, t, dtype=torch.bool)
    mask[::3, (2 * t) // 3:] = False  # padded frames
    mask[-1] = False                  # an all-masked (batch padding) row
    return vf, af, mask.to(device)


def spread_bias(decoders, seed, scale=2e-3):
    """Spread the vocab biases (a seeded permutation x scale) so the argmax
    decisions stay clear of near-ties; tokens still vary row to row."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(V, generator=g).float() * scale
    out = []
    for p in decoders:
        p = {k: dict(v) for k, v in p.items()}
        p["out"]["b"] = p["out"]["b"] + perm.to(p["out"]["b"].device)
        out.append(p)
    return out


def function_work(decoders, cells, weight_bytes):
    """FLOPs and bytes of one dual_greedy_decode call at (B, T, L, V):
    the keys/P matmuls outside the kernel, then per row and step the query,
    energies, context or P-sum, gates and vocab projection of each decoder.
    Bytes: each input read once, the tokens written once."""
    from mvc_tpu_torch.ops.dual_greedy import _use_factored

    flops_pre = flops_kernel = 0
    nbytes = B * T * 4 + B * L * 4
    for p, cell, F in zip(decoders, cells, (2048, 128)):
        E = p["embedding"]["table"].shape[1]
        H = p["rnn"]["wh"].shape[0]
        GH = p["rnn"]["wh"].shape[1]
        A = p["attention"]["W"].shape[1]
        fac = _use_factored(B * T, F, GH)
        flops_pre += 2 * B * T * F * A + (2 * B * T * F * GH if fac else 0)
        kx = E if fac else E + F
        per = (2 * H * A + 2 * T * A + 2 * T * (GH if fac else F)
               + 2 * kx * GH + 2 * H * GH + 2 * H * V)
        flops_kernel += B * (L - 1) * per
        nbytes += B * T * F * 4 + sum(t.numel() for sub in p.values() for t in sub.values()) * weight_bytes
    return flops_pre, flops_kernel, nbytes


def check_kernel(dg, decoders, feats, mask, cells, dtype, exact):
    tok_k = dg.dual_greedy_decode(decoders, feats, mask, L, dtype, cells)
    torch.cuda.synchronize()
    tok_p = dg.dual_greedy_decode_reference(decoders, feats, mask, L, dtype, cells)
    same = (tok_k == tok_p).float().mean().item()
    err = (tok_k.long() - tok_p.long()).abs().max().item()
    log(f"kernel vs plain {cells} {dtype} B={mask.shape[0]} T={mask.shape[1]}: "
        f"equal tokens {same:.6f}, "
        f"unique tokens {len(torch.unique(tok_p[:, 1:]))}, column 0 zero "
        f"{bool((tok_k[:, 0] == 0).all())}")
    if not bool((tok_k[:, 0] == 0).all()) or ((tok_k < 0) | (tok_k >= V)).any():
        raise SystemExit("kernel tokens break the output contract")
    if exact and same != 1.0:
        raise SystemExit(f"kernel disagrees with its plain version ({cells}, {dtype})")
    return float(err)


def serve(model, params, vocab, device):
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server

    rng = np.random.default_rng(0)

    def clip():
        t = int(rng.integers(3, 41))
        return {"visual": rng.normal(size=(t, 2048)).astype(np.float32).round(3).tolist(),
                "audio": rng.normal(size=(t, 128)).astype(np.float32).round(3).tolist()}

    singles = [clip() for _ in range(24)]
    batches = [[clip() for _ in range(12)] for _ in range(2)]
    svc = CaptionService(model, params, vocab, ServiceConfig(max_batch=64), device=device)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    try:
        t0 = time.perf_counter()
        warmed = svc.warmup()
        log(f"warmup t_pads {warmed} in {time.perf_counter() - t0:.2f} s")
        svc.reset_stats()
        results, errors = [None] * len(singles), []

        def client(i):
            try:
                results[i] = post("/caption", singles[i])["caption"]
            except Exception as e:           # reported below; the phase fails
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(singles))]
        for th in threads:
            th.start()
        batch_caps = [post("/caption_batch", {"items": items})["captions"] for items in batches]
        for th in threads:
            th.join(timeout=300)
        if errors or any(th.is_alive() for th in threads):
            raise SystemExit(f"caption requests failed: {errors}")
        captions = results + [c for caps in batch_caps for c in caps]
        stats = svc.stats()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        svc.close()
    n = len(singles) + sum(len(b) for b in batches)
    if len(captions) != n or not all(isinstance(c, str) for c in captions):
        raise SystemExit("a request got no caption")
    words = {w for c in captions for w in c.split()}
    if not words <= set(vocab.itos.values()) or max(len(c.split()) for c in captions) > L - 1:
        raise SystemExit("a caption holds words outside the vocabulary or is too long")
    log(f"served {n} requests; sample captions: {captions[:2]}")
    log("stats " + json.dumps(stats))
    return singles + [it for b in batches for it in b], captions


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from mvc_tpu_torch.models.captioning import AVCaptioningDual, captions_from_tokens
    from mvc_tpu_torch.ops import _build
    from mvc_tpu_torch.ops import dual_greedy as dg

    torch.backends.cuda.matmul.allow_tf32 = False     # float32 matmuls in full float32
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device {name} count {torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(card)

    # -- 2. build
    t0 = time.perf_counter()
    out = _build.build_all(_build.KERNELS)
    log(f"built {list(out)} in {time.perf_counter() - t0:.1f} s")
    for src, text in out.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {src}: {line.strip()}")

    # -- 3. kernel vs plain at full width
    model = AVCaptioningDual(vocab_size=V, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    decoders = spread_bias([params["v_decoder"], params["a_decoder"]], seed=1)
    vf, af, mask = decode_inputs(2, device)
    cells = ("LSTM", "LSTM")
    max_err = check_kernel(dg, decoders, [vf, af], mask, cells, torch.float32, exact=True)
    bf16 = [{k: {n: t.bfloat16() for n, t in sub.items()} for k, sub in p.items()}
            for p in decoders]
    check_kernel(dg, bf16, [vf, af], mask, cells, torch.bfloat16, exact=False)
    from mvc_tpu_torch.config import VISUAL_DECODER_CONFIG
    from mvc_tpu_torch.models.decoder import init_decoder

    gru_v = init_decoder(torch.Generator().manual_seed(3),
                         VISUAL_DECODER_CONFIG.replace(rnn_type="GRU", output_size=V),
                         device=device)
    mixed = spread_bias([gru_v, params["a_decoder"]], seed=4)
    max_err = max(max_err, check_kernel(dg, mixed, [vf, af], mask, ("GRU", "LSTM"),
                                        torch.float32, exact=True))
    # a ragged batch (rows not a multiple of the kernel's row tile) whose
    # small B*T puts the audio decoder on the factored branch too
    svf, saf, smask = decode_inputs(5, device, b=5, t=3)
    if not dg._use_factored(5 * 3, 128, params["a_decoder"]["rnn"]["wh"].shape[1]):
        raise SystemExit("the small case no longer takes the audio factored branch")
    max_err = max(max_err, check_kernel(dg, decoders, [svf, saf], smask, cells,
                                        torch.float32, exact=True))

    # -- 4. serving through the kernel; counts cover exactly this run
    vocab = synthetic_vocab(V)
    dg.dual_greedy_decode.launches = 0
    requests, captions = serve(model, params, vocab, device)
    launches = dg.dual_greedy_decode.launches
    log(f"dual_greedy_decode launches during serving: {launches}")
    if launches < 1:
        raise SystemExit("the serving path never launched the dual_greedy kernel")
    # served captions against the plain version on the card, one request per
    # 64-row batch at its own frame bucket (the kernel is padding-invariant)
    from mvc_tpu_torch.data.dataset import _bucket

    agree = 0
    for item, cap in list(zip(requests, captions))[:8]:
        v = torch.tensor(item["visual"])
        t = v.shape[0]
        tp = _bucket(t, (8, 16, 32, 48, 64))
        vis = torch.zeros(64, tp, 2048)
        aud = torch.zeros(64, tp, 128)
        m = torch.zeros(64, tp, dtype=torch.bool)
        vis[0, :t], aud[0, :t], m[0, :t] = v, torch.tensor(item["audio"]), True
        tok = dg.dual_greedy_decode_reference(
            [params["v_decoder"], params["a_decoder"]], [vis.to(device), aud.to(device)],
            m.to(device), L)
        agree += captions_from_tokens(vocab, tok[:1])[0] == cap
    log(f"served captions equal to the plain version: {agree}/8")
    if agree != 8:
        raise SystemExit("served captions disagree with the plain version")

    # -- 5. times (warm-up excluded), in turns: plain, kernel, kernel, plain
    feats = [vf, af]
    call_k = lambda: dg.dual_greedy_decode(decoders, feats, mask, L, torch.float32, cells)  # noqa: E731
    call_p = lambda: dg.dual_greedy_decode_reference(decoders, feats, mask, L, torch.float32, cells)  # noqa: E731
    args, _tok, keep = dg.prepare_kernel_call(decoders, feats, mask, L, torch.float32, cells)
    call_launch = lambda: dg._launch(args, torch.float32, device)  # noqa: E731
    for fn in (call_k, call_p, call_launch):
        fn()
    torch.cuda.synchronize()
    ms_k, ms_p, ms_l = [], [], []
    for order in ((call_p, ms_p), (call_k, ms_k), (call_launch, ms_l), (call_launch, ms_l),
                  (call_k, ms_k), (call_p, ms_p)):
        order[1].append(cuda_ms(order[0], 5))
    ms_k, ms_p, ms_l = (float(np.mean(x)) for x in (ms_k, ms_p, ms_l))
    flops_pre, flops_kernel, nbytes = function_work(decoders, cells, 4)
    bound_fn = max((flops_pre + flops_kernel) / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    bound_kernel = max(flops_kernel / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    log(f"[{card}] dual_greedy_decode (wrapper: keys/P matmuls + kernel) f32 B={B} T={T} "
        f"L={L} V={V}: {ms_k:.4f} ms")
    log(f"[{card}] dual_greedy kernel launch alone: {ms_l:.4f} ms")
    log(f"[{card}] plain PyTorch version: {ms_p:.4f} ms")
    log(f"[{card}] bound (whole call, operations {(flops_pre + flops_kernel) / 1e9:.2f} GFLOP "
        f"at 67 TFLOP/s f32; bytes {nbytes / 1e6:.1f} MB at 3.35 TB/s): {bound_fn:.4f} ms")
    log(f"[{card}] bound (kernel alone, {flops_kernel / 1e9:.2f} GFLOP): {bound_kernel:.4f} ms")
    # shared memory per block grows with T; the largest T the kernel takes
    # at these widths (the wrapper raises above it)
    lib = dg._library()
    smem = lib.dual_greedy_smem_bytes(ctypes.byref(args))
    t_max = T
    while True:
        args.T = t_max + 1
        if lib.dual_greedy_smem_bytes(ctypes.byref(args)) > dg.MAX_SMEM_BYTES:
            break
        t_max += 1
    args.T = T
    log(f"kernel shared memory per block at T={T}: {smem} bytes; largest T at these "
        f"widths: {t_max}")
    del keep

    record = {"kernels": [{
        "name": "dual_greedy_decode", "route": "cuda",
        "source": "mvc_tpu_torch/csrc/dual_greedy.cu",
        "replaces": "mvc_tpu/ops/pallas_dual_greedy.py:314",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound_fn,
        "bound_by": "operations" if (flops_pre + flops_kernel) / PEAK_F32_FLOPS
        >= nbytes / PEAK_BYTES else "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
