#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and extraction paths once on one
NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase carries on past
its own failure:

1. the card: its name, and ``nvidia-smi``'s name and power limit
2. build every CUDA source of ``mvc_tpu_torch/csrc`` with nvcc for sm_90a,
   one nvcc per source, all started together; ``beam.cu``'s SASS against
   PR 5's build (printed)
3. each kernel against its plain PyTorch version on the card, at the
   serving shape (B=64, T=16, max_len=30, V=4000, full widths; beam W=5):
   the dual model's two decoders (``dual_greedy.cu``, ``beam.cu``) and the
   single model's one decoder over [audio | visual], F=2176 (``greedy.cu``,
   ``beam.cu`` with one decoder); ``beam.cu`` at both of its row tiles (15
   and 8 rows), with more widths (W=3, W=8), clips that finish at different
   steps within one cluster, T=64, and a T only the 8-row tile holds
4. serving: ``AVCaptioningDual``, then ``AVCaptioning``, at full width with
   seeded random weights, ``CaptionService(max_batch=64)`` behind
   ``make_http_server``, a few dozen requests through ``POST /caption`` and
   ``/caption_batch``, once in direct mode and once in beam mode; each
   kernel's launch count is set to 0 just before its run and read just after.
   Then one dual-direct clip above the kernel's largest T, posted with 8
   short ones: one HTTP 400, 8 captions equal to the plain version's
5. times with CUDA events (warm-up excluded): kernel, plain version, bound;
   the greedy kernels' shared memory against the Python replica of their
   layout, largest T, weight repack time and per-phase µs per step (f32
   and bf16); ``beam.cu`` per tile: shared memory, largest T, clusters,
   waves, times
6. training at full width (``AVCaptioningDual`` with global
   reconstructors, V=4000, B=128, f32 without TF32) on a synthetic MSVD
   tree written under ``build/``: one train step card vs CPU; a 2-epoch
   ``Trainer.fit`` whose evals decode through ``dual_greedy.cu`` and a
   1-epoch one through ``beam.cu`` (each count covers its fit; the eval
   captions held against the plain version's decode of the trained
   params); the host data side alone; the train step's time and parts
7. the rest of the RNN trainer and service on the same tree: one train
   step of ``AVCaptioning`` with a global reconstructor (F=2176) card vs
   CPU, its 2-epoch fit whose evals decode through ``greedy.cu`` and a
   1-epoch one through ``beam.cu`` with one decoder; the
   dual fit of 6 again from the device feature cache (per-step losses
   against 6's); int8 feature transfer (one batch bit for bit card vs CPU,
   a 1-epoch fit); bf16 Adam moments (a 1-epoch fit, half the moment
   bytes, the step's parts); dual direct serving over the bf16 and int8
   wires; ``python -m mvc_tpu_torch.cli.predict_captions`` in direct and
   beam mode on the cached fit's checkpoint
8. extraction and COCO evaluation at full width (Inception-v3 at 299x299,
   VGGish at [96, 64] with a seeded PCA, 16 kHz, seeded random weights, f32
   without TF32), no decode kernel involved: (a) ``FeatureExtractor``'s
   encode of 8 clips card vs CPU (features, log-mel, VGGish before and
   after PCA), frames/s and examples/s; (b) ``extract_dataset`` over 64
   ~10-s clips in chunks of 8 (one chunk in the 256 bucket, one above it),
   clips/s and the visual encode's time per frame beside its bound; (c)
   ResNet-101 at 224x224 card vs CPU; (d) where cv2 imports, the CLI
   ``python -m mvc_tpu_torch.cli.extract_features`` over MJPG clips and
   one batch of its features through the loader; (e) ``COCOEvalCap`` with
   SPICE over the val captions of 7's ``predict_captions``
9. the transformer, int8 weights and the router, on the tree of 6-7: (a)
   ``TransformerCaptioning`` at full width (``TransformerConfig``'s
   defaults, V=4000, generator bias spread) in direct and beam mode (W=5)
   at B=64, T=16: card tokens against the CPU's, ms per call, captions/s,
   kernel launches per call, the bound; (b) one transformer train step
   card vs CPU (B=128) and a 1-epoch ``Trainer.fit`` whose eval captions
   are held against the CPU's decode of the trained params; (c) phase 3's
   dual and single trees through ``quantize_model_params``, decoded through
   ``dual_greedy.cu`` (direct), ``beam.cu`` (dual beam) and ``greedy.cu``
   (single direct): tokens against the CPU's int8 path, int8 ms beside
   f32 ms; (d) ``CaptionRouter`` (``dual``, ``dual_int8``,
   ``transformer``; default ``dual``) behind ``make_http_server``: 16
   requests a route with a ``model`` field, 4 without, one unknown model
   (404); every caption against its route's plain version and
   ``dual_greedy.cu``'s launches counted per route

The line before the last is the kernels' JSON record; the last line is the
device record.  Exits non-zero with no record when no CUDA device is there.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

V, B, T, L = 4000, 64, 16, 30
W = 5                        # beam width of the beam phases
PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
BUCKETS = (8, 16, 32, 48, 64)


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


def spread_bias(decoders, seed, scale=2e-3, eos_bias=0.0):
    """Spread the vocab biases (a seeded permutation x scale) so the argmax
    and top-W decisions stay clear of near-ties; tokens still vary row to
    row.  ``eos_bias`` lifts EOS above every other bias by that much."""
    from mvc_tpu_torch.config import EOS_ID

    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(V, generator=g).float() * scale
    if eos_bias:
        perm[EOS_ID] = perm.max() + eos_bias
    out = []
    for p in decoders:
        p = {k: dict(v) for k, v in p.items()}
        p["out"]["b"] = p["out"]["b"] + perm.to(p["out"]["b"].device)
        out.append(p)
    return out


def decode_work(decoders, feat_dims, row_steps, out_elems, weight_bytes, b=B, t=T):
    """FLOPs and bytes of one decode call: the keys/P matmuls outside the
    kernel, then per (row, step) the query, energies, context or P-sum,
    gates and vocab projection of each decoder.  Bytes: each input read
    once, the tokens written once."""
    from mvc_tpu_torch.ops._decode_common import _use_factored

    flops_pre = flops_kernel = 0
    nbytes = b * t * 4 + out_elems * 4
    for p, F in zip(decoders, feat_dims):
        E = p["embedding"]["table"].shape[1]
        H, GH = p["rnn"]["wh"].shape
        A = p["attention"]["W"].shape[1]
        fac = _use_factored(b * t, F, GH)
        flops_pre += 2 * b * t * F * A + (2 * b * t * F * GH if fac else 0)
        kx = E if fac else E + F
        per = (2 * H * A + 2 * t * A + 2 * t * (GH if fac else F)
               + 2 * kx * GH + 2 * H * GH + 2 * H * V)
        flops_kernel += row_steps * per
        nbytes += b * t * F * 4 + sum(x.numel() for sub in p.values() for x in sub.values()) * weight_bytes
    return flops_pre, flops_kernel, nbytes


def bounds(flops_pre, flops_kernel, nbytes, peak_flops=PEAK_F32_FLOPS):
    """(whole call ms, kernel alone ms, bound_by) at the card's peaks:
    float32 products at the float32 rate, bf16 ones (bf16 operands, float32
    sums) at the bf16 tensor-core rate."""
    whole = max((flops_pre + flops_kernel) / peak_flops, nbytes / PEAK_BYTES) * 1e3
    kernel = max(flops_kernel / peak_flops, nbytes / PEAK_BYTES) * 1e3
    by = "operations" if (flops_pre + flops_kernel) / peak_flops >= nbytes / PEAK_BYTES else "bytes"
    return whole, kernel, by


def largest_t(lib_fn, args, limit):
    """The largest T whose shared-memory need stays within the limit, on
    the branch (factored or direct) each decoder of ``args`` takes."""
    t0, t_max = args.T, 0
    while True:
        args.T = t_max + 1
        if lib_fn(ctypes.byref(args)) > limit:
            break
        t_max += 1
    args.T = t0
    return t_max


PHASES = ("embed + attention of the block's row", "attention cluster barrier", "gates",
          "gates cluster barrier + h pull", "vocab matvec + block argmax", "next query",
          "candidate exchange + barrier")


def phase_timers(card, label, name, lib, args, dtype, device):
    """Per-phase µs per step of a greedy kernel from its timed instantiation
    (``<name>_launch_timed``): clock64 marks of thread 0 of cluster 0,
    converted with the SM clock the kernel itself saw (clock64 cycles over
    %globaltimer ns between its first and last cluster barrier).  Steps 1..
    L-2 (the first step also pays for the cold start).  Returns
    {phase: µs}, with "step" the mean step."""
    from mvc_tpu_torch.ops import _decode_common as dc

    for _ in range(3):
        timer = dc.launch_timed(name, lib, args, dtype, device)
    torch.cuda.synchronize()
    t = timer.cpu().numpy().astype(np.float64)
    ghz = (t[3] - t[1]) / (t[2] - t[0])             # cycles per ns
    marks = t[dc.TIMER_HEAD:].reshape(args.max_len - 1, dc.N_MARKS)[1:]
    us = np.diff(marks, axis=1).mean(axis=0) / ghz / 1e3
    out = dict(zip(PHASES, (float(x) for x in us)))
    out["step"] = float((marks[:, -1] - marks[:, 0]).mean() / ghz / 1e3)
    log(f"[{card}] {label} per-phase µs per step (B={args.B} T={args.T}, SM clock "
        f"{ghz:.3f} GHz, kernel {(t[2] - t[0]) / 1e6:.4f} ms between the first and last "
        f"cluster barrier): " + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def sass_bodies(lib_path):
    """{kernel name: sha256 of its SASS} of a built library, by cuobjdump."""
    import hashlib

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name, body = {}, None, []
    for line in text.splitlines() + ["Function : <end>"]:
        if "Function :" in line:
            if name is not None:
                out[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()
            name, body = line.split("Function :")[1].strip(), []
        elif name is not None and line.strip():
            body.append(line.strip())
    return out


# SASS digests (sass_bodies) of beam.cu's four kernels as PR 5 built them
# (nvcc of CUDA 12.8 for sm_90a, NVCC_FLAGS of ops/_build.py)
PR5_BEAM_SASS = {
    "2507bfa0e14d65a7d36dbeb716a5a931fb33c70d7f25207e28658dc16f0f6499",   # float, R=15
    "5cf6abdac9555cd3047767b2db6363567a45486d6b52fee43b65db9deac78a29",   # float, R=8
    "18e90ee935aeee77e2680b3991994a3e0ea8928c64d8258ae5f06bcdee5f2915",   # bf16, R=15
    "066ba7a8ae88fd96b75d496e3f373887b34ddb08ce686c3ed1bef14ae30d34eb",   # bf16, R=8
}


def beam_sass_against_pr5(build):
    """Whether this build of beam.cu has the SASS of PR 5's (printed; a
    toolkit other than PR 5's gives other digests)."""
    try:
        here = set(sass_bodies(build._library_path("beam")).values())
    except (OSError, subprocess.SubprocessError) as e:
        log(f"beam.cu SASS against PR 5's build: not compared ({e})")
        return
    log(f"beam.cu SASS against PR 5's build: {len(here & PR5_BEAM_SASS)} of "
        f"{len(PR5_BEAM_SASS)} kernels identical ({len(here)} built)")


def stream_layout(card, label, smem_fn, args, prep):
    """The greedy kernel's shared-memory need against the Python replica of
    its layout (ops/_decode_common.greedy_layout); fails if they differ."""
    from mvc_tpu_torch.ops import _decode_common as dc

    decs = [{k: p[k] for k in ("H", "A", "E", "F", "cell", "factored")} for p in prep]
    lay = dc.greedy_layout(decs, args.T, args.V)
    got = smem_fn(ctypes.byref(args))
    log(f"{label} shared memory per block at T={args.T}: {got} bytes (replica {lay['bytes']}), "
        f"ring of {lay['stages']} stages of {dc.STAGE_BYTES} bytes; largest T at these widths: "
        f"{largest_t(smem_fn, args, dc.MAX_SMEM_BYTES)}")
    if got != lay["bytes"]:
        raise SystemExit(f"{label}: the kernel's layout and its Python replica disagree")
    nbytes = sum(sum(st) for *_, st in dc.stream_plan(decs, args.V, 4))
    log(f"[{card}] {label} weight stream per block and step (f32): {nbytes / 1e6:.3f} MB, "
        f"{nbytes * dc.CL * -(-args.B // dc.ROWS) / 1e6:.1f} MB over the grid")


def check_greedy(name, kernel_fn, plain_fn, label, mask, exact):
    """A greedy kernel's tokens against its plain version's on the same
    inputs; ``exact`` requires every token equal."""
    tok_k = kernel_fn()
    torch.cuda.synchronize()
    tok_p = plain_fn()
    same = (tok_k == tok_p).float().mean().item()
    err = (tok_k.long() - tok_p.long()).abs().max().item()
    log(f"{name} kernel vs plain {label} B={mask.shape[0]} T={mask.shape[1]}: "
        f"equal tokens {same:.6f}, "
        f"unique tokens {len(torch.unique(tok_p[:, 1:]))}, column 0 zero "
        f"{bool((tok_k[:, 0] == 0).all())}")
    if (tok_k.shape != (mask.shape[0], L) or not bool((tok_k[:, 0] == 0).all())
            or ((tok_k < 0) | (tok_k >= V)).any()):
        raise SystemExit(f"{name} kernel tokens break the output contract")
    if exact and same != 1.0:
        raise SystemExit(f"{name} kernel disagrees with its plain version ({label})")
    if not exact and same < 0.998:
        raise SystemExit(f"{name} kernel agrees on {same:.6f} < 99.8 % of tokens ({label})")
    return float(err)


def check_dual_greedy(dg, decoders, feats, mask, cells, dtype, exact):
    return check_greedy(
        "dual_greedy", lambda: dg.dual_greedy_decode(decoders, feats, mask, L, dtype, cells),
        lambda: dg.dual_greedy_decode_reference(decoders, feats, mask, L, dtype, cells),
        f"{cells} {dtype}", mask, exact)


def check_single_greedy(gr, decoder, feats, mask, cell, dtype, exact, label=""):
    return check_greedy(
        "greedy", lambda: gr.greedy_decode(decoder, feats, mask, L, dtype, cell),
        lambda: gr.greedy_decode_reference(decoder, feats, mask, L, dtype, cell),
        f"{label}{cell} F={feats.shape[2]} {dtype}", mask, exact)


def check_beam(bm, decoders, feats, mask, cells, dtype, alpha, exact, device, label="", w=W,
               tiles=(15, 8)):
    """Kernel tokens and per-clip step counts at each row tile (0: the
    kernel's own choice) against the plain version; ``exact`` requires
    every token and step count equal, otherwise >= 99.8 % equal tokens."""
    from mvc_tpu_torch.config import SOS_ID

    tok_p, steps_p = bm.beam_decode_reference(decoders, feats, mask, L, w, alpha, dtype, cells,
                                              return_steps=True)
    err = 0.0
    for rows in tiles:
        args, tok_k, steps_k, keep = bm.prepare_kernel_call(decoders, feats, mask, L, w, alpha,
                                                            dtype, cells)
        bm._launch(args, dtype, device, rows)
        torch.cuda.synchronize()
        del keep
        same = (tok_k == tok_p).float().mean().item()
        err = max(err, float((tok_k.long() - tok_p.long()).abs().max().item()))
        log(f"beam kernel R={rows or 'auto'} vs plain {label}{cells} {dtype} W={w} alpha={alpha} "
            f"B={mask.shape[0]} T={mask.shape[1]}: equal tokens {same:.6f}, unique tokens "
            f"{len(torch.unique(tok_p[:, 1:]))}, steps equal {torch.equal(steps_k, steps_p)}, "
            f"kernel {steps_k.tolist()[:9]}... plain {steps_p.tolist()[:9]}...")
        if (tok_k.shape != (mask.shape[0], L + 2) or not bool((tok_k[:, 0] == SOS_ID).all())
                or ((tok_k < 0) | (tok_k >= V)).any()):
            raise SystemExit("beam kernel tokens break the output contract")
        if exact and (same != 1.0 or not torch.equal(steps_k, steps_p)):
            raise SystemExit(f"beam kernel R={rows} disagrees with its plain version "
                             f"({label}{cells}, {dtype})")
        if not exact and same < 0.998:
            raise SystemExit(f"beam kernel R={rows} agrees on {same:.6f} < 99.8 % of tokens "
                             f"({label}{cells}, {dtype})")
    return err, tok_p, steps_p


def staggered_eos(bm, params, feats, mask, cells):
    """EOS-lifted decoders under which clips of one 15-row cluster (three
    consecutive clips at W=5) stop at different steps, found by lifting EOS
    less and less on the plain version; returns (decoders, steps)."""
    for eos_bias in (1.0, 0.5, 0.3, 0.2, 0.1, 0.05):
        dec = spread_bias(params, seed=5, eos_bias=eos_bias)
        _, steps = bm.beam_decode_reference(dec, feats, mask, L, W, 0.7, torch.float32, cells,
                                            return_steps=True)
        groups = steps[: len(steps) // 3 * 3].view(-1, 3)
        if bool((groups.amax(1) != groups.amin(1)).any()) and int(steps.min()) < L + 1:
            log(f"staggered EOS case: eos_bias {eos_bias}")
            return dec, steps
    raise SystemExit("no EOS lift makes the clips of one cluster stop at different steps")


def serve(model, params, vocab, device, mode, label="", transfer="f32"):
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server

    tag = f"{label}{mode}" + ("" if transfer == "f32" else f" over the {transfer} wire")
    rng = np.random.default_rng(0)

    def clip():
        t = int(rng.integers(3, 41))
        return {"visual": rng.normal(size=(t, 2048)).astype(np.float32).round(3).tolist(),
                "audio": rng.normal(size=(t, 128)).astype(np.float32).round(3).tolist()}

    singles = [clip() for _ in range(24)]
    batches = [[clip() for _ in range(12)] for _ in range(2)]
    cfg = ServiceConfig(max_batch=64, mode=mode, beam_width=W, frame_buckets=BUCKETS,
                        max_caption_len=L, transfer=transfer)
    svc = CaptionService(model, params, vocab, cfg, device=device)
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
        log(f"[{tag}] warmup t_pads {warmed} in {time.perf_counter() - t0:.2f} s")
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
    if not words <= set(vocab.itos.values()) or max(len(c.split()) for c in captions) > L + 1:
        raise SystemExit("a caption holds words outside the vocabulary or is too long")
    log(f"[{tag}] served {n} requests; sample captions: {captions[:2]}")
    log(f"[{tag}] stats " + json.dumps(stats))
    return singles + [it for b in batches for it in b], captions


def serve_over_limit(model, params, vocab, device, plain_fn):
    """One clip whose frame bucket exceeds the kernel's largest T, posted
    together with 8 short clips: it alone gets HTTP 400 and the 8 get the
    plain version's captions."""
    from mvc_tpu_torch.data.dataset import _bucket
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server

    cfg = ServiceConfig(max_batch=64, mode="direct", frame_buckets=BUCKETS, max_caption_len=L,
                        max_wait_ms=200.0)
    svc = CaptionService(model, params, vocab, cfg, device=device)
    t_long = svc.max_frames + 1
    rng = np.random.default_rng(3)
    shorts = [{"visual": rng.normal(size=(t, 2048)).astype(np.float32).round(3).tolist(),
               "audio": rng.normal(size=(t, 128)).astype(np.float32).round(3).tolist()}
              for t in rng.integers(3, 41, size=8)]
    bodies = shorts + [{"visual": np.zeros((t_long, 2048)).tolist(),
                        "audio": np.zeros((t_long, 128)).tolist()}]
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    replies = [None] * len(bodies)

    def post(i):
        req = urllib.request.Request(base + "/caption", data=json.dumps(bodies[i]).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                replies[i] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            replies[i] = (e.code, None)
        except Exception as e:               # reported below; the phase fails
            replies[i] = (None, repr(e))

    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        svc.close()
    codes = [c for c, _ in replies]
    log(f"[over-limit] kernel's largest T {svc.max_frames}; a clip of T={t_long} (bucket "
        f"{_bucket(t_long, BUCKETS)}) posted with 8 short ones: HTTP {codes}")
    if codes != [200] * 8 + [400]:
        raise SystemExit(f"the over-limit clip was not refused alone: {replies}")
    check_served(plain_fn, shorts, [r["caption"] for _, r in replies[:8]], vocab, device,
                 "over-limit batch-mates")


def wire_values(transfer):
    """The float32 values a padded host batch has on the card after the
    service's wire format: bf16 rounding, or the int8 quantize and
    dequantize (per frame, so padding-invariant)."""
    from mvc_tpu_torch.data.feature_cache import dequantize_int8, quantize_int8

    def through(x):
        if transfer == "bf16":
            return x.bfloat16().float()
        if transfer == "int8":
            return dequantize_int8(*(torch.from_numpy(a) for a in quantize_int8(x.numpy())))
        return x
    return through


def check_served(plain_fn, requests, captions, vocab, device, mode, transfer="f32", n=8):
    """The first ``n`` served captions against the plain version on the
    card, each at its own 64-row batch and frame bucket (the kernels are
    padding-invariant), from the values the service's wire format gives the
    features."""
    from mvc_tpu_torch.data.dataset import _bucket
    from mvc_tpu_torch.models.captioning import captions_from_tokens

    through = wire_values(transfer)
    agree = 0
    for item, cap in list(zip(requests, captions))[:n]:
        v = torch.tensor(item["visual"])
        t = v.shape[0]
        tp = _bucket(t, BUCKETS)
        vis = torch.zeros(64, tp, 2048)
        aud = torch.zeros(64, tp, 128)
        m = torch.zeros(64, tp, dtype=torch.bool)
        vis[0, :t], aud[0, :t], m[0, :t] = v, torch.tensor(item["audio"]), True
        tok = plain_fn([through(vis).to(device), through(aud).to(device)], m.to(device))
        agree += captions_from_tokens(vocab, tok[:1])[0] == cap
    log(f"[{mode}] served captions equal to the plain version: {agree}/{n}")
    if agree != n:
        raise SystemExit(f"served {mode} captions disagree with the plain version")


def time_calls(call_k, call_p, call_launch):
    """Mean ms of the wrapper, the plain version and the launch alone, in
    turns (plain, kernel, launch, launch, kernel, plain), warm-up excluded."""
    for fn in (call_k, call_p, call_launch):
        fn()
    torch.cuda.synchronize()
    ms_k, ms_p, ms_l = [], [], []
    for fn, out in ((call_p, ms_p), (call_k, ms_k), (call_launch, ms_l), (call_launch, ms_l),
                    (call_k, ms_k), (call_p, ms_p)):
        out.append(cuda_ms(fn, 5))
    return tuple(float(np.mean(x)) for x in (ms_k, ms_p, ms_l))


def beam_tiles(bm, dc, card, decoders, feats, mask, cells, s_dec, sf, device):
    """``beam.cu`` at each row tile, for the dual model and the single
    model's one decoder at W=5 and the dual model at W=8 (f32, T=16):
    shared memory per block, largest T, clusters in the grid and resident
    at once, waves, and the kernel's time alone at B=64 and B=16, tiles in
    turns (15, 8, 8, 15)."""
    f32 = torch.float32
    lib = bm._library()
    for label, dec, fts, cl, w in (("dual", decoders, feats, cells, W),
                                   ("one decoder", [s_dec], [sf], ("LSTM",), W),
                                   ("dual", decoders, feats, cells, 8)):
        calls, default, keep = {}, {}, []
        for b in (B, 16):
            args, _tok, _steps, k = bm.prepare_kernel_call(
                dec, [f[:b].contiguous() for f in fts], mask[:b].contiguous(), L, w, 0.0, f32, cl)
            keep.append(k)
            default[b] = lib.beam_tile_rows(ctypes.byref(args))
            for rows in bm.TILES:
                calls[rows, b] = (args, lambda a=args, r=rows: bm._launch(a, f32, device, r))
        for _args, fn in calls.values():
            fn()
        torch.cuda.synchronize()
        ms = {key: [] for key in calls}
        for rows in bm.TILES + bm.TILES[::-1]:
            for b in (B, 16):
                ms[rows, b].append(cuda_ms(calls[rows, b][1], 5))
        for rows in bm.TILES:
            args = calls[rows, B][0]
            grid = -(-B // (rows // w))
            resident = lib.beam_max_active_clusters(ctypes.byref(args), 0, rows)
            t_max = largest_t(lambda a, r=rows: lib.beam_smem_bytes(a, r), args,
                              dc.MAX_SMEM_BYTES)
            log(f"[{card}] beam {label} W={w} R={rows}: shared memory per block at T={T} "
                f"{lib.beam_smem_bytes(ctypes.byref(args), rows)} bytes, largest T {t_max}, "
                f"clusters in the grid at B={B} {grid}, resident {resident}, waves "
                f"{-(-grid // max(resident, 1))}; kernel alone B={B} "
                f"{float(np.mean(ms[rows, B])):.4f} ms, B=16 {float(np.mean(ms[rows, 16])):.4f} ms")
        fast = min(bm.TILES, key=lambda r: np.mean(ms[r, B]))
        log(f"beam {label} W={w}: default tile R={default[B]} at B={B} (R={default[16]} at "
            f"B=16); faster at B={B}: R={fast}")
        del keep


# -- 6. training ----------------------------------------------------------

TRAIN_B = 128                       # TrainerConfig's batch size, also the eval batch
TRAIN_ROOT = "build/chip_smoke_train"


def write_synthetic_msvd(root, n_train=512, n_val=128, seed=0):
    """An MSVD-shaped tree at ``root/MSVD``: ``n_train`` train and ``n_val``
    val clips of 20..40 frames (video [T, 2048], audio [T, 128] float32),
    each with two captions of 8..14 words drawn (Zipf-like) from a seeded
    list of V-4 pseudo-words; ``tiny.csv`` holds the first 128 train clips'
    rows; the vocabulary has exactly V entries.  Returns (dataset dir,
    vocab path)."""
    import csv

    from mvc_tpu_torch.data import Vocabulary

    rng = np.random.default_rng(seed)
    ds = os.path.join(root, "MSVD")
    for sub in ("metadata", "features/video", "features/audio"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    syllables = [c + v for c in "bcdfghjklmnprstvwxyz" for v in "aeiou"]
    words = [syllables[i // 100] + syllables[i % 100] for i in rng.permutation(10_000)[:V - 4]]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    rows = {}
    for split, n in (("train", n_train), ("val", n_val)):
        rows[split] = []
        for c in range(n):
            vid, t = f"{split}{c:04d}", int(rng.integers(20, 41))
            for kind, width in (("video", 2048), ("audio", 128)):
                np.save(os.path.join(ds, "features", kind, f"{vid}_0_10.npy"),
                        rng.standard_normal((t, width), dtype=np.float32))
            for _ in range(2):
                cap = " ".join(words[i] for i in rng.choice(len(words), int(rng.integers(8, 15)),
                                                             p=p))
                rows[split].append({"VideoID": vid, "Start": 0, "End": 10, "Source": "clean",
                                    "Description": cap})
    rows["tiny"] = rows["train"][:2 * 128]
    for split, rs in rows.items():
        with open(os.path.join(ds, "metadata", f"{split}.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rs[0]))
            w.writeheader()
            w.writerows(rs)
    vocab_path = os.path.join(ds, "metadata", "vocab.json")
    vocab = Vocabulary.prebuild([" ".join(words)] + [r["Description"] for r in rows["train"]],
                                vocab_path, freq_threshold=1)
    if len(vocab) != V:
        raise SystemExit(f"the synthetic vocabulary has {len(vocab)} entries, not {V}")
    return ds, vocab_path


class RecordingWriter:
    """A summary writer that keeps every scalar: {tag: [values]}."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, []).append(float(value))

    def close(self):
        pass


def smoke_trainer(checkpoint_name):
    """A ``Trainer`` whose scalars are recorded and which keeps each eval's
    generated captions: ``generated[phase, epoch] = {video: [caption]}``."""
    from mvc_tpu_torch.training.trainer import Trainer

    class SmokeTrainer(Trainer):
        def eval(self, model, params, loader, phase, epoch, *a, **k):
            out = super().eval(model, params, loader, phase, epoch, *a, **k)
            self.generated[phase, epoch] = out[2]
            return out

    tr = SmokeTrainer(checkpoint_name, log_dir=None, eval_freq=1)
    tr.summary_writer = RecordingWriter()
    tr.generated = {}
    return tr


def dual_model(device):
    from mvc_tpu_torch.models import AVCaptioningDual

    model = AVCaptioningDual(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type="global",
                             device=device)
    return model, model.init(torch.Generator().manual_seed(0))


def single_model(device):
    """``AVCaptioning`` with a global reconstructor: one decoder over
    [audio | visual], F=2176, and an LSTM reconstructor of hidden size 2176."""
    from mvc_tpu_torch.models import AVCaptioning

    model = AVCaptioning(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type="global",
                         device=device)
    return model, model.init(torch.Generator().manual_seed(0))


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix[:-1], tree)]


class GradCapture:
    """Stands in for the optimizer in the trainer's step: keeps each leaf's
    gradient on the host, then steps the real optimizer."""

    def __init__(self, opt, params):
        self.opt, self.named = opt, named_leaves(params)

    def step(self):
        self.grads = {k: p.grad.detach().cpu().clone() for k, p in self.named}
        self.opt.step()


def first_train_batch(ds, vocab_path):
    from mvc_tpu_torch.data.dataset import VideoCaptioningDataset
    from mvc_tpu_torch.data.loader import DataLoader

    data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    return next(iter(DataLoader(data, batch_size=TRAIN_B, prefetch=0)))


def train_step_on(make_model, cfg, batch, dev):
    """One train step of ``make_model``'s model on ``dev`` (the features sent
    as bf16, the fit's default transfer dtype, then cast to the model's
    dtype): (metrics, gradients and parameters after the step by leaf name
    on the host, seconds, the model's class name)."""
    from mvc_tpu_torch.training import optimizer as opt_lib

    model, params = make_model(dev)
    tr = smoke_trainer("unused.ckpt")
    tr._transfer_dtype = torch.bfloat16
    b = tr._put_batch(batch, dev)
    b.pop("_n_real")
    if model.dtype == torch.float64:
        b = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in b.items()}
    step, _ = tr._build_train_step(model, cfg)
    opt = GradCapture(opt_lib.make_optimizer(cfg, params), params)
    t0 = time.perf_counter()
    params, metrics = step(params, opt, b, torch.Generator().manual_seed(1))
    metrics = metrics.cpu()
    return (metrics, opt.grads, {k: v.detach().cpu() for k, v in named_leaves(params)},
            time.perf_counter() - t0, type(model).__name__)


def train_step_card_vs_cpu(card, cfg, ds, vocab_path, device, make_model=dual_model,
                           label="train a"):
    """(a) one train step of ``make_model``'s model from the same weights
    and batch on the card and
    on the CPU: the loss within 1e-4 relative, every gradient leaf within
    1e-4 relative in norm (||card - cpu|| / ||cpu||, before the optimizer's
    clip), and every parameter leaf after the step within 1e-3 of its
    largest value (max |card - cpu| / max |cpu|)."""
    batch = first_train_batch(ds, vocab_path)
    out = {key: train_step_on(make_model, cfg, batch, dev)
           for key, dev in (("card", device), ("cpu", torch.device("cpu")))}
    (m_c, g_c, p_c, s_c, name), (m_h, g_h, p_h, s_h, _) = out["card"], out["cpu"]
    loss_rel = abs(float(m_c[0]) - float(m_h[0])) / abs(float(m_h[0]))
    g_rel = {k: float((g_c[k] - g_h[k]).norm() / g_h[k].norm().clamp_min(1e-30)) for k in g_h}
    rel = {k: float((p_c[k] - p_h[k]).abs().max() / p_h[k].abs().max().clamp_min(1e-30))
           for k in p_h}
    g_worst, worst = max(g_rel, key=g_rel.get), max(rel, key=rel.get)
    log(f"[{label}] one train step of {name}, same weights and batch (B={TRAIN_B}, T="
        f"{batch['visual'].shape[1]}, L={batch['captions'].shape[0]}): card losses "
        f"{[round(float(x), 6) for x in m_c]} ({s_c:.2f} s with warm-up), cpu "
        f"{[round(float(x), 6) for x in m_h]} ({s_h:.2f} s); loss relative difference "
        f"{loss_rel:.3e}; gradients of {len(g_h)} leaves, worst relative difference in norm "
        f"{g_rel[g_worst]:.3e} ({g_worst}, |g_cpu| {float(g_h[g_worst].norm()):.3e}), median "
        f"{float(np.median(list(g_rel.values()))):.3e}; max relative parameter difference "
        f"{rel[worst]:.3e} ({worst})")
    if not (loss_rel <= 1e-4 and g_rel[g_worst] <= 1e-4 and rel[worst] <= 1e-3):
        raise SystemExit("the card's train step disagrees with the CPU's")


def eval_agreement(tr, model, loader, vocab, generated, plain_fn, label, least):
    """Share of the eval's captions (kernel) equal to the plain version's
    decode of the same params and the same (transfer-cast) features; fails
    below ``least``.  The fits' weights have no spread biases, so a near-tie
    can flip one pick (and the rest of that caption); the first differing
    pairs are printed."""
    from mvc_tpu_torch.models.captioning import captions_from_tokens

    equal = total = 0
    differ = []
    with torch.no_grad():
        for batch in loader:
            b = tr._put_batch(batch, model.device)
            caps = captions_from_tokens(vocab, plain_fn(b))
            for vid, cap in zip(batch["video_ids"], caps):
                same = generated[vid][0] == cap
                equal += same
                total += 1
                if not same and len(differ) < 3:
                    differ.append((vid, generated[vid][0], cap))
    share = equal / total
    log(f"[train {label}] eval captions equal to the plain version's decode of the same "
        f"params: {equal}/{total} ({100 * share:.2f} %); differing (video, kernel, plain): "
        f"{differ}")
    if share < least:
        raise SystemExit(f"{label}: the kernel's eval captions agree on {share:.4f} < {least}")


def fit_phase(card, cfg, ds, vocab_path, split, label, counter, plain_fn, least, device,
              make_model=dual_model):
    """``Trainer.fit`` of ``make_model``'s model on the card; the kernel's
    launch count covers exactly the fit (``counter`` None: a model whose
    eval runs no kernel).  Checks finite losses, CIDEr in every score, the
    checkpoint files and the eval captions against the plain version (at
    least ``least`` equal); returns (the launch count, the trainer, its
    optimizer)."""
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.data.dataset import video_dataset_to_video_captions_loader

    kw = dict(batch_size=TRAIN_B, vocab_path=vocab_path, verbose=False)
    train_loader, _ = get_loader(ds, "MSVD", split, **kw)
    val_loader, _ = get_loader(ds, "MSVD", "val", **kw)
    model, params = make_model(device)
    ckpt = os.path.join(TRAIN_ROOT, "ckpt", f"{label}.ckpt")
    tr = smoke_trainer(ckpt)
    if counter is not None:
        counter.launches = 0
    t0 = time.perf_counter()
    params, opt, hist = tr.fit(model, params, train_loader, val_loader, val_loader, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counter.launches if counter is not None else None
    sc = tr.summary_writer.scalars
    if train_loader.feature_cache is not None:
        cache = train_loader.feature_cache
        log(f"[{card}] [train {label}] device feature cache: {cache.nbytes() / 1e6:.1f} MB "
            f"({len(cache.row_of)} clips, T_store={cache.t_store}, "
            f"{cache.arrays()['visual'].dtype})")
    for e in range(cfg.epochs):
        log(f"[{card}] [train {label}] epoch {e + 1}: train {hist['train_loss'][e]} val "
            f"{hist['val_loss'][e]}; {len(train_loader.dataset)} samples at "
            f"{sc['train_epoch/samples_per_sec'][e]:.2f} samples/s; eval captions/s train "
            f"{sc['train/captions_per_sec'][e]:.2f} val {sc['val/captions_per_sec'][e]:.2f}; "
            f"val CIDEr {hist['val_score'][e]['CIDEr']:.6f}")
    log(f"[{card}] [train {label}] fit of {cfg.epochs} epoch(s) in {fit_s:.2f} s; kernel "
        f"launches during the fit: {launches}")
    losses = [v for key in ("train_loss", "val_loss") for d in hist[key] for v in d.values()]
    if not all(np.isfinite(losses)) or len(hist["val_score"]) != cfg.epochs:
        raise SystemExit(f"{label}: a loss is not finite or an eval is missing")
    if not all("CIDEr" in s for s in hist["val_score"] + hist["train_score"]):
        raise SystemExit(f"{label}: a score without CIDEr")
    if not os.path.isfile(ckpt.replace(".ckpt", "_last.ckpt")):
        raise SystemExit(f"{label}: no _last checkpoint")
    if counter is not None and launches < 1:
        raise SystemExit(f"{label}: the fit never launched its eval kernel")
    vocab = train_loader.dataset.vocab
    for phase, loader in (("train", train_loader), ("val", val_loader)):
        vc = video_dataset_to_video_captions_loader(
            loader.dataset, batch_size=cfg.batch_size, frame_buckets=tuple(cfg.frame_buckets))
        eval_agreement(tr, model, vc, vocab, tr.generated[phase, cfg.epochs],
                       lambda b: plain_fn(params, b, cfg), f"{label} {phase}", least)
    return launches, tr, opt


def train_step_work(model, params, b, t, l):
    """(FLOPs, bytes, parameter count) of one fused-loss train step at
    [B, T] features and L caption tokens.  FLOPs: 3x the forward's
    products (each GEMM's two backward GEMMs), the forward being per
    decoder the attention keys, the hoisted embedding rows of wi, per step
    the query, energies, context (or P-sum), context rows of wi (or P's
    build once) and wh, and the vocab projection; per global reconstructor
    the hoisted input GEMM and the recurrence.  Bytes: the batch, then the
    params, grads and three moment trees read once and params and moments
    written once."""
    from mvc_tpu_torch.models.decoder import _train_factored
    from mvc_tpu_torch.training.optimizer import tree_leaves

    steps, fwd = l - 1, 0
    for c in (model.v_config, model.a_config):
        F, E, H, A, Vc = (c.in_feature_size, c.embedding_size, c.rnn_hidden_size, c.attn_size,
                          c.output_size)
        GH = 4 * H
        fwd += 2 * b * t * F * A + 2 * steps * b * E * GH + 2 * steps * b * H * Vc
        fwd += steps * (2 * b * H * A + 2 * b * t * A + 2 * b * H * GH)
        if _train_factored(b, t, F, GH, l):
            fwd += 2 * b * t * F * GH + steps * 2 * b * t * GH
        else:
            fwd += steps * (2 * b * t * F + 2 * b * F * GH)
    for rc in (model.v_rec_config, model.a_rec_config):
        fr, d = rc.hidden_size, 2 * rc.decoder_size
        fwd += 2 * steps * b * d * 4 * fr + 2 * steps * b * fr * 4 * fr
    n = sum(p.numel() for p in tree_leaves(params))
    nbytes = 4 * n * (5 + 4) + b * t * (2048 + 128) * 2 + b * t + l * b * 4
    return 3 * fwd, nbytes, n


def host_data_times(card, ds, vocab_path, device):
    """The fit's host side alone, over one epoch of the train split: the
    loader (npy loads and collation on its prefetch thread), then the
    loader plus ``Trainer._device_batches`` (bf16 host cast, pinned copy to
    the card, its own prefetch thread).  Prints samples/s of each."""
    from mvc_tpu_torch.data import get_loader

    loader, data = get_loader(ds, "MSVD", "train", batch_size=TRAIN_B, vocab_path=vocab_path,
                              verbose=False)
    tr = smoke_trainer("unused.ckpt")
    tr._transfer_dtype, tr._device_prefetch = torch.bfloat16, True
    out = {}
    for name, it in (("loader", lambda: loader),
                     ("loader + device copies", lambda: tr._device_batches(loader, device))):
        t0 = time.perf_counter()
        for _ in it():
            pass
        torch.cuda.synchronize()
        out[name] = len(data) / (time.perf_counter() - t0)
    log(f"[{card}] [train host] one epoch of host data alone ({len(data)} samples, B={TRAIN_B}): "
        + ", ".join(f"{k} {v:.2f} samples/s" for k, v in out.items()))


def train_step_times(card, cfg, device, t_, l_):
    """(d) the train step on one device-resident batch of B=128 at [T, L]
    (bench.py's shape is T=28, L=8): ms per step (median of 20) and
    samples/s, then the parts with CUDA events (median of 20 each):
    forward, loss, backward, optimizer; and the step's bound."""
    from mvc_tpu_torch.data.dataset import collate_av_batch
    from mvc_tpu_torch.training import fused_loss, losses
    from mvc_tpu_torch.training import optimizer as opt_lib

    rng = np.random.default_rng(11)
    items = [{"audio": rng.standard_normal((t_, 128), dtype=np.float32),
              "visual": rng.standard_normal((t_, 2048), dtype=np.float32),
              "caption": np.concatenate([[1], rng.integers(4, V, l_ - 2), [2]]).astype(np.int32)}
             for _ in range(TRAIN_B)]
    host = collate_av_batch(items, frame_buckets=(t_,), caption_buckets=(l_,))
    model, params = dual_model(device)
    tr = smoke_trainer("unused.ckpt")
    tr._transfer_dtype = torch.bfloat16
    batch = tr._put_batch(host, device)
    batch.pop("_n_real")
    step, _ = tr._build_train_step(model, cfg)
    opt = opt_lib.make_optimizer(cfg, params)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        params, _m = step(params, opt, batch, gen)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(20):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, _m = step(params, opt, batch, gen)
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    step_ms = float(np.median([a.elapsed_time(b) for a, b in pairs]))

    # the parts: the trainer's fused-path compute_loss, cut at its seams
    caps, fm, sm = batch["captions"], batch["feat_mask"], batch["sample_mask"]
    parts = []
    for _ in range(20):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        h_list, outs, a_rec, v_rec = model.forward_hiddens(
            params, batch["audio"], batch["visual"], caps, gen=gen, feat_mask=fm)
        ev[1].record()
        ce, ent = fused_loss.ce_entropy_from_hiddens(h_list, outs, caps, sample_mask=sm,
                                                     compute_dtype=model.dtype)
        a_l = losses._single_reconstruction_loss(caps, batch["audio"], a_rec, "global", fm, sm)
        v_l = losses._single_reconstruction_loss(caps, batch["visual"], v_rec, "global", fm, sm)
        loss = ce + cfg.reg_lambda * ent + cfg.audio_recon_lambda * a_l \
            + cfg.visual_recon_lambda * v_l
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        parts.append(ev)
    torch.cuda.synchronize()
    names = ("forward", "loss", "backward", "optimizer")
    part_ms = {n: float(np.median([ev[i].elapsed_time(ev[i + 1]) for ev in parts]))
               for i, n in enumerate(names)}
    flops, nbytes, n_params = train_step_work(model, params, TRAIN_B, t_, l_)
    bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    by = "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
    state = f", Adam moments in {cfg.adam_state_dtype}" if cfg.adam_state_dtype else ""
    log(f"[{card}] [train d] train step f32 (no TF32), dual + global reconstructor{state}, "
        f"{n_params} params, B={TRAIN_B} T={t_} L={l_} V={V}: {step_ms:.4f} ms per step "
        f"(median of 20), {TRAIN_B / step_ms * 1e3:.2f} samples/s; parts (median of 20): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in part_ms.items())
        + f" (sum {sum(part_ms.values()):.4f}); bound {bound:.4f} ms ({by}: "
        f"{flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32, {nbytes / 1e6:.1f} MB at 3.35 TB/s)")
    if not np.isfinite(float(_m[0])):
        raise SystemExit("the timed train steps gave a loss that is not finite")


def plain_dual_greedy(params, b, cfg):
    """The plain version of the dual fit's direct eval decode."""
    from mvc_tpu_torch.ops import dual_greedy as dg

    return dg.dual_greedy_decode_reference([params["v_decoder"], params["a_decoder"]],
                                           [b["visual"], b["audio"]], b["feat_mask"],
                                           cfg.eval_max_caption_len, torch.float32,
                                           ("LSTM", "LSTM"))


def train_phase(card, device, ds, vocab_path):
    """6. the training slice at full width (dual model, global
    reconstructors, V=4000, B=128, f32): (a) one train step card vs CPU,
    (b) a 2-epoch fit whose evals decode through dual_greedy.cu, (c) a
    1-epoch fit on 128 clips whose evals decode through beam.cu, (d) the
    train step's times at two shapes, and the host data side alone.
    Returns each kernel's launches during its fit and the trainer of (b)."""
    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg

    cells, f32 = ("LSTM", "LSTM"), torch.float32     # the fits compute in float32

    def plain_beam(params, b, cfg):
        return bm.beam_decode_reference([params["v_decoder"], params["a_decoder"]],
                                        [b["visual"], b["audio"]], b["feat_mask"],
                                        cfg.eval_max_caption_len, cfg.eval_beam_width,
                                        cfg.eval_beam_alpha, f32, cells)

    train_step_card_vs_cpu(card, TrainerConfig(batch_size=TRAIN_B), ds, vocab_path, device)
    direct, direct_tr, _ = fit_phase(card, TrainerConfig(batch_size=TRAIN_B, epochs=2), ds,
                                     vocab_path, "train", "direct", dg.dual_greedy_decode,
                                     plain_dual_greedy, 0.99, device)
    beam, _, _ = fit_phase(card, TrainerConfig(batch_size=TRAIN_B, epochs=1, eval_mode="beam"),
                           ds, vocab_path, "tiny", "beam", bm.beam_decode, plain_beam, 0.97,
                           device)
    host_data_times(card, ds, vocab_path, device)
    for t_, l_ in ((28, 8), (48, 16)):          # bench.py's shape, the fit's largest buckets
        train_step_times(card, TrainerConfig(batch_size=TRAIN_B), device, t_, l_)
    return {"dual_greedy": direct, "beam": beam}, direct_tr


# -- 7. the rest of the RNN trainer and service -------------------------------


def fits_agree(card, a, b, label):
    """Per-step train and val losses of two fits (the recorded scalars)
    within 1e-4 relative; prints both fits' samples/s per epoch."""
    worst = 0.0
    for tag in ("train/loss", "val/loss"):
        x, y = (np.array(t.summary_writer.scalars[tag]) for t in (a, b))
        if x.shape != y.shape:
            raise SystemExit(f"{label}: the fits ran {x.shape} and {y.shape} {tag} steps")
        worst = max(worst, float(np.max(np.abs(x - y) / np.abs(y))))
    rates = [t.summary_writer.scalars["train_epoch/samples_per_sec"] for t in (a, b)]
    log(f"[{card}] [{label}] per-step train and val losses, worst relative difference "
        f"{worst:.3e} over {len(a.summary_writer.scalars['train/loss'])} train steps; samples/s "
        f"per epoch {[round(r, 2) for r in rates[0]]} against {[round(r, 2) for r in rates[1]]}")
    if not worst <= 1e-4:
        raise SystemExit(f"{label}: the fits' losses disagree ({worst:.3e})")


def trace_summary(card, path, label):
    """What a ``torch.profiler`` Chrome trace of a train loop shows: its
    span, the card's busy time (kernels, copies and memsets, summed) and
    busy share, and the kernels that took most of it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in device) / 1e3
    by_name = {}
    for e in device:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    size = f"torch.profiler trace ({os.path.getsize(path) / 1e6:.1f} MB)"
    if not device:
        log(f"[{card}] [{label}] {size}: span {span:.2f} ms, no device activity in the trace "
            "(the profiler saw no CUDA events): card busy share not measured")
        return
    log(f"[{card}] [{label}] {size}: span {span:.2f} ms, card busy {busy:.2f} ms "
        f"({100 * busy / span:.2f} %) in {len(device)} kernels and copies; top: "
        + "; ".join(f"{n} {ms:.2f} ms" for n, ms in top))


def rest_phase(card, device, ds, vocab_path, uncached_tr, serving, plain_serving):
    """7. the rest of the RNN trainer and service at full width: (a) one
    train step of ``AVCaptioning`` + a global reconstructor card vs CPU,
    (b) its 2-epoch fit whose evals decode through greedy.cu (epoch 1
    traced) and a 1-epoch fit on 128 clips through beam.cu, (c) the dual
    fit of phase 6 (b) again from the device feature cache, (d) int8
    feature transfer, (e) bf16 Adam moments, (f) dual direct serving over
    the bf16 and int8 wires, (g) ``cli.predict_captions`` in direct and
    beam mode.  Returns each kernel's launches by path."""
    from mvc_tpu_torch.cli import predict_captions
    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data.dataset import VideoCaptioningDataset
    from mvc_tpu_torch.data.loader import DataLoader
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import greedy as gr
    def plain_single(params, b, cfg):
        return gr.greedy_decode_reference(params["decoder"],
                                          torch.cat([b["audio"], b["visual"]], dim=-1),
                                          b["feat_mask"], cfg.eval_max_caption_len,
                                          torch.float32, "LSTM")

    def plain_single_beam(params, b, cfg):
        return bm.beam_decode_reference([params["decoder"]],
                                        [torch.cat([b["audio"], b["visual"]], dim=-1)],
                                        b["feat_mask"], cfg.eval_max_caption_len,
                                        cfg.eval_beam_width, cfg.eval_beam_alpha, torch.float32,
                                        ("LSTM",))

    launches = {}
    train_step_card_vs_cpu(card, TrainerConfig(batch_size=TRAIN_B), ds, vocab_path, device,
                           single_model, "rest a")
    prof_dir = os.path.join(TRAIN_ROOT, "profile")
    os.environ["MVC_PROFILE_DIR"] = prof_dir          # the trainer traces epoch 1
    try:
        launches["greedy train fit direct eval (single)"], _, _ = fit_phase(
            card, TrainerConfig(batch_size=TRAIN_B, epochs=2), ds, vocab_path, "train",
            "single", gr.greedy_decode, plain_single, 0.99, device, make_model=single_model)
    finally:
        del os.environ["MVC_PROFILE_DIR"]
    trace_summary(card, os.path.join(prof_dir, "train_epoch1.trace.json"),
                  "rest b single fit, epoch 1 (traced)")
    launches["beam train fit beam eval (single)"], _, _ = fit_phase(
        card, TrainerConfig(batch_size=TRAIN_B, epochs=1, eval_mode="beam"), ds, vocab_path,
        "tiny", "single beam", bm.beam_decode, plain_single_beam, 0.97, device,
        make_model=single_model)

    cached, cached_tr, _ = fit_phase(
        card, TrainerConfig(batch_size=TRAIN_B, epochs=2, device_feature_cache=True), ds,
        vocab_path, "train", "cached", dg.dual_greedy_decode, plain_dual_greedy, 0.99, device)
    launches["dual_greedy train fit direct eval (cached)"] = cached
    fits_agree(card, cached_tr, uncached_tr, "rest c cached against uncached (phase 6 b)")

    data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    batch = next(iter(DataLoader(data, batch_size=TRAIN_B, prefetch=0)))
    tr = smoke_trainer("unused.ckpt")
    tr._transfer_int8 = True
    on_card, on_cpu = tr._put_batch(batch, device), tr._put_batch(batch, torch.device("cpu"))
    same = {k: on_card[k].dtype == torch.float32 and torch.equal(on_card[k].cpu(), on_cpu[k])
            for k in ("audio", "visual")}
    log(f"[rest d] int8 transfer of one batch ({tuple(batch['visual'].shape)} visual): the "
        f"card's dequantized float32 features equal the CPU's bit for bit: {same}")
    if not all(same.values()):
        raise SystemExit("the int8 batch on the card differs from the CPU's")
    launches["dual_greedy train fit direct eval (int8)"], _, _ = fit_phase(
        card, TrainerConfig(batch_size=TRAIN_B, epochs=1, transfer_dtype="int8"), ds,
        vocab_path, "tiny", "int8", dg.dual_greedy_decode, plain_dual_greedy, 0.99, device)

    cfg = TrainerConfig(batch_size=TRAIN_B, epochs=1, adam_state_dtype="bfloat16")
    launches["dual_greedy train fit direct eval (bf16 Adam state)"], _, opt = fit_phase(
        card, cfg, ds, vocab_path, "tiny", "bf16 state", dg.dual_greedy_decode,
        plain_dual_greedy, 0.99, device)
    n = sum(p.numel() for p in opt.leaves)
    got, f32_bytes = opt.inner.moment_bytes(), 3 * 4 * n
    log(f"[rest e] Adam moments in bf16: {got} bytes for {n} parameters, against {f32_bytes} "
        f"in float32 ({got / f32_bytes:.3f})")
    if got * 2 != f32_bytes:
        raise SystemExit("the bf16 moments do not take half the float32 bytes")
    for state in (None, "bfloat16", "bfloat16", None):       # in turns, at bench.py's shape
        train_step_times(card, TrainerConfig(batch_size=TRAIN_B, adam_state_dtype=state),
                         device, 28, 8)

    model, params, vocab = serving
    for transfer in ("bf16", "int8"):
        dg.dual_greedy_decode.launches = 0
        requests, captions = serve(model, params, vocab, device, "direct", "dual ", transfer)
        launches[f"dual_greedy serve dual direct ({transfer} wire)"] = n_l = \
            dg.dual_greedy_decode.launches
        if n_l < 1:
            raise SystemExit(f"serving over the {transfer} wire never launched dual_greedy")
        check_served(plain_serving, requests, captions, vocab, device, f"direct {transfer}",
                     transfer)

    out_dir = os.path.join(TRAIN_ROOT, "results")
    val = VideoCaptioningDataset(ds, "MSVD", "val", vocab_path=vocab_path, verbose=False)
    n_val = len({vid for vid, _ in val.metadata})
    for mode, counter in (("direct", dg.dual_greedy_decode), ("beam", bm.beam_decode)):
        counter.launches = 0
        t0 = time.perf_counter()
        rows = predict_captions.main([
            "--data_root", os.path.dirname(ds), "--checkpoint",
            os.path.join(TRAIN_ROOT, "ckpt", "cached_last.ckpt"), "--splits", "val",
            "--mode", mode, "--reconstructor", "global", "--out_dir", out_dir,
            "--device", str(device)])
        name = f"{'dual_greedy' if mode == 'direct' else 'beam'} predict_captions {mode}"
        launches[name] = counter.launches
        with open(os.path.join(out_dir, f"captions_cached_last_val_{mode}.csv")) as f:
            n_rows = sum(1 for _ in f) - 1
        log(f"[{card}] [rest g] predict_captions --mode {mode} in "
            f"{time.perf_counter() - t0:.2f} s: {n_rows} captions, {counter.launches} launches, "
            f"scores {json.dumps({k: v for k, v in rows[0].items()})}")
        if counter.launches < 1 or n_rows != n_val:
            raise SystemExit(f"predict_captions --mode {mode} did not caption the val split "
                             "through its kernel")
    return launches


EXTRACT_ROOT = "build/chip_smoke_extract"
EXTRACT_CLIPS = 64                  # MSVD-like: ~10-s clips at fps=1, 16 kHz audio
EXTRACT_BATCH = 8                   # the CLI's --batch_size default
FRAME = 299                         # Inception-v3's input
RESNET_FRAME = 224                  # ResNet-101's


def clip_seconds(i):
    """Clip i's length: 9-11 s, except the 7th chunk of 8 (20 s: 160 frames,
    the 256 bucket) and the 8th (40 s: 320 frames, above the top bucket)."""
    chunk = i // EXTRACT_BATCH
    return {6: 20, 7: 40}.get(chunk, 9 + i % 3)


def decoded_clip(i, size=None):
    """Clip i as the host decode hands it over, made from seed i: uint8
    frames [T, size, size, 3] (T = seconds, fps=1; size FRAME unless
    given) and a 16 kHz float32 wav."""
    size = size or FRAME
    rng = np.random.default_rng(1000 + i)
    sec = clip_seconds(i)
    frames = rng.integers(0, 256, (sec, size, size, 3), dtype=np.uint8)
    t = np.arange(sec * 16000) / 16000
    wav = (0.2 * np.sin(2 * np.pi * rng.uniform(200, 2000) * t)
           + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)
    return frames, wav


def meta_tree(tree):
    if isinstance(tree, dict):
        return {k: meta_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [meta_tree(v) for v in tree]
    return None if tree is None else torch.empty(tree.shape, device="meta")


def model_flops(fn, params, shape):
    """2 x multiply-adds of one input of ``shape`` through ``fn``, counted
    by ``FlopCounterMode`` from the tree's own conv and matmul shapes
    (shape-only tensors: nothing runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        fn(meta_tree(params), torch.empty((1, *shape), device="meta"))
    return fc.get_total_flops()


def rel_in_norm(got, want):
    """Worst relative error in norm over rows."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.maximum(np.linalg.norm(want, axis=-1), 1e-30)).max())


def seeded_pca(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
    return {"matrix": torch.from_numpy((40.0 * q).astype(np.float32)),
            "means": torch.from_numpy((0.02 * rng.standard_normal((128, 1))).astype(np.float32))}


def padded_shares(counts, buckets):
    from mvc_tpu_torch.extract.features import _bucket

    out = []
    for n in counts:
        b = _bucket(n, buckets)
        out.append(f"{n}->{b} ({100 * (b - n) / b:.1f} % padding)")
    return ", ".join(out)


def encode_vs_cpu(card, label, fe, fe_cpu, clips, tol):
    """``_encode_decoded`` of ``clips`` on the card and on the CPU: visual
    features within ``tol`` relative in norm per frame, log-mel examples
    within 1e-4, VGGish before PCA within 1e-4 relative, after PCA within
    one quantum.  Returns the card's results."""
    from mvc_tpu_torch.models import inception_v3 as iv3
    from mvc_tpu_torch.models import vggish as vg
    from mvc_tpu_torch.ops import logmel

    t0 = time.perf_counter()
    got = fe._encode_decoded(clips)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fe_cpu._encode_decoded(clips)
    t_cpu = time.perf_counter() - t0
    v_err = max(rel_in_norm(g[0], w[0]) for g, w in zip(got, want))
    q_diff = np.concatenate([np.abs(g[1] - w[1]).ravel() for g, w in zip(got, want)])
    n_ex = max(logmel.num_examples_for(w.shape[0]) for _, w in clips)
    wavs = np.zeros((len(clips), logmel.samples_for(n_ex)), np.float32)
    for i, (_, w) in enumerate(clips):
        wavs[i, :min(w.shape[0], wavs.shape[1])] = w[:wavs.shape[1]]
    with torch.inference_mode(), iv3.full_float32():
        ex_card = logmel.log_mel_examples_batch(torch.from_numpy(wavs).to(fe.device), n_ex)
        ex_cpu = logmel.log_mel_examples_batch(torch.from_numpy(wavs), n_ex)
        mel_err = float((ex_card.cpu() - ex_cpu).abs().max())
        flat = ex_cpu.reshape(-1, 96, 64)
        raw_card = vg.vggish_embeddings(fe.vggish_params, flat.to(fe.device), postprocess=False)
        raw_cpu = vg.vggish_embeddings(fe_cpu.vggish_params, flat, postprocess=False)
        a_err = rel_in_norm(raw_card.cpu().numpy(), raw_cpu.numpy())
    frames = sum(c[0].shape[0] for c in clips)
    log(f"[{card}] [extract {label}] {len(clips)} clips, {frames} frames of "
        f"{clips[0][0].shape[1]}px: card {t_card:.3f} s (first call, cuDNN set-up included), "
        f"CPU {t_cpu:.3f} s; visual features card vs CPU worst {v_err:.3e} relative in norm per "
        f"frame (tolerance {tol:g}); log-mel examples {mel_err:.3e} absolute (1e-4); VGGish "
        f"before PCA {a_err:.3e} relative (1e-4); after PCA max {q_diff.max():.0f} quantum on "
        f"{100 * float((q_diff > 0).mean()):.3f} % of {q_diff.size} values (one quantum)")
    if not (v_err <= tol and mel_err <= 1e-4 and a_err <= 1e-4 and q_diff.max() <= 1.0):
        raise SystemExit(f"extraction {label}: the card's features disagree with the CPU's")
    for g in got:
        if g[0].dtype != np.float32 or g[1].dtype != np.float32 or not np.isfinite(g[0]).all():
            raise SystemExit(f"extraction {label}: features not finite float32")
    return got


def time_visual(card, label, fe, clips, peak_bound_ms):
    """Card time of the visual encode (normalize + CNN, frames already
    decoded; the uint8 copy to the card included) per call at the clips' bucket,
    CUDA events, warm-up excluded; beside the per-frame bound."""
    from mvc_tpu_torch.extract.features import _bucket
    from mvc_tpu_torch.models import inception_v3 as iv3

    frames = np.concatenate([c[0] for c in clips])
    m, b = frames.shape[0], _bucket(frames.shape[0], fe.frame_buckets)
    with torch.inference_mode(), iv3.full_float32():
        fe._encode_frame_stack(frames)
        ms = cuda_ms(lambda: fe._encode_frame_stack(frames), 3)
    log(f"[{card}] [extract {label}] visual encode of {m} frames in the {b} bucket: {ms:.3f} ms "
        f"a call, {ms / b:.4f} ms per padded frame, {ms / m:.4f} ms per real frame "
        f"({1e3 * m / ms:.1f} frames/s; {1e3 * b / ms:.1f} padded frames/s); bound "
        f"{peak_bound_ms:.4f} ms per frame (operations at 67 TFLOP/s f32): "
        f"{100 * peak_bound_ms * b / ms:.1f} % of it")
    return ms, m, b


KERNEL_KINDS = (("conv, implicit GEMM", ("implicit_gemm", "xmma_fprop", "sgemm", "cutlass")),
                ("conv, FFT", ("fft", "complex")),
                ("cuDNN layout transposes", ("nhwcToNchw", "nchwToNhwc")),
                ("pools", ("pool",)),
                ("concatenation", ("CatArray",)),
                ("elementwise (affine, relu, normalize)", ("elementwise",)))


def visual_breakdown(card, fe, clips):
    """The visual encode at the clips' bucket: NCHW (the layout the port
    uses) against channels_last in turns (CUDA events), and the card time
    of one NCHW call by kind of kernel (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    from mvc_tpu_torch.models import inception_v3 as iv3

    frames = np.concatenate([c[0] for c in clips])
    nhwc = {}

    def to_cl(t):
        if isinstance(t, dict):
            return {k: to_cl(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cl(v) for v in t]
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    cl_params = to_cl(fe.inception_params)
    x = torch.from_numpy(frames).to(fe.device)

    def run(channels_last):
        y = iv3.imagenet_normalize(x)
        if channels_last:
            return iv3.inception_v3_features(cl_params, y.contiguous(
                memory_format=torch.channels_last))
        return iv3.inception_v3_features(fe.inception_params, y)

    with torch.inference_mode(), iv3.full_float32():
        ref = run(False).cpu().numpy()
        for channels_last in (False, True, True, False):
            run(channels_last)
            nhwc.setdefault(channels_last, []).append(cuda_ms(lambda: run(channels_last), 3))
        err = rel_in_norm(run(True).cpu().numpy(), ref)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(False)
            torch.cuda.synchronize()
    log(f"[{card}] [extract a] Inception-v3 on {frames.shape[0]} frames (no padding), in "
        f"turns: NCHW {nhwc[False][0]:.3f} / {nhwc[False][1]:.3f} ms, channels_last "
        f"{nhwc[True][0]:.3f} / {nhwc[True][1]:.3f} ms (features {err:.2e} apart)")
    kinds = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if t <= 0:
            continue
        kind = next((k for k, keys in KERNEL_KINDS if any(w in e.key for w in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + t / 1e3
    total = sum(kinds.values())
    if total <= 0:
        log("[extract a] the profiler saw no CUDA kernels: the breakdown is not measured")
        return
    log(f"[{card}] [extract a] card time of one NCHW call by kind ({total:.3f} ms in all): "
        + "; ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f} %)"
                    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))


def extract_phase(card, device, captions_csv):
    """8. extraction and COCO evaluation at full width (Inception-v3 at
    299x299, VGGish at [96, 64], 16 kHz, seeded random weights, VGGish with
    a seeded PCA), f32 without TF32: (a) the encode card vs CPU on 8 clips,
    (b) ``extract_dataset`` over 64 clips chunk by chunk (8 a chunk; one
    chunk in the 256 bucket, one above it) with the visual encode's card
    time per frame beside its bound, (c) ResNet-101 at 224x224 card vs CPU,
    (d) the CLI over MJPG clips where cv2 imports, (e) ``COCOEvalCap`` with
    SPICE over phase 7's val captions."""
    import shutil

    from mvc_tpu_torch.extract import FeatureExtractor
    from mvc_tpu_torch.models import inception_v3 as iv3
    from mvc_tpu_torch.models import resnet as rn
    from mvc_tpu_torch.models import vggish as vg
    from mvc_tpu_torch.ops.logmel import num_examples_for

    cpu = torch.device("cpu")
    iv3_params = iv3.init_inception_v3(torch.Generator().manual_seed(20))
    vg_params = vg.init_vggish(torch.Generator().manual_seed(21))
    vg_params["pca"] = seeded_pca(22)
    fe = FeatureExtractor(iv3_params, vg_params, device=device)
    fe_cpu = FeatureExtractor(iv3_params, vg_params, device=cpu)
    flops_frame = model_flops(iv3.inception_v3_features, iv3_params, (3, FRAME, FRAME))
    flops_example = model_flops(lambda p, x: vg.vggish_embeddings(p, x[:, 0]), vg_params,
                                (1, 96, 64))
    bound_frame = flops_frame / PEAK_F32_FLOPS * 1e3
    log(f"[extract] Inception-v3 at {FRAME}px: {flops_frame / 2e9:.4f} G multiply-adds a frame "
        f"(counted from the tree's conv shapes), bound {bound_frame:.4f} ms a frame; VGGish "
        f"{flops_example / 2e9:.4f} G multiply-adds an example, bound "
        f"{flops_example / PEAK_F32_FLOPS * 1e3:.5f} ms")

    # (a) the first chunk's 8 clips, card vs CPU
    clips = [decoded_clip(i) for i in range(EXTRACT_BATCH)]
    encode_vs_cpu(card, "a", fe, fe_cpu, clips, 1e-4)
    frames = [c[0].shape[0] for c in clips]
    examples = [num_examples_for(c[1].shape[0]) for c in clips]
    log(f"[extract a] buckets: frames {padded_shares([sum(frames)], fe.frame_buckets)}; "
        f"audio examples {padded_shares([sum(examples)], fe.audio_buckets)}")
    time_visual(card, "a", fe, clips, bound_frame)
    visual_breakdown(card, fe, clips)
    with torch.inference_mode(), iv3.full_float32():
        ex = torch.randn((sum(examples), 96, 64), generator=torch.Generator().manual_seed(23))
        ex = ex.to(device)
        fe._encode_audio_stack(ex)
        a_ms = cuda_ms(lambda: fe._encode_audio_stack(ex), 3)
    log(f"[{card}] [extract a] VGGish + PCA of {ex.shape[0]} examples: {a_ms:.3f} ms "
        f"({1e3 * ex.shape[0] / a_ms:.1f} examples/s)")

    # (b) extract_dataset over every clip, 8 a chunk, decode pipelined
    class InMemory(FeatureExtractor):
        """The extractor with its host decode replaced by the seeded clips
        (no codec involved): the rest of ``extract_dataset`` is as shipped."""

        def _decode_one(self, filename, fps=None):
            return decoded_clip(int(os.path.basename(filename)[4:7]))

    shutil.rmtree(EXTRACT_ROOT, ignore_errors=True)
    videos = os.path.join(EXTRACT_ROOT, "mem", "videos")
    os.makedirs(videos)
    for i in range(EXTRACT_CLIPS):
        open(os.path.join(videos, f"clip{i:03d}_0_{clip_seconds(i)}.avi"), "w").close()
    mem = InMemory(iv3_params, vg_params, device=device)
    chunk_frames = [sum(clip_seconds(i) for i in range(c, c + EXTRACT_BATCH))
                    for c in range(0, EXTRACT_CLIPS, EXTRACT_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stats = mem.extract_dataset(videos, os.path.join(EXTRACT_ROOT, "mem", "features"),
                                batch_size=EXTRACT_BATCH, verbose=False)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{card}] [extract b] extract_dataset over {EXTRACT_CLIPS} clips ({sum(chunk_frames)} "
        f"frames) in chunks of {EXTRACT_BATCH}: {wall:.3f} s wall, "
        f"{EXTRACT_CLIPS / wall:.2f} clips/s, {sum(chunk_frames) / wall:.1f} frames/s; stats "
        f"{stats} (decode_s is the in-memory stand-in, no codec); peak card memory {peak:.2f} GiB")
    log(f"[extract b] chunk frame buckets: {padded_shares(chunk_frames, mem.frame_buckets)}")
    if stats["done"] != EXTRACT_CLIPS or stats["failures"]:
        raise SystemExit(f"extract_dataset finished {stats}")
    feats = os.path.join(EXTRACT_ROOT, "mem", "features")
    for i in (0, EXTRACT_CLIPS - 1):
        name = f"clip{i:03d}_0_{clip_seconds(i)}.npy"
        v = np.load(os.path.join(feats, "video", name))
        a = np.load(os.path.join(feats, "audio", name))
        n_ex = num_examples_for(clip_seconds(i) * 16000)     # whole 0.96-s examples
        if v.shape != (clip_seconds(i), 2048) or a.shape != (n_ex, 128) \
                or v.dtype != np.float32 or a.dtype != np.float32:
            raise SystemExit(f"{name}: written features {v.shape} {v.dtype}, {a.shape} {a.dtype}")
    again = mem.extract_dataset(videos, feats, batch_size=EXTRACT_BATCH, verbose=False)
    if again["done"] or again["skipped"] != EXTRACT_CLIPS:
        raise SystemExit(f"the second sweep did not skip every clip: {again}")
    for lo, label in ((48, "b 256 bucket"), (56, "b 512 bucket")):
        big = [decoded_clip(i) for i in range(lo, lo + EXTRACT_BATCH)]
        torch.cuda.reset_peak_memory_stats()
        time_visual(card, label, mem, big, bound_frame)
        log(f"[{card}] [extract {label}] peak card memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # (c) ResNet-101 at 224x224 (fc kept: 1000-d), 2 clips card vs CPU
    rn_params = rn.init_resnet101(torch.Generator().manual_seed(24))
    rfe = FeatureExtractor(rn_params, vg_params, visual_model="resnet", device=device)
    rfe_cpu = FeatureExtractor(rn_params, vg_params, visual_model="resnet", device=cpu)
    rclips = [decoded_clip(i, size=RESNET_FRAME) for i in range(2)]
    out = encode_vs_cpu(card, "c resnet", rfe, rfe_cpu, rclips, 1e-4)
    if out[0][0].shape != (rclips[0][0].shape[0], 1000):
        raise SystemExit(f"ResNet-101 features {out[0][0].shape}, not [T, 1000]")
    r_bound = model_flops(rn.resnet101_features, rn_params, (3, RESNET_FRAME, RESNET_FRAME)) / PEAK_F32_FLOPS * 1e3
    time_visual(card, "c resnet", rfe, rclips, r_bound)

    cli_phase(card, device)
    coco_phase(card, captions_csv)
    shutil.rmtree(EXTRACT_ROOT, ignore_errors=True)


def cli_phase(card, device):
    """(d) where cv2 imports: MJPG clips from ``extract/synthetic.py``, the
    CLI over them, the written files, one batch through the loader."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        log(f"[extract d] the decode half was not run on this host: cv2 does not import ({e}); "
            "the CLI needs OpenCV to decode videos")
        return
    import csv

    from mvc_tpu_torch.data import Vocabulary
    from mvc_tpu_torch.data.dataset import VideoCaptioningDataset
    from mvc_tpu_torch.data.loader import DataLoader
    from mvc_tpu_torch.extract.synthetic import make_clip_set

    ds = os.path.join(EXTRACT_ROOT, "cli", "MSVD")
    t0 = time.perf_counter()
    names = make_clip_set(ds, EXTRACT_BATCH, seconds=10.0, fps=25, size=(320, 240), seed=5)
    log(f"[extract d] {len(names)} MJPG clips (10 s, 25 fps, 320x240) + wav sidecars written in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p)}
    out = subprocess.run([sys.executable, "-m", "mvc_tpu_torch.cli.extract_features", "--dataset",
                          ds, "--device", str(device)], capture_output=True, text=True,
                         timeout=300, env=env)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise SystemExit(f"cli.extract_features failed:\n{out.stdout}\n{out.stderr}")
    stats = out.stdout.strip().splitlines()[-1]
    log(f"[{card}] [extract d] python -m mvc_tpu_torch.cli.extract_features over "
        f"{len(names)} clips: {wall:.2f} s wall (process start included); stats {stats}")
    rows = []
    for name in names:
        stem = os.path.splitext(name)[0]
        v = np.load(os.path.join(ds, "features", "video", f"{stem}.npy"))
        a = np.load(os.path.join(ds, "features", "audio", f"{stem}.npy"))
        if v.shape != (10, 2048) or a.shape != (10, 128) or v.dtype != np.float32 \
                or a.dtype != np.float32:
            raise SystemExit(f"{stem}: written {v.shape} {v.dtype}, {a.shape} {a.dtype}")
        vid = stem.rsplit("_", 2)[0]
        rows.append({"VideoID": vid, "Start": 0, "End": 10, "Source": "clean",
                     "Description": "a synthetic clip of moving stripes"})
    os.makedirs(os.path.join(ds, "metadata"), exist_ok=True)
    with open(os.path.join(ds, "metadata", "train.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    vocab_path = os.path.join(ds, "metadata", "vocab.json")
    Vocabulary.prebuild([r["Description"] for r in rows], vocab_path, freq_threshold=1)
    data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    batch = next(iter(DataLoader(data, batch_size=EXTRACT_BATCH, prefetch=0)))
    log(f"[extract d] one batch read back through the port's loader: visual "
        f"{tuple(batch['visual'].shape)}, audio {tuple(batch['audio'].shape)}")
    if batch["visual"].shape[-1] != 2048 or batch["audio"].shape[-1] != 128:
        raise SystemExit("the loader did not read the extracted features back")


def coco_phase(card, captions_csv):
    """(e) ``COCOEvalCap`` (PTB tokenizer, BLEU, METEOR, ROUGE-L, CIDEr and
    SPICE with a lexicon written over the synthetic vocabulary) over the
    val captions phase 7's ``predict_captions`` wrote."""
    import csv

    from mvc_tpu_torch.evalcap import COCOEvalCap

    gts, res = {}, {}
    with open(captions_csv) as f:
        for row in csv.DictReader(f):
            gts[row["video_id"]] = row["ground_truth"].split(" | ")
            res[row["video_id"]] = [row["generated"]]
    words = sorted({w for caps in gts.values() for c in caps for w in c.split()}
                   | {w for (c,) in res.values() for w in c.split()})
    lexicon = os.path.join(EXTRACT_ROOT, "spice_lexicon.txt")
    os.makedirs(EXTRACT_ROOT, exist_ok=True)
    classes = ("noun", "noun", "verb", "adj", "noun", "adv")
    with open(lexicon, "w") as f:
        for i, w in enumerate(words):
            f.write(f"{w} {classes[i % len(classes)]}\n")
    t0 = time.perf_counter()
    coco = COCOEvalCap(gts, res, spice_lexicon=lexicon)
    scores = coco.evaluate()
    log(f"[extract e] COCOEvalCap over {len(res)} val captions (phase 7 predict_captions, "
        f"direct) with SPICE over a {len(words)}-word lexicon, {time.perf_counter() - t0:.2f} s: "
        f"{json.dumps(scores)}")
    keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"}
    if set(scores) != keys or not all(np.isfinite(v) and v >= 0 for v in scores.values()) \
            or not 0 <= scores["SPICE"] <= 1 or set(coco.imgToEval) != set(res):
        raise SystemExit(f"COCOEvalCap gave {scores}")
    # each video's first reference as its caption: every candidate n-gram and
    # tuple is in the references, so BLEU-4 and ROUGE-L are 1, SPICE's
    # precision is 1 (its F well above 0)
    oracle = COCOEvalCap(gts, {v: caps[:1] for v, caps in gts.items()},
                         spice_lexicon=lexicon).evaluate()
    log(f"[extract e] the same harness with each video's first reference as its caption: "
        f"{json.dumps(oracle)}")
    if not (oracle["Bleu_4"] > 0.99 and oracle["ROUGE_L"] > 0.99 and oracle["SPICE"] > 0.5):
        raise SystemExit(f"COCOEvalCap scored references against themselves as {oracle}")


# -- 9. the transformer (train and serve), int8 weights, the router ----------

TRANSFORMER_CONFIG = None     # TransformerConfig's defaults: d_model 512, 8 heads, 2 layers


def transformer_model(device):
    """``TransformerCaptioning`` at full width (``TransformerConfig``'s
    defaults), V=4000, seeded weights."""
    from mvc_tpu_torch.models import TransformerCaptioning

    model = TransformerCaptioning(vocab_size=V, config=TRANSFORMER_CONFIG, device=device)
    return model, model.init(torch.Generator().manual_seed(20))


def spread_generator(params, seed=21, scale=2e-3):
    """The transformer's generator bias spread as ``spread_bias`` spreads the
    RNN decoders' (a seeded permutation x scale)."""
    g = torch.Generator().manual_seed(seed)
    b = params["generator"]["b"]
    perm = torch.randperm(b.shape[0], generator=g).float() * scale
    return dict(params, generator=dict(params["generator"], b=b + perm.to(b.device)))


def to_device(tree, device, dtype=None):
    from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

    return from_numpy_tree(tree, device, dtype)


def tree_bytes(tree):
    from mvc_tpu_torch.training.optimizer import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def transformer_work(model, params, b, t, row_steps):
    """(FLOPs, bytes) of one transformer decode call.  FLOPs: both encoders
    over the b*t frames (input projection, per layer the four projections,
    attention over the t frames, the FFN), the cross K/V projected once,
    then for each (rows, position) in ``row_steps`` both decoder stacks'
    layer step (self q/k/v/o and cross q/o projections, the FFN, attention
    over the positions decoded so far and the t frames) and the two
    generator heads.  Bytes: every parameter, the features and the mask
    read once, the tokens written once."""
    cfg = model.cfg
    D, dff, nl, bt = cfg.d_model, cfg.d_ff, cfg.num_layers, b * t
    enc = 2 * bt * (cfg.visual_dim + cfg.audio_dim) * D
    enc += 2 * nl * (2 * bt * (4 * D * D + 2 * D * dff) + 4 * b * t * t * D)
    cross = 2 * nl * 2 * 2 * bt * D * D
    steps = 0
    for rows, pos in row_steps:
        layer = 2 * (6 * D * D + 2 * D * dff) + 4 * ((pos + 1) + t) * D
        steps += rows * (2 * nl * layer + 2 * 2 * D * cfg.vocab_size)
    nbytes = tree_bytes(params) + bt * (cfg.visual_dim + cfg.audio_dim) * 4 + bt + b * (L + 2) * 4
    return enc + cross + steps, nbytes


def launches_per_call(fn):
    """(kernel launches the host issued, device operations the profiler
    saw) during one call of ``fn``, from ``torch.profiler``; None where it
    saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    host = sum(e.count for e in prof.key_averages()
               if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    dev = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return host or None, dev or None


def counting_steps(model):
    """Wraps ``model._step`` to count the decode steps of a call."""
    calls = [0]
    step = model._step

    def counted(*a):
        calls[0] += 1
        return step(*a)

    model._step = counted
    return calls


def transformer_decode(card, device):
    """9 (a): the transformer at full width, B=64, T=16, max_len=30, direct
    and beam (W=5): card tokens against the CPU's of the same params, ms
    per call with CUDA events, captions/s, launches per call, the bound."""
    from mvc_tpu_torch.models import TransformerCaptioning
    from mvc_tpu_torch.training.optimizer import tree_leaves

    model, params = transformer_model(device)
    params = spread_generator(params)
    cpu = TransformerCaptioning(vocab_size=V, config=TRANSFORMER_CONFIG, device="cpu")
    cpu_params = to_device(params, "cpu")
    n_params = sum(x.numel() for x in tree_leaves(params))
    vf, af, mask = decode_inputs(22, device)
    for mode in ("direct", "beam"):
        kw = dict(max_caption_len=L, mode=mode, beam_width=W, feat_mask=mask)
        steps = counting_steps(model)
        t0 = time.perf_counter()
        tok = model.predict_tokens(params, af, vf, **kw).cpu()
        first_s = time.perf_counter() - t0
        n_steps = steps[0]
        del model._step
        t0 = time.perf_counter()
        ref = cpu.predict_tokens(cpu_params, af.cpu(), vf.cpu(), max_caption_len=L, mode=mode,
                                 beam_width=W, feat_mask=mask.cpu())
        cpu_s = time.perf_counter() - t0
        share = float((tok == ref).float().mean())
        ms = cuda_ms(lambda: model.predict_tokens(params, af, vf, **kw), 3)
        host_launches, dev_ops = launches_per_call(lambda: model.predict_tokens(params, af, vf,
                                                                                **kw))
        rows = B * (W if mode == "beam" else 1)
        flops, nbytes = transformer_work(model, params, B, T, [(rows, p) for p in range(n_steps)])
        bound = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
        per_step = (f"{host_launches / n_steps:.1f}" if host_launches else "not measured")
        log(f"[{card}] [transformer a] {mode} ({n_params} parameters, "
            f"{tree_bytes(params) / 1e6:.1f} MB f32) B={B} T={T} max_len={L} V={V}"
            f"{f' W={W}' if mode == 'beam' else ''}: {ms:.4f} ms per call, "
            f"{B / ms * 1e3:.2f} captions/s; {n_steps} decode steps; kernel launches per call "
            f"{host_launches} ({per_step} per step), device operations {dev_ops}; bound "
            f"{bound:.4f} ms ({flops / 1e9:.2f} GFLOP at 67 TFLOP/s f32, {nbytes / 1e6:.1f} MB "
            f"at 3.35 TB/s) = {100 * bound / ms:.2f} % of the call; first call {first_s:.2f} s, "
            f"CPU {cpu_s:.2f} s")
        log(f"[transformer a] {mode} tokens card against CPU, same params: "
            f"{100 * share:.2f} % equal; sample {tok[0, :8].tolist()}")
        if share < 0.99 or tok.shape != ref.shape:
            raise SystemExit(f"transformer {mode}: card tokens agree with the CPU's on "
                             f"{share:.4f} < 0.99")
    return model, params, cpu, cpu_params


def transformer_step_card_vs_cpu(card, cfg, ds, vocab_path, device):
    """One transformer train step, same weights and batch (B=128), on the
    card and the CPU in float32 and on the card in float64 (the
    reference): the loss card vs CPU within 1e-4 relative; each gradient
    leaf of either float32 step within 1e-3 relative in norm of the float64
    one.  Not 1e-4 card vs CPU: float32 itself is that far from the exact
    gradient here (the leaves whose gradient is a small sum of large
    cancelling terms: the input projections, the FFN and layer-norm leaves
    of the last layers), on the CPU as on the card.  The attention key
    biases, whose gradient is zero (the softmax over keys is shift
    invariant), are held absolutely: zero up to float32 rounding, within
    1e-7 (float32's epsilon) of the largest leaf's norm.  Parameters after the step are not compared: Adam's first update
    is +-lr wherever |g| >> eps, so any two summation orders give
    zero-initialized leaves with near-zero gradient elements different
    updates."""
    from mvc_tpu_torch.models import transformer as tmod

    def float64_model(dev):
        """The same model and weights in float64, its log-softmax too (the
        model takes log-probs in float32 whatever its dtype, as JAX does):
        a reference, not a path the port runs."""
        model, params = transformer_model(dev)

        def fused_logp(p, xv, xa):
            return 0.5 * sum(torch.log_softmax(tmod._proj(p["generator"], tmod._layernorm(ln, x))
                                               .double(), -1)
                             for ln, x in ((p["ln_v"], xv), (p["ln_a"], xa)))

        model.dtype, model._fused_logp = torch.float64, fused_logp
        return model, to_device(params, dev, torch.float64)

    batch = first_train_batch(ds, vocab_path)
    runs = {key: train_step_on(make, cfg, batch, dev)
            for key, make, dev in (("card", transformer_model, device),
                                   ("cpu", transformer_model, torch.device("cpu")),
                                   ("card f64", float64_model, device))}
    (m_c, g_c, _, s_c, _), (m_h, g_h, _, s_h, _), (m_r, g_r, _, _, _) = runs.values()
    loss_rel = abs(float(m_c[0]) - float(m_h[0])) / abs(float(m_h[0]))
    top = max(float(g.norm()) for g in g_r.values())
    zero = [k for k in g_r if k.endswith("/k/b")]

    def rel(g, ref):
        return {k: float((g[k].double() - ref[k].double()).norm() / ref[k].double().norm())
                for k in ref if k not in zero}

    errs = {"card": rel(g_c, g_r), "cpu": rel(g_h, g_r), "card vs cpu": rel(g_c, g_h)}
    z = max(float(g[k].norm()) / top for g in (g_c, g_h, g_r) for k in zero)
    text = "; ".join(
        f"{name}: worst {max(e.values()):.3e} ({max(e, key=e.get)}), median "
        f"{float(np.median(list(e.values()))):.3e}, above 1e-4 {sum(v > 1e-4 for v in e.values())}"
        for name, e in errs.items())
    log(f"[{card}] [transformer b] one train step, same weights and batch (B={TRAIN_B}, "
        f"T={batch['visual'].shape[1]}, L={batch['captions'].shape[0]}): card losses "
        f"{[round(float(x), 6) for x in m_c]} ({s_c:.2f} s with warm-up), cpu "
        f"{[round(float(x), 6) for x in m_h]} ({s_h:.2f} s), float64 "
        f"{[round(float(x), 6) for x in m_r]}; loss relative difference {loss_rel:.3e}; "
        f"gradients of {len(g_r) - len(zero)} leaves against float64, relative in norm: {text}; "
        f"the {len(zero)} key biases' largest norm / the largest leaf's {z:.3e}")
    if not (loss_rel <= 1e-4 and max(errs["card"].values()) <= 1e-3
            and max(errs["cpu"].values()) <= 1e-3 and z <= 1e-7):
        raise SystemExit("the card's transformer train step disagrees with the CPU's")


def transformer_train(card, device, ds, vocab_path):
    """9 (b): one transformer train step card against CPU (B=128, with a
    float64 reference), then a 1-epoch ``Trainer.fit`` whose eval decodes
    on the card, its captions against the CPU's decode of the trained
    params."""
    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.models import TransformerCaptioning

    transformer_step_card_vs_cpu(card, TrainerConfig(batch_size=TRAIN_B), ds, vocab_path, device)
    cpu = TransformerCaptioning(vocab_size=V, config=TRANSFORMER_CONFIG, device="cpu")

    def plain(params, b, cfg):
        return cpu.predict_tokens(to_device(params, "cpu"), b["audio"].cpu(), b["visual"].cpu(),
                                  max_caption_len=cfg.eval_max_caption_len,
                                  feat_mask=b["feat_mask"].cpu())

    fit_phase(card, TrainerConfig(batch_size=TRAIN_B, epochs=1), ds, vocab_path, "train",
              "transformer", None, plain, 0.99, device, make_model=transformer_model)


def int8_weights(card, device, dual_params, single_params):
    """9 (c): ``quantize_model_params`` of the dual and single trees, decoded
    through the kernels (dequantized once per call): dual direct
    (``dual_greedy.cu``), dual beam (``beam.cu``), single direct
    (``greedy.cu``); tokens against the CPU's int8 plain path (>= 99 %),
    agreement with the float32 tokens, int8 ms beside f32 ms."""
    from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import greedy as gr
    from mvc_tpu_torch.ops import quant

    vf, af, mask = decode_inputs(23, device)
    launches = {}
    for label, cls, params, mode, counter in (
            ("dual direct", AVCaptioningDual, dual_params, "direct", dg.dual_greedy_decode),
            ("dual beam", AVCaptioningDual, dual_params, "beam", bm.beam_decode),
            ("single direct", AVCaptioning, single_params, "direct", gr.greedy_decode)):
        model, cpu = cls(vocab_size=V, device=device), cls(vocab_size=V, device="cpu")
        q = quant.quantize_model_params(params)
        kw = dict(max_caption_len=L, mode=mode, beam_width=W, feat_mask=mask)
        counter.launches = 0
        tok = model.predict_tokens(q, af, vf, **kw).cpu()
        launches[label] = counter.launches
        ref = cpu.predict_tokens(to_device(q, "cpu"), af.cpu(), vf.cpu(), max_caption_len=L,
                                 mode=mode, beam_width=W, feat_mask=mask.cpu())
        f32_tok = model.predict_tokens(params, af, vf, **kw).cpu()
        share = float((tok == ref).float().mean())
        vs_f32 = float((tok == f32_tok).float().mean())
        times = {"f32": [], "int8": []}
        for key in ("f32", "int8", "int8", "f32"):
            p = params if key == "f32" else q
            times[key].append(cuda_ms(lambda: model.predict_tokens(p, af, vf, **kw), 3))
        deq = cuda_ms(lambda: quant.dequantize_tree(q, torch.float32), 5)
        q_mb = tree_bytes(q) / 1e6
        log(f"[{card}] [int8 c] {label}: {launches[label]} launch(es) of "
            f"{counter.__name__}; tokens equal to the CPU's int8 plain path "
            f"{100 * share:.2f} %, to the float32 tokens {100 * vs_f32:.2f} %; ms per call "
            f"int8 {np.mean(times['int8']):.4f} ({times['int8']}) against f32 "
            f"{np.mean(times['f32']):.4f} ({times['f32']}); the dequantize alone "
            f"{deq:.4f} ms; tree {q_mb:.1f} MB int8 against {tree_bytes(params) / 1e6:.1f} MB")
        if share < 0.99 or launches[label] < 1:
            raise SystemExit(f"int8 {label}: card tokens agree with the CPU's on {share:.4f} "
                             f"or the kernel never launched")
    return launches


def post_json(base, body, path="/caption"):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post_all(base, bodies):
    """All bodies posted at once, one client thread each; their captions."""
    replies = [None] * len(bodies)

    def client(i):
        try:
            replies[i] = post_json(base, bodies[i])
        except Exception as e:               # reported below; the phase fails
            replies[i] = (None, repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads) or any(c != 200 for c, _ in replies):
        raise SystemExit(f"routed requests failed: {[r for r in replies if r[0] != 200][:3]}")
    return [r["caption"] for _, r in replies]


def router_phase(card, device, vocab, routes):
    """9 (d): ``CaptionRouter`` over ``routes`` ({name: (model, params,
    plain_fn)}, default "dual") behind ``make_http_server``: 16 requests a
    route through ``POST /caption`` with a ``model`` field, route by route
    with ``dual_greedy.cu``'s count set to 0 before and read after each; 4
    without the field (the default); one unknown model (404).  Every
    caption against its route's plain version.  Returns the launches by
    route."""
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.serving import CaptionRouter, CaptionService, ServiceConfig, \
        make_http_server

    cfg = ServiceConfig(max_batch=64, frame_buckets=BUCKETS, max_caption_len=L)
    router = CaptionRouter({name: CaptionService(m, p, vocab, cfg, device=device)
                            for name, (m, p, _) in routes.items()}, default="dual")
    rng = np.random.default_rng(24)

    def clip():
        t = int(rng.integers(3, 41))
        return {"visual": rng.normal(size=(t, 2048)).astype(np.float32).round(3).tolist(),
                "audio": rng.normal(size=(t, 128)).astype(np.float32).round(3).tolist()}

    clips = {name: [clip() for _ in range(16)] for name in routes}
    clips["(default)"] = [clip() for _ in range(4)]
    captions, launches = {}, {}
    server = make_http_server(router, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        t0 = time.perf_counter()
        warmed = router.warmup()
        log(f"[router d] warmup {warmed} in {time.perf_counter() - t0:.2f} s")
        router.reset_stats()
        for name in clips:
            bodies = clips[name] if name == "(default)" else [dict(c, model=name)
                                                              for c in clips[name]]
            dg.dual_greedy_decode.launches = 0
            t0 = time.perf_counter()
            captions[name] = post_all(base, bodies)
            launches[name] = dg.dual_greedy_decode.launches
            log(f"[{card}] [router d] {name}: {len(bodies)} requests in "
                f"{time.perf_counter() - t0:.3f} s; dual_greedy_decode launches {launches[name]}")
        code, err = post_json(base, dict(clips["dual"][0], model="no-such-model"))
        log(f"[router d] unknown model: HTTP {code} {err}")
        stats = router.stats()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        router.close()
    for name, s in stats["models"].items():
        log(f"[router d] stats {name}: " + json.dumps(s))
    if code != 404:
        raise SystemExit(f"an unknown model got HTTP {code}, not 404")
    if not (launches["dual"] > 0 and launches["dual_int8"] > 0 and launches["(default)"] > 0
            and launches["transformer"] == 0):
        raise SystemExit(f"the routes launched dual_greedy as {launches}")
    for name in clips:
        plain = routes["dual" if name == "(default)" else name][2]
        check_served(plain, clips[name], captions[name], vocab, device, f"router {name}",
                     n=len(clips[name]))
    return launches


def phase9(card, device, ds, vocab_path, vocab, dual, dual_params, single_params):
    """9. the transformer (a: decode, b: train), (c) int8 weights on the
    three kernels, (d) the router; each part's seconds printed.  Returns
    the kernels' launches by path."""
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import quant

    t9 = t0 = time.perf_counter()
    tr_model, tr_params, tr_cpu, tr_cpu_params = transformer_decode(card, device)
    log(f"[phase 9 a] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    transformer_train(card, device, ds, vocab_path)
    log(f"[phase 9 b] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    int8 = int8_weights(card, device, dual_params, single_params)
    log(f"[phase 9 c] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    q = quant.quantize_model_params(dual_params)
    deq = [quant.dequantize_tree(q[k], torch.float32) for k in ("v_decoder", "a_decoder")]
    plain = [dual_params["v_decoder"], dual_params["a_decoder"]]

    def plain_transformer(f, m):          # row 0 alone, on the CPU
        return tr_cpu.predict_tokens(tr_cpu_params, f[1][:1].cpu(), f[0][:1].cpu(),
                                     max_caption_len=L, feat_mask=m[:1].cpu())

    routes = {"dual": (dual, dual_params,
                       lambda f, m: dg.dual_greedy_decode_reference(plain, f, m, L)),
              "dual_int8": (dual, q, lambda f, m: dg.dual_greedy_decode_reference(deq, f, m, L)),
              "transformer": (tr_model, tr_params, plain_transformer)}
    routed = router_phase(card, device, vocab, routes)
    log(f"[phase 9 d] {time.perf_counter() - t0:.1f} s; phase 9 {time.perf_counter() - t9:.1f} s")
    return {"dual_greedy": {"router dual direct": routed["dual"],
                            "router dual int8": routed["dual_int8"],
                            "router default (dual)": routed["(default)"],
                            "int8 weights dual direct": int8["dual direct"]},
            "beam": {"int8 weights dual beam": int8["dual beam"]},
            "greedy": {"int8 weights single direct": int8["single direct"]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    from mvc_tpu_torch.config import EOS_ID, SINGLE_DECODER_CONFIG, VISUAL_DECODER_CONFIG
    from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual
    from mvc_tpu_torch.models.decoder import init_decoder
    from mvc_tpu_torch.ops import _build
    from mvc_tpu_torch.ops import _decode_common as dc
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import greedy as gr

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
            if any(k in line for k in ("registers", "spill", "smem", "entry function")):
                log(f"  {src}: {line.strip()}")

    beam_sass_against_pr5(_build)

    # -- 3. kernels vs plain at full width
    model = AVCaptioningDual(vocab_size=V, device=device)
    params = model.init(torch.Generator().manual_seed(0))
    decoders = spread_bias([params["v_decoder"], params["a_decoder"]], seed=1)
    vf, af, mask = decode_inputs(2, device)
    cells = ("LSTM", "LSTM")
    gru_v = init_decoder(torch.Generator().manual_seed(3),
                         VISUAL_DECODER_CONFIG.replace(rnn_type="GRU", output_size=V),
                         device=device)
    mixed = spread_bias([gru_v, params["a_decoder"]], seed=4)
    bf16 = [{k: {n: t.bfloat16() for n, t in sub.items()} for k, sub in p.items()}
            for p in decoders]
    # a ragged batch (rows not a multiple of the kernels' row tile) whose
    # small B*T puts the audio decoder on the factored branch too
    svf, saf, smask = decode_inputs(5, device, b=5, t=3)
    if not dc._use_factored(5 * 3, 128, params["a_decoder"]["rnn"]["wh"].shape[1]):
        raise SystemExit("the small case no longer takes the audio factored branch")

    g_err = check_dual_greedy(dg, decoders, [vf, af], mask, cells, torch.float32, exact=True)
    check_dual_greedy(dg, bf16, [vf, af], mask, cells, torch.bfloat16, exact=False)
    g_err = max(g_err, check_dual_greedy(dg, mixed, [vf, af], mask, ("GRU", "LSTM"),
                                         torch.float32, exact=True))
    g_err = max(g_err, check_dual_greedy(dg, decoders, [svf, saf], smask, cells,
                                         torch.float32, exact=True))

    # the single model: one decoder over [audio | visual], F=2176 (always
    # factored); the audio-width decoder alone takes the direct branch
    single = AVCaptioning(vocab_size=V, device=device)
    sparams = single.init(torch.Generator().manual_seed(10))
    s_dec = spread_bias([sparams["decoder"]], seed=11)[0]
    s_gru = spread_bias([init_decoder(torch.Generator().manual_seed(12),
                                      SINGLE_DECODER_CONFIG.replace(rnn_type="GRU", output_size=V),
                                      device=device)], seed=13)[0]
    sf, ssf = torch.cat([af, vf], dim=-1), torch.cat([saf, svf], dim=-1)
    s_bf16 = {k: {n: t.bfloat16() for n, t in sub.items()} for k, sub in s_dec.items()}
    if dc._use_factored(B * T, 128, params["a_decoder"]["rnn"]["wh"].shape[1]):
        raise SystemExit("the audio-width decoder no longer takes the direct branch at B*T")
    f32 = torch.float32
    s_err = check_single_greedy(gr, s_dec, sf, mask, "LSTM", f32, True, "AVCaptioning ")
    s_err = max(s_err, check_single_greedy(gr, s_gru, sf, mask, "GRU", f32, True))
    s_err = max(s_err, check_single_greedy(gr, decoders[1], af, mask, "LSTM", f32, True,
                                           "audio decoder alone, direct branch, "))
    s_err = max(s_err, check_single_greedy(gr, s_dec, ssf, smask, "LSTM", f32, True, "ragged "))
    check_single_greedy(gr, s_bf16, sf, mask, "LSTM", torch.bfloat16, False, "AVCaptioning ")

    # the serving shape: B=64 at W=5 is 22 clusters of three clips at R=15,
    # the last holding one clip and two of padding
    b_err, _, steps_main = check_beam(bm, decoders, [vf, af], mask, cells, torch.float32, 0.0,
                                      True, device)
    for alpha, dec_, cells_, feats_, mask_, label in (
            (0.7, decoders, cells, [vf, af], mask, ""),
            (0.0, mixed, ("GRU", "LSTM"), [vf, af], mask, ""),
            (0.7, decoders, cells, [svf, saf], smask, "ragged "),
            (0.0, decoders[:1], ("LSTM",), [vf], mask, "visual only ")):
        err, _, _ = check_beam(bm, dec_, feats_, mask_, cells_, torch.float32, alpha, True,
                               device, label)
        b_err = max(b_err, err)
    eos_heavy = spread_bias([params["v_decoder"], params["a_decoder"]], seed=5, eos_bias=2.0)
    err, tok_eos, steps_eos = check_beam(bm, eos_heavy, [vf, af], mask, cells, torch.float32,
                                         0.7, True, device, "EOS-heavy ")
    b_err = max(b_err, err)
    first_eos = (tok_eos[:, 1:] == EOS_ID).int().argmax(dim=1)
    if not bool((tok_eos[:, 1:] == EOS_ID).any(dim=1).all()) or int(first_eos.max()) >= L // 2 \
            or int(steps_eos.max()) >= L + 1:
        raise SystemExit("the EOS-heavy case did not finish early: the early exit is not exercised")
    log(f"EOS-heavy: first EOS by position {int(first_eos.max()) + 1}, "
        f"steps per clip max {int(steps_eos.max())} of {L + 1}")
    check_beam(bm, bf16, [vf, af], mask, cells, torch.bfloat16, 0.0, False, device, "bf16 ")
    err, _, s_steps_main = check_beam(bm, [s_dec], [sf], mask, ("LSTM",), f32, 0.0, True,
                                      device, "AVCaptioning F=2176 ")
    b_err = max(b_err, err)
    # other packings of the tiles: W=3 (5 clips in 15 rows, 2 in 8), W=8 (1 clip in either)
    for w in (3, 8):
        err, _, _ = check_beam(bm, decoders, [vf, af], mask, cells, f32, 0.7, True, device,
                               f"W={w} ", w=w)
        b_err = max(b_err, err)
    # clips of one cluster stop at different steps; each keeps its own count
    stag, _ = staggered_eos(bm, [params["v_decoder"], params["a_decoder"]], [vf, af], mask, cells)
    err, _, steps_stag = check_beam(bm, stag, [vf, af], mask, cells, f32, 0.7, True, device,
                                    "staggered EOS ")
    b_err = max(b_err, err)
    groups = steps_stag[:63].view(21, 3)
    mixed_groups = int((groups.amax(1) != groups.amin(1)).sum())
    log(f"staggered EOS: 15-row clusters whose clips stop at different steps: {mixed_groups} of "
        f"21; first ones {groups[groups.amax(1) != groups.amin(1)][:4].tolist()}")
    # the longest serving frame bucket, on the 15-row tile
    lvf, laf, lmask = decode_inputs(6, device, t=64)
    la, _tok, _st, lkeep = bm.prepare_kernel_call(decoders, [lvf, laf], lmask, L, W, 0.0, f32,
                                                  cells)
    if bm._library().beam_tile_rows(ctypes.byref(la)) != 15:
        raise SystemExit("T=64 no longer takes the 15-row tile")
    del lkeep
    err, _, _ = check_beam(bm, decoders, [lvf, laf], lmask, cells, f32, 0.0, True, device,
                           "T=64 ", tiles=(0,))
    b_err = max(b_err, err)
    # a clip longer than the 15-row tile holds: the kernel takes the 8-row one
    blib = bm._library()
    sb = decode_inputs(7, device, b=4, t=150)
    xa, _tok, _st, xkeep = bm.prepare_kernel_call(decoders, list(sb[:2]), sb[2], L, W, 0.0, f32,
                                                  cells)
    t_big = largest_t(lambda a: blib.beam_smem_bytes(a, 15), xa, dc.MAX_SMEM_BYTES) + 1
    xa.T = t_big
    if blib.beam_tile_rows(ctypes.byref(xa)) != 8:
        raise SystemExit(f"T={t_big} should take the 8-row tile")
    del xkeep
    bvf, baf, bmask = decode_inputs(7, device, b=4, t=t_big)
    ba, _tok, _st, bkeep = bm.prepare_kernel_call(decoders, [bvf, baf], bmask, L, W, 0.0, f32,
                                                  cells)
    try:
        bm._launch(ba, f32, device, 15)
        raise SystemExit(f"the 15-row tile launched at T={t_big}, above its limit")
    except ValueError as e:
        log(f"T={t_big} on the 15-row tile raises ValueError: {e}")
    del bkeep
    err, _, _ = check_beam(bm, decoders, [bvf, baf], bmask, cells, f32, 0.0, True, device,
                           f"T={t_big} (8-row tile) ", tiles=(0,))
    b_err = max(b_err, err)

    # -- 4. serving through the kernels; each count covers exactly its run
    vocab = synthetic_vocab(V)
    dg.dual_greedy_decode.launches = 0
    requests, captions = serve(model, params, vocab, device, "direct")
    g_launches = dg.dual_greedy_decode.launches
    log(f"dual_greedy_decode launches during direct serving: {g_launches}")
    if g_launches < 1:
        raise SystemExit("the direct serving path never launched the dual_greedy kernel")
    plain_params = [params["v_decoder"], params["a_decoder"]]
    check_served(lambda f, m: dg.dual_greedy_decode_reference(plain_params, f, m, L),
                 requests, captions, vocab, device, "direct")
    serve_over_limit(model, params, vocab, device,
                     lambda f, m: dg.dual_greedy_decode_reference(plain_params, f, m, L))

    bm.beam_decode.launches = 0
    requests, captions = serve(model, params, vocab, device, "beam")
    b_launches = bm.beam_decode.launches
    log(f"beam_decode launches during beam serving: {b_launches}")
    if b_launches < 1:
        raise SystemExit("the beam serving path never launched the beam kernel")
    check_served(lambda f, m: bm.beam_decode_reference(plain_params, f, m, L, W),
                 requests, captions, vocab, device, "beam")

    # the single model, direct then beam; the service concatenates nothing:
    # AVCaptioning.predict_tokens does, audio first
    def single_feats(f):
        return torch.cat([f[1], f[0]], dim=-1)

    gr.greedy_decode.launches = 0
    requests, captions = serve(single, sparams, vocab, device, "direct", "single ")
    s_launches = gr.greedy_decode.launches
    log(f"greedy_decode launches during single-model direct serving: {s_launches}")
    if s_launches < 1:
        raise SystemExit("the single-model direct serving path never launched the greedy kernel")
    check_served(lambda f, m: gr.greedy_decode_reference(sparams["decoder"], single_feats(f), m, L),
                 requests, captions, vocab, device, "single direct")

    bm.beam_decode.launches = 0
    requests, captions = serve(single, sparams, vocab, device, "beam", "single ")
    sb_launches = bm.beam_decode.launches
    log(f"beam_decode launches during single-model beam serving: {sb_launches}")
    if sb_launches < 1:
        raise SystemExit("the single-model beam serving path never launched the beam kernel")
    check_served(lambda f, m: bm.beam_decode_reference([sparams["decoder"]], [single_feats(f)], m,
                                                       L, W, rnn_types=("LSTM",)),
                 requests, captions, vocab, device, "single beam")

    # -- 5. times (warm-up excluded)
    feats = [vf, af]
    g_args, _tok, g_keep = dg.prepare_kernel_call(decoders, feats, mask, L, f32, cells)
    g_ms, g_plain, g_launch = time_calls(
        lambda: dg.dual_greedy_decode(decoders, feats, mask, L, f32, cells),
        lambda: dg.dual_greedy_decode_reference(decoders, feats, mask, L, f32, cells),
        lambda: dg._launch(g_args, f32, device))
    g_pre, g_kern, g_bytes = decode_work(decoders, (2048, 128), B * (L - 1), B * L, 4)
    g_bound, g_bound_k, g_by = bounds(g_pre, g_kern, g_bytes)
    log(f"[{card}] dual_greedy_decode (wrapper: keys/P matmuls + kernel) f32 B={B} T={T} "
        f"L={L} V={V}: {g_ms:.4f} ms")
    log(f"[{card}] dual_greedy kernel launch alone: {g_launch:.4f} ms")
    log(f"[{card}] dual_greedy plain PyTorch version: {g_plain:.4f} ms")
    log(f"[{card}] dual_greedy bound (whole call, operations {(g_pre + g_kern) / 1e9:.2f} GFLOP "
        f"at 67 TFLOP/s f32; bytes {g_bytes / 1e6:.1f} MB at 3.35 TB/s): {g_bound:.4f} ms")
    log(f"[{card}] dual_greedy bound (kernel alone, {g_kern / 1e9:.2f} GFLOP): {g_bound_k:.4f} ms")
    lib = dg._library()
    stream_layout(card, "dual_greedy", lib.dual_greedy_smem_bytes, g_args, g_keep[0])
    g_repack = cuda_ms(lambda: [dc.stream_operands(p, V) for p in g_keep[0]], 5)
    log(f"[{card}] dual_greedy weight repack inside the wrapper (f32): {g_repack:.4f} ms")
    log(f"dual_greedy max_frames at B={B}: {dg.max_frames(decoders, cells, B)}")
    phase_timers(card, "dual_greedy f32", "dual_greedy", lib, g_args, f32, device)
    del g_keep
    bf = torch.bfloat16
    gb_args, _tok, gb_keep = dg.prepare_kernel_call(bf16, feats, mask, L, bf, cells)
    gb_ms, gb_plain, gb_launch = time_calls(
        lambda: dg.dual_greedy_decode(bf16, feats, mask, L, bf, cells),
        lambda: dg.dual_greedy_decode_reference(bf16, feats, mask, L, bf, cells),
        lambda: dg._launch(gb_args, bf, device))
    log(f"[{card}] dual_greedy_decode bf16 B={B} T={T}: wrapper {gb_ms:.4f} ms, kernel launch "
        f"alone {gb_launch:.4f} ms, plain {gb_plain:.4f} ms (token agreement above)")
    phase_timers(card, "dual_greedy bf16", "dual_greedy", lib, gb_args, bf, device)
    del gb_keep

    b_args, _tok, b_steps, b_keep = bm.prepare_kernel_call(decoders, feats, mask, L, W, 0.0,
                                                           f32, cells)
    b_ms, b_plain, b_launch = time_calls(
        lambda: bm.beam_decode(decoders, feats, mask, L, W, 0.0, f32, cells),
        lambda: bm.beam_decode_reference(decoders, feats, mask, L, W, 0.0, f32, cells),
        lambda: bm._launch(b_args, f32, device))
    torch.cuda.synchronize()
    if not torch.equal(b_steps, steps_main):
        raise SystemExit("the timed beam launches ran another number of steps")
    row_steps = int(b_steps.sum()) * W
    b_pre, b_kern, b_bytes = decode_work(decoders, (2048, 128), row_steps, B * (L + 2), 4)
    b_bound, b_bound_k, b_by = bounds(b_pre, b_kern, b_bytes)
    log(f"beam steps per clip (kernel, timed input): min {int(b_steps.min())} max "
        f"{int(b_steps.max())} of {L + 1}; row-steps {row_steps}")
    log(f"[{card}] beam_decode (wrapper: keys/P matmuls + kernel) f32 B={B} W={W} T={T} "
        f"max_len={L} V={V}: {b_ms:.4f} ms")
    log(f"[{card}] beam kernel launch alone: {b_launch:.4f} ms")
    log(f"[{card}] beam plain PyTorch version: {b_plain:.4f} ms")
    log(f"[{card}] beam bound (whole call, operations {(b_pre + b_kern) / 1e9:.2f} GFLOP at "
        f"67 TFLOP/s f32; bytes {b_bytes / 1e6:.1f} MB at 3.35 TB/s): {b_bound:.4f} ms")
    log(f"[{card}] beam bound (kernel alone, {b_kern / 1e9:.2f} GFLOP): {b_bound_k:.4f} ms")
    del b_keep

    # the single model's greedy kernel, f32 (the record's) and bf16 (bench.py's greedy dtype)
    s_times = {}
    for wd, dec_, peak in ((f32, s_dec, PEAK_F32_FLOPS), (torch.bfloat16, s_bf16, PEAK_BF16_FLOPS)):
        s_args, _tok, s_keep = gr.prepare_kernel_call(dec_, sf, mask, L, wd, "LSTM")
        ms, plain, launch = time_calls(
            lambda: gr.greedy_decode(dec_, sf, mask, L, wd, "LSTM"),
            lambda: gr.greedy_decode_reference(dec_, sf, mask, L, wd, "LSTM"),
            lambda: gr._launch(s_args, wd, device))
        nbytes_w = 4 if wd == f32 else 2
        pre, kern, nbytes = decode_work([dec_], (2176,), B * (L - 1), B * L, nbytes_w)
        bound, bound_k, by = bounds(pre, kern, nbytes, peak)
        s_times[wd] = (ms, plain, bound, by)
        peak_txt = "67 TFLOP/s f32" if wd == f32 else "989 TFLOP/s bf16"
        log(f"[{card}] greedy_decode (wrapper: keys/P matmuls + kernel) {wd} AVCaptioning "
            f"F=2176 B={B} T={T} L={L} V={V}: {ms:.4f} ms")
        log(f"[{card}] greedy kernel launch alone {wd}: {launch:.4f} ms")
        log(f"[{card}] greedy plain PyTorch version {wd}: {plain:.4f} ms")
        log(f"[{card}] greedy bound {wd} (whole call, operations {(pre + kern) / 1e9:.2f} GFLOP "
            f"at {peak_txt}; bytes {nbytes / 1e6:.1f} MB at 3.35 TB/s): {bound:.4f} ms")
        log(f"[{card}] greedy bound {wd} (kernel alone, {kern / 1e9:.2f} GFLOP): {bound_k:.4f} ms")
        if wd == f32:
            stream_layout(card, "greedy", gr._library().greedy_smem_bytes, s_args, s_keep[0])
            repack = cuda_ms(lambda: [dc.stream_operands(p, V) for p in s_keep[0]], 5)
            log(f"[{card}] greedy weight repack inside the wrapper (f32): {repack:.4f} ms")
            log(f"greedy max_frames at B={B}: {gr.max_frames(dec_, 'LSTM', B)}")
        phase_timers(card, f"greedy {wd}", "greedy", gr._library(), s_args, wd, device)
        del s_keep
    s_ms, s_plain, s_bound, s_by = s_times[f32]

    # the single model's beam: beam.cu with one decoder at F=2176
    sb_args, _tok, sb_steps, sb_keep = bm.prepare_kernel_call([s_dec], [sf], mask, L, W, 0.0,
                                                              f32, ("LSTM",))
    sb_ms, sb_plain, sb_launch = time_calls(
        lambda: bm.beam_decode([s_dec], [sf], mask, L, W, 0.0, f32, ("LSTM",)),
        lambda: bm.beam_decode_reference([s_dec], [sf], mask, L, W, 0.0, f32, ("LSTM",)),
        lambda: bm._launch(sb_args, f32, device))
    torch.cuda.synchronize()
    if not torch.equal(sb_steps, s_steps_main):
        raise SystemExit("the timed single-model beam launches ran another number of steps")
    row_steps = int(sb_steps.sum()) * W
    pre, kern, nbytes = decode_work([s_dec], (2176,), row_steps, B * (L + 2), 4)
    sb_bound, sb_bound_k, _ = bounds(pre, kern, nbytes)
    log(f"[{card}] beam_decode one decoder AVCaptioning F=2176 f32 B={B} W={W} T={T} "
        f"max_len={L} V={V} (steps max {int(sb_steps.max())}): wrapper {sb_ms:.4f} ms, "
        f"kernel launch alone {sb_launch:.4f} ms, plain {sb_plain:.4f} ms, bound "
        f"{sb_bound:.4f} ms whole call / {sb_bound_k:.4f} ms kernel ({kern / 1e9:.2f} GFLOP)")
    del sb_keep
    # the beam kernel at each row tile, last: its long runs come after every
    # other kernel's timing
    beam_tiles(bm, dc, card, decoders, [vf, af], mask, cells, s_dec, sf, device)

    # -- 6. training, 7. the rest of the trainer and service, on one synthetic tree
    import shutil

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise SystemExit("float32 matmuls must run without TF32")
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    ds, vocab_path = write_synthetic_msvd(TRAIN_ROOT)
    log(f"[train] synthetic MSVD tree (512 train, 128 val clips, T 20..40, V={V}) written in "
        f"{time.perf_counter() - t0:.2f} s")
    fit_launches, direct_tr = train_phase(card, device, ds, vocab_path)
    rest_launches = rest_phase(card, device, ds, vocab_path, direct_tr, (model, params, vocab),
                               lambda f, m: dg.dual_greedy_decode_reference(plain_params, f, m, L))

    # -- 8. extraction and COCO evaluation (no decode kernel runs here)
    extract_phase(card, device, os.path.join(TRAIN_ROOT, "results",
                                             "captions_cached_last_val_direct.csv"))

    # -- 9. the transformer, int8 weights and the router, on the same tree
    p9 = phase9(card, device, ds, vocab_path, vocab, model,
                {"v_decoder": decoders[0], "a_decoder": decoders[1]},
                {"decoder": s_dec, "reconstructor": None})
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)

    record = {"kernels": [
        {"name": "dual_greedy_decode", "route": "cuda",
         "source": "mvc_tpu_torch/csrc/dual_greedy.cu",
         "replaces": "mvc_tpu/ops/pallas_dual_greedy.py:314",
         "launches": g_launches, "max_abs_err": g_err,
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": None,
         "launches_by_path": {"serve dual direct": g_launches,
                              "train fit direct eval": fit_launches["dual_greedy"],
                              **{k.split(" ", 1)[1]: v for k, v in rest_launches.items()
                                 if k.startswith("dual_greedy ")},
                              **p9["dual_greedy"]}},
        {"name": "beam_decode", "route": "cuda",
         "source": "mvc_tpu_torch/csrc/beam.cu",
         "replaces": "mvc_tpu/ops/pallas_beam.py:578",
         "launches": b_launches, "max_abs_err": b_err,
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by,
         "library_ms": None,
         "launches_by_path": {"serve dual beam": b_launches, "serve single beam": sb_launches,
                              "train fit beam eval": fit_launches["beam"],
                              **{k.split(" ", 1)[1]: v for k, v in rest_launches.items()
                                 if k.startswith("beam ")},
                              **p9["beam"]}},
        {"name": "greedy_decode", "route": "cuda",
         "source": "mvc_tpu_torch/csrc/greedy.cu",
         "replaces": "mvc_tpu/ops/pallas_decode.py:366",
         "launches": s_launches, "max_abs_err": s_err,
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None,
         "launches_by_path": {"serve single direct": s_launches,
                              **{k.split(" ", 1)[1]: v for k, v in rest_launches.items()
                                 if k.startswith("greedy ")},
                              **p9["greedy"]}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
