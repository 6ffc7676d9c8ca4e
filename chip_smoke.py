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
   kernel's launch count is set to 0 just before its run and read just after
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
10. the one-command rehearsal, ``cli.rehearse_real_data``, at full width:
   (a) seeded stand-in weights in memory (``utils/torch_oracles``, through
   the converters), 24 synthetic MJPG clips of 8 s at 5 fps, extraction, the
   vocabulary, an 8-epoch cached fit of ``AVCaptioningDual`` with global
   reconstructors whose eval decodes through ``beam.cu`` (W=5), scores: no
   extraction failure, two clips' features against the CPU's, the fit's val
   captions against the plain beam decode of its final params (>= 99 % of
   the tokens), the seconds of each step and the padded-frame share; (b)
   the same stand-ins' state dicts as weight files (``MVC_WEIGHTS_DIR``) on
   (a)'s first 16 clips with a direct eval through ``dual_greedy.cu``: the
   features equal (a)'s; (c) the native metrics runtime (g++): built, its
   four functions exactly the Python paths' over 7's val captions and
   (a)'s, ``COCOEvalCap`` timed with it and without it (8 (e) times the
   Python paths)
11. the data-parallel mesh at full width, on phase 3's trees and phase
   6-7's tree: (a) ``predict_tokens(mesh=)`` over dp=4 shards of the card,
   each on its own CUDA stream, dual direct, dual beam and single direct at
   B=64 and B=62 (padded to 64): tokens equal to the unsharded call's and
   the plain version's, one launch a shard, 4 x 16 rows against 1 x 64 rows
   timed; (b) ``cli.train --dp 1`` under an NCCL group of one rank against
   the CLI with no process group (history within 1e-6, eval captions
   against the plain decode), the step with and without the mesh and the
   gradients' NCCL all-reduce timed; (c) two spawned ranks on the one card
   over gloo, 3 steps of a global batch of 128 with a padded last batch
   against one process over the union batch (loss and every gradient leaf
   within 1e-4, ranks' parameters equal), each rank's eval through
   ``dual_greedy.cu`` gathered equal to one process's, gloo's all-reduce
   timed; (d) ``FeatureExtractor(mesh=)`` over 2 shards on 8 of phase 8's
   clips (within 1e-5 of one device); (e) ``CaptionService(mesh=)`` dual
   direct behind HTTP, 16 requests
12. tensor and sequence parallelism at full width, on phase 6-7's tree:
   four ranks spawned on the one card over gloo as a (dp=1, tp=2, sp=2)
   mesh, ``AVCaptioningDual`` with global reconstructors: (a) 3 train steps
   of B=128 (the last batch padded) against one process over the same
   batch (loss and every gradient leaf, gathered, within 1e-4 relative;
   replicated parameters equal on every rank, the vocab slices of one tp
   index equal); (b) a 1-epoch ``Trainer.fit`` on the mesh whose eval
   gathers the vocab slices and decodes through ``dual_greedy.cu``
   (launches counted on every rank), its gathered val captions equal to
   one process's decode of the same params and to the plain decode's
   (>= 99 %); (c) one step with local reconstructors against one process;
   (d) the step at T=28, L=8 on the mesh and, on rank 0, alone over the
   same batch, each gradient bucket's gloo all-reduce and the ranks'
   start-up timed
13. the transformer on the tp/sp mesh at full width (``TransformerConfig``'s
   defaults, V=4000, generator bias spread), on phase 6-7's tree: four
   ranks spawned on the one card over gloo as a (1, 2, 2) mesh, each with
   its slice of the embedding (the only leaf JAX's layout splits) and,
   when sp divides T, its block of the frames: (a) 3 train steps of B=128
   (the last batch padded), each also taken on rank 0 alone from the
   mesh's parameters, in float32 and float64: the loss and each gathered
   gradient leaf within 1e-4 relative of one process's (the attention key
   biases, whose gradient is zero, within 1e-7 of the largest leaf), the
   leaves float32 itself does not resolve (one process over 1e-4 from
   float64) counted and within 1e-3 of float64; replicated parameters
   equal on every rank, the slices of one tp index equal; (c) the step at
   T=28, L=8 on the
   mesh and, on rank 0, alone over the same batch, the all-reduces of one
   step counted, each gradient bucket's gloo all-reduce timed; (b) a
   1-epoch ``Trainer.fit`` on the mesh with a direct eval over the gathered
   parameters, its gathered val captions equal to one process's decode of
   the same params on >= 99 % of the tokens
14. the benchmark entry points, in this process: ``cli.bench`` with its
   five metrics at their full shapes and counts (bf16 beam, single greedy
   and dual greedy at B=1024 through the kernels, the bf16-compute train
   step, extraction of 16 clips of 10 s), then ``cli.bench_serving`` in
   direct and beam mode at reduced counts (``SERVING_ARGS``); their JSON
   lines printed as they come, each naming the card, every metric correct
   with no share above 100 %, every serving request completed
15. any clip length and beams up to 16, at full width, each exactly the
   plain version in float32: (a) the serving and bench shapes keep their
   layouts (the greedy kernels' score rows in shared memory, the beam's
   15-row tile);
   (b) ``dual_greedy.cu`` at T=1024 and T=4096, ``greedy.cu`` at T=4096,
   ``beam.cu`` (dual, W=5) at T=2048, B=8, with their score rows in the
   global workspace; (c) ``beam.cu`` at W=9, 12 and 16 on the 16-row tile
   (B=16, T=16), a beam of 17 refused; (d) a T=1024 dual-direct clip posted
   over HTTP with 8 short ones (all captioned, as the plain version does)
   and ``AVCaptioningDual.predict`` in both modes at T=1024; each case's
   time beside the plain version's and its bound

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

from mvc_tpu_torch.cli.bench import spread_bias
from mvc_tpu_torch.utils.roofline import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bounds,
                                          decode_work, model_flops, trace_busy, train_step_work,
                                          transformer_work, tree_bytes)

V, B, T, L = 4000, 64, 16, 30
W = 5                        # beam width of the beam phases
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


def largest_t(smem_fn, ws_fn, args, limit=232448):
    """The largest T a launch takes with everything in shared memory (a
    block within ``limit`` bytes and no global workspace), on the branch
    (factored or direct) each decoder of ``args`` takes."""
    t0, t_max = args.T, 0
    while t_max < 1 << 16:
        args.T = t_max + 1
        if smem_fn(ctypes.byref(args)) > limit or ws_fn(ctypes.byref(args)):
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


def stream_layout(card, label, lib, args, prep):
    """The greedy kernel's shared-memory need against the Python replica of
    its layout (ops/_decode_common.greedy_layout); fails if they differ.
    Returns the replica's layout."""
    from mvc_tpu_torch.ops import _decode_common as dc

    smem_fn = getattr(lib, f"{label}_smem_bytes")
    ws_fn = getattr(lib, f"{label}_workspace_floats")
    decs = [{k: p[k] for k in ("H", "A", "E", "F", "cell", "factored")} for p in prep]
    lay = dc.greedy_layout(decs, args.T, args.V)
    got, ws = smem_fn(ctypes.byref(args)), ws_fn(ctypes.byref(args))
    log(f"{label} shared memory per block at B={args.B} T={args.T}: {got} bytes (replica "
        f"{lay['bytes']}), ring of {lay['stages']} stages of {dc.STAGE_BYTES} bytes, score rows "
        f"in {'the global workspace' if lay['att_global'] else 'shared memory'} ({ws} "
        f"workspace floats); largest T in shared memory at these widths: "
        f"{largest_t(smem_fn, ws_fn, args, dc.MAX_SMEM_BYTES)}")
    if got != lay["bytes"] or bool(ws) != lay["att_global"]:
        raise SystemExit(f"{label}: the kernel's layout and its Python replica disagree")
    nbytes = sum(sum(st) for *_, st in dc.stream_plan(decs, args.V, 4))
    log(f"[{card}] {label} weight stream per block and step (f32): {nbytes / 1e6:.3f} MB, "
        f"{nbytes * dc.CL * -(-args.B // dc.ROWS) / 1e6:.1f} MB over the grid")
    return lay


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


def serve(model, params, vocab, device, mode, label="", transfer="f32", mesh=None,
          n_singles=24, n_batches=2):
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server

    tag = f"{label}{mode}" + ("" if transfer == "f32" else f" over the {transfer} wire")
    rng = np.random.default_rng(0)

    def clip():
        t = int(rng.integers(3, 41))
        return {"visual": rng.normal(size=(t, 2048)).astype(np.float32).round(3).tolist(),
                "audio": rng.normal(size=(t, 128)).astype(np.float32).round(3).tolist()}

    singles = [clip() for _ in range(n_singles)]
    batches = [[clip() for _ in range(12)] for _ in range(n_batches)]
    cfg = ServiceConfig(max_batch=64, mode=mode, beam_width=W, frame_buckets=BUCKETS,
                        max_caption_len=L, transfer=transfer)
    svc = CaptionService(model, params, vocab, cfg, device=device, mesh=mesh)
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


def serve_long_clip(model, params, vocab, device, plain_fn, t_long):
    """One dual-direct clip of ``t_long`` frames, longer than the kernel
    keeps in shared memory (the service refused such a clip before the
    kernels took any length), posted with 8 short clips at once: every
    request gets HTTP 200 and the plain version's caption.  Returns the
    kernel's launches while the service runs."""
    from mvc_tpu_torch.data.dataset import _bucket
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server

    cfg = ServiceConfig(max_batch=64, mode="direct", frame_buckets=BUCKETS, max_caption_len=L,
                        max_wait_ms=200.0)
    rng = np.random.default_rng(3)
    bodies = [{"visual": rng.normal(size=(t, 2048)).astype(np.float32).round(3).tolist(),
               "audio": rng.normal(size=(t, 128)).astype(np.float32).round(3).tolist()}
              for t in list(rng.integers(3, 41, size=8)) + [t_long]]
    dg.dual_greedy_decode.launches = 0
    svc = CaptionService(model, params, vocab, cfg, device=device)
    server = make_http_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        captions = post_all(f"http://127.0.0.1:{server.server_address[1]}", bodies)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        svc.close()
    launches = dg.dual_greedy_decode.launches
    log(f"[long clip] the service's frame limit {svc.max_frames}; a clip of T={t_long} (bucket "
        f"{_bucket(t_long, BUCKETS)}) posted with 8 short ones: all answered; dual_greedy "
        f"launches {launches}")
    if launches < 2:
        raise SystemExit("the long clip and its batch-mates did not run through the kernel")
    check_served(plain_fn, bodies, captions, vocab, device, "long clip and its batch-mates", n=9)
    return launches


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
            t_max = largest_t(lambda a, r=rows: lib.beam_smem_bytes(a, r),
                              lambda a, r=rows: lib.beam_workspace_floats(a, r), args,
                              dc.MAX_SMEM_BYTES)
            log(f"[{card}] beam {label} W={w} R={rows}: shared memory per block at T={T} "
                f"{lib.beam_smem_bytes(ctypes.byref(args), rows)} bytes, workspace "
                f"{lib.beam_workspace_floats(ctypes.byref(args), rows)} floats, largest T in "
                f"shared memory {t_max}, "
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


def smoke_trainer(checkpoint_name, base=None, **kw):
    """A ``Trainer`` (``base``, by default the package's; ``kw``: its other
    arguments; by default no log dir and an eval every epoch) whose scalars
    are recorded and which keeps each eval's captions,
    ``generated[phase, epoch]`` and ``references[phase, epoch]`` (``{video:
    [caption]}``), the model, params and loader of the last eval of each
    phase (``evaluated[phase]``), and the seconds of all its evals
    (``eval_s``)."""
    if base is None:
        from mvc_tpu_torch.training.trainer import Trainer as base

    class SmokeTrainer(base):
        def eval(self, model, params, loader, phase, epoch, *a, **k):
            t0 = time.perf_counter()
            out = super().eval(model, params, loader, phase, epoch, *a, **k)
            self.eval_s += time.perf_counter() - t0
            self.references[phase, epoch], self.generated[phase, epoch] = out[1], out[2]
            self.evaluated[phase] = (model, params, loader)
            return out

    tr = SmokeTrainer(checkpoint_name, **{"log_dir": None, "eval_freq": 1, **kw})
    tr.summary_writer = RecordingWriter()
    tr.generated, tr.references, tr.evaluated, tr.eval_s = {}, {}, {}, 0.0
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
        self.leaves = opt.leaves

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

    equal = total = tokens_equal = tokens = 0
    differ = []
    with torch.no_grad():
        for batch in loader:
            b = tr._put_batch(batch, model.device)
            caps = captions_from_tokens(vocab, plain_fn(b))
            for vid, cap in zip(batch["video_ids"], caps):
                same = generated[vid][0] == cap
                equal += same
                total += 1
                k, p = generated[vid][0].split() + ["<EOS>"], cap.split() + ["<EOS>"]
                tokens_equal += sum(x == y for x, y in zip(k, p))
                tokens += max(len(k), len(p))
                if not same and len(differ) < 3:
                    differ.append((vid, generated[vid][0], cap))
    share = equal / total
    log(f"[train {label}] eval captions equal to the plain version's decode of the same "
        f"params: {equal}/{total} ({100 * share:.2f} %; tokens, EOS included, "
        f"{tokens_equal}/{tokens}, {100 * tokens_equal / tokens:.2f} %); differing (video, "
        f"kernel, plain): {differ}")
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


def plain_beam(params, b, cfg):
    """The plain version of the dual fit's beam eval decode."""
    from mvc_tpu_torch.ops import beam as bm

    return bm.beam_decode_reference([params["v_decoder"], params["a_decoder"]],
                                    [b["visual"], b["audio"]], b["feat_mask"],
                                    cfg.eval_max_caption_len, cfg.eval_beam_width,
                                    cfg.eval_beam_alpha, torch.float32, ("LSTM", "LSTM"))


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
    span, busy, n_device, by_name = trace_busy(path)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    size = f"torch.profiler trace ({os.path.getsize(path) / 1e6:.1f} MB)"
    if busy is None:
        log(f"[{card}] [{label}] {size}: span {span:.2f} ms, no device activity in the trace "
            "(the profiler saw no CUDA events): card busy share not measured")
        return
    log(f"[{card}] [{label}] {size}: span {span:.2f} ms, card busy {busy:.2f} ms "
        f"({100 * busy / span:.2f} %) in {n_device} kernels and copies; top: "
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


def coco_inputs(captions_csv, out_dir):
    """(gts, res, lexicon path) from a ``predict_captions`` CSV; the SPICE
    lexicon, written to ``out_dir``, gives each word of the captions a
    class in turn."""
    import csv

    gts, res = {}, {}
    with open(captions_csv) as f:
        for row in csv.DictReader(f):
            gts[row["video_id"]] = row["ground_truth"].split(" | ")
            res[row["video_id"]] = [row["generated"]]
    words = sorted({w for caps in gts.values() for c in caps for w in c.split()}
                   | {w for (c,) in res.values() for w in c.split()})
    lexicon = os.path.join(out_dir, "spice_lexicon.txt")
    os.makedirs(out_dir, exist_ok=True)
    classes = ("noun", "noun", "verb", "adj", "noun", "adv")
    with open(lexicon, "w") as f:
        for i, w in enumerate(words):
            f.write(f"{w} {classes[i % len(classes)]}\n")
    return gts, res, lexicon


def coco_phase(card, captions_csv):
    """(e) ``COCOEvalCap`` (PTB tokenizer, BLEU, METEOR, ROUGE-L, CIDEr and
    SPICE with a lexicon written over the synthetic vocabulary) over the
    val captions phase 7's ``predict_captions`` wrote, on the metrics'
    pure-Python paths (phase 10 (c) times the native runtime beside them)."""
    from mvc_tpu_torch.evalcap import COCOEvalCap, use_native

    gts, res, lexicon = coco_inputs(captions_csv, EXTRACT_ROOT)
    old = use_native(False)
    try:
        t0 = time.perf_counter()
        coco = COCOEvalCap(gts, res, spice_lexicon=lexicon)
        scores = coco.evaluate()
        log(f"[extract e] COCOEvalCap over {len(res)} val captions (phase 7 predict_captions, "
            f"direct) with SPICE, Python paths, {time.perf_counter() - t0:.2f} s: "
            f"{json.dumps(scores)}")
        keys = {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "SPICE"}
        if set(scores) != keys or not all(np.isfinite(v) and v >= 0 for v in scores.values()) \
                or not 0 <= scores["SPICE"] <= 1 or set(coco.imgToEval) != set(res):
            raise SystemExit(f"COCOEvalCap gave {scores}")
        # each video's first reference as its caption: every candidate n-gram
        # and tuple is in the references, so BLEU-4 and ROUGE-L are 1, SPICE's
        # precision is 1 (its F well above 0)
        oracle = COCOEvalCap(gts, {v: caps[:1] for v, caps in gts.items()},
                             spice_lexicon=lexicon).evaluate()
        log(f"[extract e] the same harness with each video's first reference as its caption: "
            f"{json.dumps(oracle)}")
        if not (oracle["Bleu_4"] > 0.99 and oracle["ROUGE_L"] > 0.99 and oracle["SPICE"] > 0.5):
            raise SystemExit(f"COCOEvalCap scored references against themselves as {oracle}")
    finally:
        use_native(old)


# -- 9. the transformer (train and serve), int8 weights, the router ----------

TRANSFORMER_CONFIG = None     # TransformerConfig's defaults: d_model 512, 8 heads, 2 layers


def transformer_model(device):
    """``TransformerCaptioning`` at full width (``TransformerConfig``'s
    defaults), V=4000, seeded weights."""
    from mvc_tpu_torch.models import TransformerCaptioning

    model = TransformerCaptioning(vocab_size=V, config=TRANSFORMER_CONFIG, device=device)
    return model, model.init(torch.Generator().manual_seed(20))


def float64_transformer(dev):
    """``transformer_model``'s model and weights in float64, its log-softmax
    too (the model takes log-probs in float32 whatever its dtype, as JAX
    does): a reference, not a path the port runs."""
    from mvc_tpu_torch.models import transformer as tmod

    model, params = transformer_model(dev)

    def fused_logp(p, xv, xa):
        return 0.5 * sum(torch.log_softmax(tmod._proj(p["generator"], tmod._layernorm(ln, x))
                                           .double(), -1)
                         for ln, x in ((p["ln_v"], xv), (p["ln_a"], xa)))

    model.dtype, model._fused_logp = torch.float64, fused_logp
    return model, to_device(params, dev, torch.float64)


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
        flops, nbytes = transformer_work(model, params, B, T,
                                         [(rows, p) for p in range(n_steps)], L)
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
    batch = first_train_batch(ds, vocab_path)
    runs = {key: train_step_on(make, cfg, batch, dev)
            for key, make, dev in (("card", transformer_model, device),
                                   ("cpu", transformer_model, torch.device("cpu")),
                                   ("card f64", float64_transformer, device))}
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
        raise SystemExit(f"requests failed: {[r for r in replies if r[0] != 200][:3]}")
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


# -- 10. the real-data rehearsal, weights from files, the native runtime -----

REHEARSAL_ROOT = "build/chip_smoke_rehearsal"
REHEARSAL_CLIPS, REHEARSAL_SECONDS = 24, 8.0     # MSVD-like clips (~10 s)
REHEARSAL_FPS = 5               # clips written here at 5 fps: 25 (the writer's default)
                                # would spend ~40 s of host time on synthesis alone
REHEARSAL_EPOCHS = 8            # after 2 epochs the beam eval ends every caption at its first
                                # token (a CPU run): the token check would compare EOS alone
REHEARSAL_FILE_CLIPS = 16                         # (b): (a)'s first extraction chunk
REHEARSAL_CHUNK, REHEARSAL_BUCKETS = 16, (64, 128, 256)   # the rehearsal's extraction


def rehearse(argv, env):
    """``python -m mvc_tpu_torch.cli.rehearse_real_data <argv>`` with only
    ``env`` of its two variables set and its ``Trainer`` a
    ``smoke_trainer``; prints the summary line ``main`` prints.  Returns
    (its ``run``, the trainer)."""
    from mvc_tpu_torch.cli import rehearse_real_data as rr

    trainers = []

    def trainer(checkpoint_name, **kw):
        trainers.append(smoke_trainer(checkpoint_name, **kw))
        return trainers[-1]

    names = ("MVC_WEIGHTS_DIR", "MVC_DATA_DIR")
    saved = {k: os.environ.pop(k) for k in names if k in os.environ}
    os.environ.update(env)
    trainer_cls, rr.Trainer = rr.Trainer, trainer
    try:
        run = rr.run(rr.parse_args(argv))
    finally:
        rr.Trainer = trainer_cls
        for k in names:
            os.environ.pop(k, None)
        os.environ.update(saved)
    log(json.dumps(run.summary))
    s = run.summary
    if s["extracted"]["failures"] or not np.isfinite(s["final_train_loss"]) \
            or "CIDEr" not in s["val_score"]:
        raise SystemExit(f"the rehearsal gave {s}")
    return run, trainers[0]


def rehearsal_agreement(tr, plain_fn, label):
    """``eval_agreement`` of the rehearsal fit's last val eval: the captions
    its kernel decoded against ``plain_fn``'s decode of the same (final)
    params on the same batches; fails below 99 % of the captions."""
    from mvc_tpu_torch.config import TrainerConfig

    model, params, loader = tr.evaluated["val"]
    epoch = max(e for phase, e in tr.generated if phase == "val")
    eval_agreement(tr, model, loader, tr._vocab, tr.generated["val", epoch],
                   lambda b: plain_fn(params, b, TrainerConfig()), label, 0.99)


def clip_features(root, names):
    """{clip: (video [T, 2048], audio [N, 128])} as the extraction saved them."""
    out = {}
    for n in names:
        base = os.path.splitext(n)[0]
        out[n] = tuple(np.load(os.path.join(root, "features", kind, base + ".npy"))
                       for kind in ("video", "audio"))
    return out


MSVD_REFS = 41           # MSVD: 80,827 English captions over 1,970 clips


def msvd_shaped(gts, seed=0):
    """Each clip's references extended to MSVD's count, ``MSVD_REFS``, with
    captions of 5..11 words drawn Zipf-like (by rank of frequency) from the
    words of all the references."""
    from collections import Counter

    rng = np.random.default_rng(seed)
    words = [w for w, _ in Counter(w for caps in gts.values() for c in caps
                                   for w in c.split()).most_common()]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    return {v: caps + [" ".join(words[i] for i in rng.choice(len(words),
                                                            int(rng.integers(5, 12)), p=p))
                       for _ in range(MSVD_REFS - len(caps))]
            for v, caps in gts.items()}


def native_runtime(card, captions_csv, tr_a):
    """(c) the native metrics runtime: built, its four functions exactly the
    Python paths' over phase 7's val captions and the rehearsal's, and
    ``COCOEvalCap`` timed with it and without it over three sets of the
    same 128 clips: phase 7's captions with their 2 references, each
    clip's first reference as its caption, and phase 7's captions against
    ``MSVD_REFS`` references (``msvd_shaped``)."""
    from mvc_tpu_torch.evalcap import COCOEvalCap, _native, native_status, use_native
    from mvc_tpu_torch.evalcap import meteor as tm
    from mvc_tpu_torch.evalcap import rouge as trouge
    from mvc_tpu_torch.evalcap import tokenizer as ttok
    from mvc_tpu_torch.evalcap.stemmer import porter_stem

    old = use_native(True)
    status = native_status()
    log(f"[rehearsal c] native metrics runtime: {json.dumps(status)}")
    if not (status["built"] and _native.available()):
        raise SystemExit(f"the native metrics runtime did not build: {status['error']}")
    gts, res, lexicon = coco_inputs(captions_csv, REHEARSAL_ROOT)
    epoch = max(e for phase, e in tr_a.generated if phase == "val")
    pairs = [(res[v][0], gts[v]) for v in res]
    pairs += [(tr_a.generated["val", epoch][v][0], refs)
              for v, refs in tr_a.references["val", epoch].items()]
    counts = dict.fromkeys(("ptb_tokenize", "meteor_stats", "meteor_align_spans", "lcs"), 0)
    for hyp_s, refs in pairs:
        toks = []
        for line in [hyp_s, *refs]:
            t = _native.ptb_tokenize(line)
            if t != ttok._ptb_tokenize_line_py(line):
                raise SystemExit(f"ptb_tokenize differs from the Python path on {line!r}")
            counts["ptb_tokenize"] += 1
            toks.append(t)
        hyp = toks[0]
        for ref in toks[1:]:
            hst, rst = [porter_stem(w) for w in hyp], [porter_stem(w) for w in ref]
            m = tm._align(hyp, ref)
            want = (sum(tm._match_weight(hyp[i], ref[j]) for i, j in m), len(m),
                    tm._count_chunks(m))
            checks = (("meteor_stats", _native.meteor_stats(hyp, ref, hst, rst), want),
                      ("meteor_align_spans",
                       _native.meteor_align_spans(hyp, ref, hst, rst, 1.0, 0.6, None, None,
                                                  0.8, None),
                       tm._align_spans(hyp, ref)),
                      ("lcs", _native.lcs(hyp, ref), trouge._lcs_length_py(hyp, ref)))
            for name, got, exp in checks:
                if got != exp:
                    raise SystemExit(f"{name} differs from the Python path: {got} != {exp} on "
                                     f"{hyp} / {ref}")
                counts[name] += 1
    log(f"[rehearsal c] native = Python path exactly: {json.dumps(counts)} calls over "
        f"{len(res)} phase 7 val captions and {len(pairs) - len(res)} rehearsal val captions")
    msvd = msvd_shaped(gts)
    sets = (("phase 7 captions, 2 references", gts, res),
            ("each clip's first reference as its caption", gts,
             {v: caps[:1] for v, caps in gts.items()}),
            (f"phase 7 captions, {MSVD_REFS} references (MSVD's count)", msvd, res))
    try:
        for name, g, r in sets:
            times, scores = {True: [], False: []}, {}
            for flag in (True, False, True, False):
                use_native(flag)
                t0 = time.perf_counter()
                scores[flag] = COCOEvalCap(g, r, spice_lexicon=lexicon).evaluate()
                times[flag].append(time.perf_counter() - t0)
            if scores[True] != scores[False]:
                raise SystemExit(f"COCOEvalCap ({name}) with the runtime {scores[True]} != "
                                 f"without {scores[False]}")
            log(f"[{card}] [rehearsal c] COCOEvalCap.evaluate over {len(r)} clips, {name}, with "
                f"SPICE (host): native runtime {[round(t, 4) for t in times[True]]} s, Python "
                f"paths {[round(t, 4) for t in times[False]]} s (speed-up "
                f"{min(times[False]) / min(times[True]):.2f}x); scores equal: "
                f"{json.dumps(scores[True])}")
    finally:
        use_native(old)


def rehearsal_phase(card, device, captions_csv):
    """10. (a) ``cli.rehearse_real_data`` at full width on the card with
    seeded stand-in weights in memory and synthetic MJPG clips (beam eval,
    W=5): no extraction failure, two clips' card features against the CPU's,
    the fit's beam eval against the plain beam decode, step seconds and the
    padded-frame share; (b) again from weight files (the same stand-ins'
    state dicts) on (a)'s first 16 clips with direct eval: the same
    features, the fit's direct eval against the plain greedy decode; (c)
    the native metrics runtime.  Returns the kernels' launches by path."""
    import shutil

    from mvc_tpu_torch.cli import rehearse_real_data as rr
    from mvc_tpu_torch.extract import FeatureExtractor
    from mvc_tpu_torch.extract.features import _bucket
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg

    try:
        import cv2  # noqa: F401  (the rehearsal writes and decodes MJPG clips)
    except ImportError as e:
        raise SystemExit(f"phase 10 needs OpenCV: {e}")
    shutil.rmtree(REHEARSAL_ROOT, ignore_errors=True)
    t10 = time.perf_counter()

    # (a) the stand-ins in memory, beam eval; the rehearsal takes the clips
    # it finds under its --out and writes their metadata
    from mvc_tpu_torch.extract.synthetic import make_clip_set

    t0 = time.perf_counter()
    root_a = os.path.join(REHEARSAL_ROOT, "a", "synthetic_msvd")
    make_clip_set(root_a, REHEARSAL_CLIPS, seconds=REHEARSAL_SECONDS, fps=REHEARSAL_FPS)
    clips_s = time.perf_counter() - t0
    bm.beam_decode.launches = 0
    run, tr_a = rehearse(["--out", os.path.join(REHEARSAL_ROOT, "a"), "--n_clips",
                          str(REHEARSAL_CLIPS), "--clip_seconds", str(REHEARSAL_SECONDS),
                          "--epochs", str(REHEARSAL_EPOCHS), "--device", "cuda"], {})
    beam_launches = bm.beam_decode.launches
    ext = run.summary["extracted"]
    names = sorted(os.listdir(os.path.join(root_a, "videos")))
    feats = clip_features(root_a, names)
    counts = [feats[n][0].shape[0] for n in names]
    padded = sum(_bucket(sum(counts[i:i + REHEARSAL_CHUNK]), REHEARSAL_BUCKETS)
                 for i in range(0, len(counts), REHEARSAL_CHUNK))
    sec = run.seconds
    log(f"[{card}] [rehearsal a] {len(names)} clips of {REHEARSAL_SECONDS} s (MJPG 320x240, "
        f"{REHEARSAL_FPS} fps, written in {clips_s:.3f} s; 16 kHz sidecars), Inception-v3 "
        f"299x299 + VGGish, AVCaptioningDual E=300 H=512 A=256, global reconstructors, B=8, "
        f"{REHEARSAL_EPOCHS} epochs, beam eval W=5: seconds convert {sec['convert']:.3f}, metadata "
        f"{sec['data']:.3f}, extract {sec['extract']:.3f} "
        f"(decode busy {ext['decode_s']}, encode busy {ext['encode_s']}), vocab "
        f"{sec['vocab']:.3f}, fit {sec['fit'] - tr_a.eval_s:.3f} (train + val loss), "
        f"score {tr_a.eval_s:.3f} (eval: beam decode + metrics, train and val); "
        f"frames {sum(counts)} padded to {padded} ({100 * (1 - sum(counts) / padded):.2f} % "
        f"padding); beam.cu launches {beam_launches}")
    if ext["done"] != REHEARSAL_CLIPS or beam_launches < 1:
        raise SystemExit(f"rehearsal a: extracted {ext}, beam.cu launches {beam_launches}")
    inception, vggish = rr.resolve_encoder_params(None)
    fe_cpu = FeatureExtractor(inception, vggish, fps=1, frame_buckets=(64,),
                              device=torch.device("cpu"))
    pick = names[:2]
    cpu = fe_cpu.extract_batch([os.path.join(root_a, "videos", n) for n in pick])
    err = max(rel_in_norm(feats[n][k], c[k]) for n, c in zip(pick, cpu) for k in (0, 1))
    log(f"[rehearsal a] card features of {pick} against the CPU's extraction with the same "
        f"converted weights: worst relative difference in norm {err:.3e}")
    if err > 1e-4:
        raise SystemExit("the rehearsal's card features disagree with the CPU's")
    rehearsal_agreement(tr_a, plain_beam, "rehearsal a val, beam.cu W=5")
    log(f"[phase 10 a] {time.perf_counter() - t10:.1f} s")

    # (b) weights from files, direct eval, on (a)'s first chunk of clips
    t0 = time.perf_counter()
    weights = os.path.join(REHEARSAL_ROOT, "weights")
    os.makedirs(weights)
    inc_sd, vgg_sd = rr.oracle_state_dicts()
    torch.save(inc_sd, os.path.join(weights, "inception_v3.pth"))
    torch.save(vgg_sd, os.path.join(weights, "vggish.pth"))
    root_b = os.path.join(REHEARSAL_ROOT, "b", "synthetic_msvd")
    shared = names[:REHEARSAL_FILE_CLIPS]
    for sub, ext_ in (("videos", None), ("audios", ".wav")):
        os.makedirs(os.path.join(root_b, sub))
        for n in shared:
            f = n if ext_ is None else os.path.splitext(n)[0] + ext_
            shutil.copy(os.path.join(root_a, sub, f), os.path.join(root_b, sub, f))
    dg.dual_greedy_decode.launches = 0
    run_b, tr_b = rehearse(["--out", os.path.join(REHEARSAL_ROOT, "b"), "--n_clips",
                      str(REHEARSAL_FILE_CLIPS), "--clip_seconds", str(REHEARSAL_SECONDS),
                      "--epochs", "1", "--eval_mode", "direct", "--device", "cuda"],
                     {"MVC_WEIGHTS_DIR": weights})
    g_launches = dg.dual_greedy_decode.launches
    feats_b = clip_features(root_b, shared)
    err_b = max(rel_in_norm(feats_b[n][k], feats[n][k]) for n in shared for k in (0, 1))
    same = all(np.array_equal(feats_b[n][k], feats[n][k]) for n in shared for k in (0, 1))
    log(f"[{card}] [rehearsal b] MVC_WEIGHTS_DIR (torch.save of the stand-ins' state dicts), "
        f"{len(shared)} clips, 1 epoch, direct eval: real_weights "
        f"{run_b.summary['real_weights']}, seconds "
        f"{json.dumps({k: round(v, 3) for k, v in run_b.seconds.items()})}; features against "
        f"(a)'s: worst relative difference in norm {err_b:.3e} (bit for bit: {same}); "
        f"dual_greedy.cu launches {g_launches}")
    if not run_b.summary["real_weights"] or run_b.summary["extracted"]["done"] != len(shared) \
            or err_b > 1e-6 or g_launches < 1:
        raise SystemExit(f"rehearsal b: {run_b.summary['extracted']}, features {err_b}, "
                         f"launches {g_launches}")
    rehearsal_agreement(tr_b, plain_dual_greedy, "rehearsal b val, dual_greedy.cu")
    log(f"[phase 10 b] {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    native_runtime(card, captions_csv, tr_a)
    log(f"[phase 10 c] {time.perf_counter() - t0:.1f} s; phase 10 "
        f"{time.perf_counter() - t10:.1f} s")
    shutil.rmtree(REHEARSAL_ROOT, ignore_errors=True)
    return {"beam": {"rehearsal fit beam eval": beam_launches},
            "dual_greedy": {"rehearsal weights-from-files fit direct eval": g_launches}}


# -- 11. the data-parallel mesh -----------------------------------------------

MESH_SHARDS = 4                  # (a), (e): dp=4 over [cuda:0] * 4
DP_ROWS = 299                    # (c): 2 ranks x 64 rows x 2 steps, then 22 + 21 rows
DP_BATCH = 64                    # (c): a rank's batch; the global batch is 128
DP_STEPS = 3


def sharded_predict(card, device, model, params, single, sparams):
    """11 (a): ``predict_tokens(mesh=)`` over dp=4 shards of the one card,
    each shard on its own stream: dual direct (``dual_greedy.cu``), dual
    beam W=5 (``beam.cu``), single direct (``greedy.cu``) at B=64 and at
    B=62 (padded to 64).  Tokens equal the unsharded kernel call's and the
    plain version's exactly; each call launches its kernel once a shard.
    Returns the launches of the sharded calls by path."""
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import greedy as gr
    from mvc_tpu_torch.parallel import make_mesh

    f32, cells = torch.float32, ("LSTM", "LSTM")
    decs = [params["v_decoder"], params["a_decoder"]]
    mesh = make_mesh(dp=MESH_SHARDS, devices=[device] * MESH_SHARDS)
    cases = (
        ("dual direct", model, params, "direct", dg.dual_greedy_decode,
         lambda v, a, m: dg.dual_greedy_decode_reference(decs, [v, a], m, L, f32, cells)),
        ("dual beam", model, params, "beam", bm.beam_decode,
         lambda v, a, m: bm.beam_decode_reference(decs, [v, a], m, L, W, 0.0, f32, cells)),
        ("single direct", single, sparams, "direct", gr.greedy_decode,
         lambda v, a, m: gr.greedy_decode_reference(sparams["decoder"], torch.cat([a, v], -1), m,
                                                    L, f32, "LSTM")),
    )
    launches = {}
    for b in (B, B - 2):
        vf, af, mask = decode_inputs(31, device, b=b)
        for label, m, p, mode, counter, plain in cases:
            kw = dict(max_caption_len=L, mode=mode, beam_width=W, feat_mask=mask)
            counter.launches = 0
            got = m.predict_tokens(p, af, vf, mesh=mesh, **kw)
            sync(device)
            n = counter.launches
            key = f"sharded predict {label} (dp={MESH_SHARDS}, B={b})"
            launches.setdefault(counter.__name__, {})[key] = n
            one = m.predict_tokens(p, af, vf, **kw)
            ref = plain(vf, af, mask)
            same = torch.equal(got, one) and torch.equal(got, ref)
            line = (f"[{card}] [mesh a] {label} B={b}: {n} launches over {MESH_SHARDS} shards; "
                    f"tokens {tuple(got.shape)} equal to the unsharded call and the plain "
                    f"version: {same}")
            if b == B:
                ms_mesh = cuda_ms(lambda: m.predict_tokens(p, af, vf, mesh=mesh, **kw), 5)
                ms_one = cuda_ms(lambda: m.predict_tokens(p, af, vf, **kw), 5)
                line += (f"; {MESH_SHARDS} streams x {b // MESH_SHARDS} rows {ms_mesh:.4f} ms, "
                         f"1 x {b} rows {ms_one:.4f} ms")
            log(line)
            if n != MESH_SHARDS or not same:
                raise SystemExit(f"sharded {label} at B={b}: {n} launches, tokens equal {same}")
    return launches


def cli_fit(data_root, workdir, device, extra):
    """``python -m mvc_tpu_torch.cli.train`` in-process from ``workdir`` for
    1 epoch of the dual model with global reconstructors, its trainer a
    ``smoke_trainer``; returns (history, trainer, seconds)."""
    from mvc_tpu_torch.cli import train as cli
    from mvc_tpu_torch.training import trainer as trainer_mod

    real, made = trainer_mod.Trainer, []

    def factory(checkpoint_name, **kw):
        made.append(smoke_trainer(checkpoint_name, base=real, **kw))
        return made[-1]

    cwd, data_root = os.getcwd(), os.path.abspath(data_root)
    os.makedirs(workdir, exist_ok=True)
    os.chdir(workdir)
    trainer_mod.Trainer = factory
    try:
        t0 = time.perf_counter()
        (history,) = cli.main(["--dataset", "MSVD", "--data_root", data_root,
                               "--epochs", "1", "--batch_size", str(TRAIN_B), "--reconstructor",
                               "global", "--device", device.type, *extra])
        sync(device)
        secs = time.perf_counter() - t0
    finally:
        trainer_mod.Trainer = real
        os.chdir(cwd)
    return history, made[0], secs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_world1(card, device, ds, vocab_path):
    """11 (b): ``cli.train --dp 1`` under an NCCL process group of one rank
    (its step all-reduces counts, gradients and metrics) against the same
    CLI with no process group: the history within 1e-6 relative, the eval
    captions against the plain decode (>= 99 %); the train step with and
    without the mesh and one all-reduce of the model's f32 gradients,
    CUDA events.  Returns ``dual_greedy.cu``'s launches in the meshed fit."""
    import torch.distributed as dist

    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.parallel import distributed, make_global_mesh
    from mvc_tpu_torch.training import optimizer as opt_lib
    from mvc_tpu_torch.training.trainer import Trainer

    root = os.path.dirname(ds)
    plain_h, _, plain_s = cli_fit(root, os.path.join(TRAIN_ROOT, "cli_plain"), device, [])
    distributed.initialize(f"localhost:{free_port()}", 1, 0, device=device, timeout_s=120)
    try:
        if dist.get_backend() != "nccl":
            raise SystemExit(f"world 1 on the card took {dist.get_backend()}, not nccl")
        dg.dual_greedy_decode.launches = 0
        mesh_h, tr, mesh_s = cli_fit(root, os.path.join(TRAIN_ROOT, "cli_dp1"), device,
                                     ["--dp", "1"])
        launches = dg.dual_greedy_decode.launches
        worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                    for key in ("train_loss", "val_loss")
                    for a, b in zip(mesh_h[key], plain_h[key]) for k in b)
        log(f"[{card}] [mesh b] cli.train --dp 1 over NCCL (world 1) {mesh_s:.2f} s against no "
            f"process group {plain_s:.2f} s; losses worst relative difference {worst:.3e} "
            f"(1e-6); val CIDEr {mesh_h['val_score'][0]['CIDEr']:.6f} / "
            f"{plain_h['val_score'][0]['CIDEr']:.6f}; dual_greedy launches {launches}")
        if worst > 1e-6 or launches < 1:
            raise SystemExit("the NCCL world-1 fit differs from the fit without a process group")
        model, params, vc = tr.evaluated["val"]
        cfg = TrainerConfig(batch_size=TRAIN_B)
        eval_agreement(tr, model, vc, tr._vocab, tr.generated["val", 1],
                       lambda b: plain_dual_greedy(params, b, cfg), "mesh b val", 0.99)

        batch = first_train_batch(ds, vocab_path)
        mesh = make_global_mesh()
        steps = {}
        for key, m in (("no mesh", None), ("NCCL mesh, world 1", mesh)):
            t = Trainer("unused.ckpt", log_dir=None, mesh=m)
            model, params = dual_model(device)
            step, _ = t._build_train_step(model, cfg)
            opt = opt_lib.make_optimizer(cfg, params)
            b = t._put_batch(batch, device)
            b.pop("_n_real")
            step(params, opt, b, None)
            steps[key] = (lambda s=step, p=params, o=opt, x=b: s(p, o, x, None))
        times = {k: [] for k in steps}
        for key in (*steps, *reversed(list(steps))):        # in turns: A B B A
            times[key].append(cuda_ms(steps[key], 5))
        times = {k: float(np.mean(v)) for k, v in times.items()}
        n_params = sum(x.numel() for x in opt_lib.tree_leaves(params))
        flat = torch.ones(n_params, device=device)
        dist.all_reduce(flat)
        ar = cuda_ms(lambda: dist.all_reduce(flat), 5)
        log(f"[{card}] [mesh b] train step B={TRAIN_B} T={b['visual'].shape[1]} "
            f"L={b['captions'].shape[0]}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f"; NCCL all-reduce (world 1) of {n_params} f32 gradients "
            f"({4 * n_params / 1e6:.1f} MB): {ar:.4f} ms")
    finally:
        distributed.shutdown()
    return launches


def union_batch(parts):
    """The ranks' host batches side by side, each padded to the longest
    caption and clip as ``Trainer._agree_lengths`` pads them: the batch one
    process takes for the ranks' step."""
    L_ = max(b["captions"].shape[0] for b in parts)
    T_ = max(b["feat_mask"].shape[1] for b in parts)
    out = {}
    for k in ("captions", "audio", "visual", "feat_mask", "sample_mask"):
        xs = []
        for b in parts:
            x = b[k]
            if k == "captions":
                x = np.pad(x, ((0, L_ - x.shape[0]), (0, 0)))
            elif k != "sample_mask":
                x = np.pad(x, [(0, 0), (0, T_ - x.shape[1])] + [(0, 0)] * (x.ndim - 2))
            xs.append(x)
        out[k] = np.concatenate(xs, axis=1 if k == "captions" else 0)
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, reps, device):
    """``cuda_ms`` on a card, host seconds elsewhere."""
    if device.type == "cuda":
        return cuda_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def gloo_rank(rank, world, ds, vocab_path, device, rows, batch, steps):
    """One of 11 (c)'s ranks, all on ``device`` over gloo: ``steps`` train
    steps of the dual model on the rank's strided shard of the first
    ``rows`` rows in batches of ``batch`` (the last one padded), then the
    rank's share of the val eval.  Rank 0 also takes each step as one
    process over the union batch and decodes the val set alone, and
    compares."""
    import hashlib

    import torch.distributed as dist

    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data.dataset import (
        VideoCaptioningDataset,
        video_dataset_to_video_captions_loader,
    )
    from mvc_tpu_torch.data.loader import DataLoader
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.parallel import make_global_mesh
    from mvc_tpu_torch.training import optimizer as opt_lib
    from mvc_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    mesh = make_global_mesh()
    data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    data.metadata = data.metadata[:rows]
    shards = [list(DataLoader(data, batch_size=batch, shuffle=False, prefetch=0,
                              process_index=r, process_count=world)) for r in range(world)]
    cfg = TrainerConfig(batch_size=batch)

    def start(m):
        model, params = dual_model(device)
        params["v_decoder"], params["a_decoder"] = spread_bias(
            [params["v_decoder"], params["a_decoder"]], seed=41)
        tr = Trainer("unused.ckpt", log_dir=None, mesh=m)
        step, _ = tr._build_train_step(model, cfg)
        return model, params, tr, step, GradCapture(opt_lib.make_optimizer(cfg, params), params)

    model, params, tr, step, opt = start(mesh)
    tr.set_vocab(data.vocab)
    if rank == 0:
        _, ref_params, ref_tr, ref_step, ref_opt = start(None)
    out = {"rank": rank, "loss_rel": [], "grad_worst": [], "param_worst": [], "same": [],
           "step_ms": []}
    for k in range(steps):
        b = tr._put_batch(shards[rank][k], device)
        b.pop("_n_real")
        b = tr._agree_lengths(b)
        sync(device)
        t0 = time.perf_counter()
        params, metrics = step(params, opt, b, None)
        sync(device)
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        h = hashlib.sha256()
        for _, x in named_leaves(params):
            h.update(x.detach().cpu().numpy().tobytes())
        digests = [None] * world
        dist.all_gather_object(digests, h.hexdigest())
        out["same"].append(len(set(digests)) == 1)
        if rank == 0:
            u = ref_tr._put_batch(union_batch([s[k] for s in shards]), device)
            u.pop("_n_real")
            ref_params, ref_m = ref_step(ref_params, ref_opt, u, None)
            out["loss_rel"].append(abs(float(metrics[0]) - float(ref_m[0]))
                                   / abs(float(ref_m[0])))
            g = {n: float((opt.grads[n] - ref_opt.grads[n]).norm()
                          / ref_opt.grads[n].norm().clamp_min(1e-30)) for n in ref_opt.grads}
            out["grad_worst"].append(max(g.values()))
            rp = dict(named_leaves(ref_params))
            out["param_worst"].append(max(
                float((x.detach() - rp[n].detach()).abs().max()
                      / rp[n].detach().abs().max().clamp_min(1e-30))
                for n, x in named_leaves(params)))
    out["rows"] = [[int(s[k]["sample_mask"].sum()) for s in shards] for k in range(steps)]
    n_params = sum(x.numel() for _, x in named_leaves(params))
    flat = torch.ones(n_params, device=device)
    dist.all_reduce(flat)
    out["allreduce_ms"] = device_ms(lambda: dist.all_reduce(flat), 3, device)
    out["n_params"] = n_params

    val = VideoCaptioningDataset(ds, "MSVD", "val", vocab_path=vocab_path, verbose=False)
    vc = video_dataset_to_video_captions_loader(val, batch_size=batch, process_index=rank,
                                                process_count=world)
    dg.dual_greedy_decode.launches = 0
    _, _, caps = tr.eval(model, params, vc, "val", 1, get_scores=False)
    sync(device)
    out["launches"] = dg.dual_greedy_decode.launches
    out["n_captions"] = len(caps)
    if rank == 0:
        alone = Trainer("unused.ckpt", log_dir=None)
        alone.set_vocab(data.vocab)
        _, _, want = alone.eval(model, params,
                                video_dataset_to_video_captions_loader(val, batch_size=batch),
                                "val", 1, get_scores=False)
        out["eval_equal"] = sum(caps.get(v) == c for v, c in want.items())
        out["eval_total"] = len(want)
        out["eval_order"] = list(caps) == list(want)
    return out


def gloo_world2(card, ds, vocab_path, device):
    """11 (c): two spawned ranks on the one card over gloo (NCCL takes one
    card a rank): each step's loss within 1e-4 relative, and every gradient
    leaf within 1e-4 relative in norm, of one process's step over the union
    batch; the ranks' parameters equal after each step; the ranks' evals
    through ``dual_greedy.cu`` gathered equal to one process's eval.
    Returns the ranks' eval launches."""
    from mvc_tpu_torch.parallel.smoke import spawn_ranks

    t0 = time.perf_counter()
    r0, r1 = spawn_ranks(gloo_rank, 2, os.path.join(TRAIN_ROOT, "gloo_rdzv"),
                         args=(ds, vocab_path, str(device), DP_ROWS, DP_BATCH, DP_STEPS),
                         backend="gloo", device=str(device), timeout_s=300)
    secs = time.perf_counter() - t0
    log(f"[{card}] [mesh c] 2 ranks over gloo on {device}, {secs:.2f} s with start-up; rows a "
        f"rank a step {r0['rows']}; loss vs one process {[f'{x:.3e}' for x in r0['loss_rel']]} "
        f"(1e-4); worst gradient leaf {[f'{x:.3e}' for x in r0['grad_worst']]} (1e-4); worst "
        f"parameter leaf after the step {[f'{x:.3e}' for x in r0['param_worst']]}; ranks' "
        f"parameters equal {r0['same']}; step ms rank 0 {[round(x, 2) for x in r0['step_ms']]} "
        f"rank 1 {[round(x, 2) for x in r1['step_ms']]}; gloo all-reduce of {r0['n_params']} f32 "
        f"on {device} ({4 * r0['n_params'] / 1e6:.1f} MB): {r0['allreduce_ms']:.4f} / "
        f"{r1['allreduce_ms']:.4f} ms; eval launches {r0['launches']} + {r1['launches']}, "
        f"gathered captions equal to one process's {r0['eval_equal']}/{r0['eval_total']} "
        f"(order {r0['eval_order']})")
    if not (max(r0["loss_rel"]) <= 1e-4 and max(r0["grad_worst"]) <= 1e-4
            and all(r0["same"]) and all(r1["same"]) and r0["launches"] >= 1
            and r1["launches"] >= 1 and r0["eval_equal"] == r0["eval_total"]
            and r0["eval_order"] and r0["n_captions"] == r0["eval_total"]):
        raise SystemExit("the gloo world-2 step or eval disagrees with one process")
    return r0["launches"] + r1["launches"]


def mesh_extract(card, device):
    """11 (d): ``FeatureExtractor(mesh=)`` over [cuda:0] * 2 on phase 8's
    first 8 clips and weights: features within 1e-5 relative in norm of the
    meshless extractor's."""
    from mvc_tpu_torch.extract import FeatureExtractor
    from mvc_tpu_torch.models import inception_v3 as iv3
    from mvc_tpu_torch.models import vggish as vg
    from mvc_tpu_torch.parallel import make_mesh

    iv3_params = iv3.init_inception_v3(torch.Generator().manual_seed(20))
    vg_params = vg.init_vggish(torch.Generator().manual_seed(21))
    vg_params["pca"] = seeded_pca(22)
    clips = [decoded_clip(i) for i in range(EXTRACT_BATCH)]
    fe = FeatureExtractor(iv3_params, vg_params, device=device)
    fm = FeatureExtractor(iv3_params, vg_params, device=device,
                          mesh=make_mesh(dp=2, devices=[device] * 2))
    runs = []
    for x in (fe, fm):
        x._encode_decoded(clips)
        sync(device)
        t0 = time.perf_counter()
        feats = x._encode_decoded(clips)
        sync(device)
        runs.append((feats, time.perf_counter() - t0))
    (want, s1), (got, s2) = runs
    v_err = max(rel_in_norm(g[0], w[0]) for g, w in zip(got, want))
    a_err = max(rel_in_norm(g[1], w[1]) for g, w in zip(got, want))
    log(f"[{card}] [mesh d] FeatureExtractor over 2 shards of {device}, {len(clips)} clips: visual "
        f"{v_err:.3e}, audio {a_err:.3e} relative in norm of one device's (1e-5); encode "
        f"{s2:.3f} s against {s1:.3f} s")
    if v_err > 1e-5 or a_err > 1e-5:
        raise SystemExit("the meshed extractor's features disagree")


def mesh_phase(card, device, ds, vocab_path, vocab, model, params, single, sparams):
    """11. the data-parallel mesh at full width: (a) ``sharded_predict``,
    (b) ``nccl_world1``, (c) ``gloo_world2``, (d) ``mesh_extract``, (e)
    ``CaptionService(mesh=)`` dual direct behind HTTP, 16 requests, the
    first 8 captions against the plain version.  Returns launches by path
    for each kernel."""
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    launches = sharded_predict(card, device, model, params, single, sparams)
    dual = launches["dual_greedy_decode"]
    dual["train fit cli.train --dp 1, NCCL world 1, eval"] = nccl_world1(card, device, ds,
                                                                          vocab_path)
    dual["per-rank eval, 2 gloo ranks on one card"] = gloo_world2(card, ds, vocab_path, device)
    mesh_extract(card, device)
    mesh = make_mesh(dp=MESH_SHARDS, devices=[device] * MESH_SHARDS)
    dg.dual_greedy_decode.launches = 0
    requests, captions = serve(model, params, vocab, device, "direct", "mesh ", mesh=mesh,
                               n_singles=16, n_batches=0)
    dual[f"serve dual direct over dp={MESH_SHARDS}"] = n = dg.dual_greedy_decode.launches
    log(f"[mesh e] dual_greedy launches during meshed serving: {n}")
    if n < MESH_SHARDS:
        raise SystemExit("the meshed service never launched the kernel once a shard")
    plain = [params["v_decoder"], params["a_decoder"]]
    check_served(lambda f, m: dg.dual_greedy_decode_reference(plain, f, m, L), requests,
                 captions, vocab, device, "mesh direct")
    log(f"[{card}] phase 11: {time.perf_counter() - t0:.1f} s")
    return launches


TPSP_SHAPE = (1, 2, 2)           # 12: (dp, tp, sp), four ranks on the one card
TPSP_ROWS = 299                  # (a): 128 + 128 + 43 rows, the last batch padded
TPSP_FIT_ROWS = 256              # (b): the fit's train rows (two steps); val: all 128


class WholeGradCapture(GradCapture):
    """``GradCapture`` on a tp mesh: each leaf's summed gradient with its
    vocab slices gathered (every rank takes part)."""

    def __init__(self, opt, params, mesh):
        from mvc_tpu_torch.parallel.mesh import param_specs
        from mvc_tpu_torch.training.optimizer import tree_leaves

        super().__init__(opt, params)
        self.mesh, self.specs = mesh, tree_leaves(param_specs(params))

    def step(self):
        from mvc_tpu_torch.parallel.mesh import gather_leaf

        self.grads = {k: gather_leaf(self.mesh, spec, p.grad, V).detach().cpu().clone()
                      for (k, p), spec in zip(self.named, self.specs)}
        self.opt.step()


def leaf_digests(params, mesh):
    """(digest of the replicated leaves, digest of this rank's vocab slices)."""
    import hashlib

    from mvc_tpu_torch.parallel.mesh import sharded_leaves

    hs = [hashlib.sha256(), hashlib.sha256()]
    for (_, x), sharded in zip(named_leaves(params), sharded_leaves(mesh, params)):
        hs[sharded].update(x.detach().cpu().numpy().tobytes())
    return hs[0].hexdigest(), hs[1].hexdigest()


def grads_against(opt, ref_opt):
    """The worst leaf's gradient error, relative in norm."""
    return max(float((opt.grads[n] - ref_opt.grads[n]).norm()
                     / ref_opt.grads[n].norm().clamp_min(1e-30)) for n in ref_opt.grads)


def tpsp_rank(rank, world, ds, vocab_path, device, t_spawn):
    """One of 12's ranks, all on ``device`` over gloo, of a (1, 2, 2) mesh:
    (a) the train steps, (b) the fit, (c) the local-reconstructor step, (d)
    the timings.  Rank 0 also takes each step as one process over the same
    batch and decodes the val set alone, and compares."""
    import torch.distributed as dist

    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data.dataset import (
        VideoCaptioningDataset,
        collate_av_batch,
        video_dataset_to_video_captions_loader,
    )
    from mvc_tpu_torch.data.loader import DataLoader
    from mvc_tpu_torch.models import AVCaptioningDual
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.parallel import make_global_mesh, shard_params
    from mvc_tpu_torch.parallel import mesh as mesh_lib
    from mvc_tpu_torch.training import optimizer as opt_lib
    from mvc_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    mesh = make_global_mesh(*TPSP_SHAPE)
    out = {"rank": rank, "coords": mesh.coords(), "started": time.time() - t_spawn}
    shard, n_shards = mesh.data_shard()
    data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    data.metadata = data.metadata[:TPSP_ROWS]
    batches = list(DataLoader(data, batch_size=TRAIN_B, shuffle=False, prefetch=0,
                              process_index=shard, process_count=n_shards))
    cfg = TrainerConfig(batch_size=TRAIN_B)

    def start(m, rec="global"):
        model = AVCaptioningDual(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type=rec,
                                 device=device)
        params = model.init(torch.Generator().manual_seed(0))
        params["v_decoder"], params["a_decoder"] = spread_bias(
            [params["v_decoder"], params["a_decoder"]], seed=41)
        tr = Trainer("unused.ckpt", log_dir=None, mesh=m)
        step, _ = tr._build_train_step(model, cfg)
        if m is None:
            return model, params, tr, step, GradCapture(opt_lib.make_optimizer(cfg, params),
                                                        params)
        params = shard_params(m, params)
        return model, params, tr, step, WholeGradCapture(opt_lib.make_optimizer(cfg, params),
                                                         params, m)

    def compare(label, steps_of, rec="global"):
        """Each step on the mesh, rank 0 also alone; the errors and digests."""
        model, params, tr, step, opt = start(mesh, rec)
        tr.set_vocab(data.vocab)
        if rank == 0:
            _, ref_params, ref_tr, ref_step, ref_opt = start(None, rec)
        res = {"loss_rel": [], "grad_worst": [], "same": [], "step_ms": []}
        for host in steps_of:
            b = tr._put_batch(host, device)
            b.pop("_n_real")
            b = tr._agree_lengths(b)
            sync(device)
            t0 = time.perf_counter()
            params, metrics = step(params, opt, b, None)
            sync(device)
            res["step_ms"].append(1e3 * (time.perf_counter() - t0))
            digests = [None] * world
            dist.all_gather_object(digests, (mesh.coords(), leaf_digests(params, mesh)))
            same_rep = len({d[1][0] for d in digests}) == 1
            same_slices = all(d[1][1] == e[1][1] for d in digests for e in digests
                              if d[0][1] == e[0][1])
            res["same"].append(same_rep and same_slices)
            if rank == 0:
                u = ref_tr._put_batch(host, device)
                u.pop("_n_real")
                ref_params, ref_m = ref_step(ref_params, ref_opt, u, None)
                res["loss_rel"].append(abs(float(metrics[0]) - float(ref_m[0]))
                                       / abs(float(ref_m[0])))
                res["grad_worst"].append(grads_against(opt, ref_opt))
        out[label] = res
        return model, params, opt

    # (a) three steps, the last batch padded
    out["rows"] = [int(b["sample_mask"].sum()) for b in batches]
    out["T"] = [int(b["feat_mask"].shape[1]) for b in batches]
    _, params, opt = compare("a", batches)
    sharded = mesh_lib.sharded_leaves(mesh, params)
    rep = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.leaves]
    buckets = {"replicated, all 4 ranks": ([g for g, s in zip(rep, sharded) if not s],
                                           mesh.group),
               "vocab slices, dp x sp ranks": ([g for g, s in zip(rep, sharded) if s],
                                               mesh.groups["dp_sp"])}
    out["buckets"] = {}
    for name, (grads, group) in buckets.items():
        mesh_lib.sum_over_ranks(grads, group)
        ms = device_ms(lambda: mesh_lib.sum_over_ranks(grads, group), 3, device)
        out["buckets"][name] = (sum(g.numel() for g in grads), ms)
    del params, opt, rep, buckets

    # (c) local reconstructors, one step
    compare("c", batches[:1], rec="local")

    # (d) the step at bench.py's T=28, L=8 (median of 5 after 2)
    rng = np.random.default_rng(11)
    items = [{"audio": rng.standard_normal((28, 128), dtype=np.float32),
              "visual": rng.standard_normal((28, 2048), dtype=np.float32),
              "caption": np.concatenate([[1], rng.integers(4, V, 6), [2]]).astype(np.int32)}
             for _ in range(TRAIN_B)]
    host28 = collate_av_batch(items, frame_buckets=(28,), caption_buckets=(8,))

    def step28_ms(m):
        """The median step of 5 after 2 on ``m`` (None: one process)."""
        model, params, tr, step, opt = start(m)
        b = tr._put_batch(host28, device)
        b.pop("_n_real")
        times = []
        for k in range(7):
            sync(device)
            t0 = time.perf_counter()
            params, _m = step(params, opt, b, None)
            sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times[2:]))

    out["step28_ms"] = step28_ms(mesh)
    if rank == 0:       # the baseline in the same run; the others wait in (b)'s first collective
        out["step28_alone_ms"] = step28_ms(None)

    # (b) a 1-epoch fit on the mesh, its evals through dual_greedy.cu
    fit_data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    fit_data.metadata = fit_data.metadata[:TPSP_FIT_ROWS]
    val = VideoCaptioningDataset(ds, "MSVD", "val", vocab_path=vocab_path, verbose=False)
    loaders = [DataLoader(d, batch_size=TRAIN_B, shuffle=False, prefetch=0,
                          process_index=shard, process_count=n_shards) for d in (fit_data, val)]
    model = AVCaptioningDual(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type="global",
                             device=device)
    tr = smoke_trainer(os.path.join(TRAIN_ROOT, "tpsp", f"rank{rank}", "fit.ckpt"), mesh=mesh)
    cfg1 = TrainerConfig(batch_size=TRAIN_B, epochs=1)
    init = model.init(torch.Generator().manual_seed(0))
    # spread biases keep the decode clear of near-ties: each rank's eval
    # batch holds a quarter of the rows, so its keys/P matmuls have another
    # shape than one process's
    init["v_decoder"], init["a_decoder"] = spread_bias([init["v_decoder"], init["a_decoder"]],
                                                       seed=41)
    dg.dual_greedy_decode.launches = 0
    t0 = time.perf_counter()
    params, _, hist = tr.fit(model, init, loaders[0], loaders[1], loaders[1], cfg1)
    sync(device)
    out["fit_s"] = time.perf_counter() - t0
    out["launches"] = dg.dual_greedy_decode.launches
    out["history"] = hist
    caps = tr.generated["val", 1]
    out["n_captions"] = len(caps)
    if rank == 0:
        vc = video_dataset_to_video_captions_loader(val, batch_size=TRAIN_B)
        alone = Trainer("unused.ckpt", log_dir=None)
        alone.set_vocab(data.vocab)
        alone._transfer_dtype = tr._transfer_dtype       # the fit's wire: bf16 features
        _, _, want = alone.eval(model, params, vc, "val", 1, get_scores=False,
                                max_caption_len=cfg1.eval_max_caption_len)
        out["eval_equal"] = sum(caps.get(v) == c for v, c in want.items())
        out["eval_total"] = len(want)
        out["eval_order"] = list(caps) == list(want)
        out["eval_differ"] = [(v, caps.get(v), c) for v, c in want.items()
                              if caps.get(v) != c][:3]
        eval_agreement(tr, model, vc, data.vocab, caps, lambda bb: plain_dual_greedy(
            params, bb, cfg1), "tp/sp fit val", 0.99)
    return out


def tpsp_phase(card, ds, vocab_path, device):
    """12: four spawned ranks on the one card over gloo, a (dp=1, tp=2,
    sp=2) mesh (NCCL takes one card a rank).  Returns the ranks' eval
    launches of ``dual_greedy.cu`` in the fit."""
    from mvc_tpu_torch.parallel.smoke import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(tpsp_rank, int(np.prod(TPSP_SHAPE)),
                        os.path.join(TRAIN_ROOT, "tpsp_rdzv"),
                        args=(ds, vocab_path, str(device), time.time()), backend="gloo",
                        device=str(device), timeout_s=400)
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    a, c = r0["a"], r0["c"]
    h = r0["history"]
    log(f"[{card}] [tp/sp a] 4 ranks (dp, tp, sp) {[r['coords'] for r in ranks]} over gloo on "
        f"{device}: {secs:.2f} s with start-up; rows a step {r0['rows']} (T {r0['T']}); loss vs "
        f"one process {[f'{x:.3e}' for x in a['loss_rel']]} (1e-4); worst gradient leaf, "
        f"gathered, relative in norm {[f'{x:.3e}' for x in a['grad_worst']]} (1e-4); "
        f"replicated parameters equal and slices consistent "
        f"{[all(r['a']['same'][k] for r in ranks) for k in range(len(a['same']))]}; step ms "
        + "; ".join(f"rank {r['rank']} {[round(x, 2) for x in r['a']['step_ms']]}"
                    for r in ranks))
    log(f"[{card}] [tp/sp c] local reconstructors, one step: loss {c['loss_rel'][0]:.3e}, worst "
        f"gradient leaf {c['grad_worst'][0]:.3e} relative (1e-4); same "
        f"{all(r['c']['same'][0] for r in ranks)}")
    log(f"[{card}] [tp/sp d] step B={TRAIN_B} T=28 L=8 V={V} f32 over the 4 ranks (median of 5): "
        + ", ".join(f"rank {r['rank']} {r['step28_ms']:.2f} ms" for r in ranks)
        + f"; one process alone on the same batch {r0['step28_alone_ms']:.2f} ms "
        f"({max(r['step28_ms'] for r in ranks) / r0['step28_alone_ms']:.2f}x)"
        + "; gloo all-reduce of each gradient bucket on the card (median of 3, rank 0): "
        + ", ".join(f"{k}: {n} f32 ({4 * n / 1e6:.1f} MB) {ms:.4f} ms"
                    for k, (n, ms) in r0["buckets"].items())
        + f"; ranks up and meshed {max(r['started'] for r in ranks):.2f} s after the spawn")
    log(f"[{card}] [tp/sp b] 1-epoch fit over {TPSP_FIT_ROWS} train rows: train "
        f"{h['train_loss'][0]} val {h['val_loss'][0]} CIDEr {h['val_score'][0]['CIDEr']:.6f}; "
        f"{r0['fit_s']:.2f} s; dual_greedy launches by rank "
        f"{[r['launches'] for r in ranks]}; gathered val captions equal to one process's "
        f"decode {r0['eval_equal']}/{r0['eval_total']} (order {r0['eval_order']}); differing "
        f"(video, gathered, one process): {r0['eval_differ']}")
    ok = (max(a["loss_rel"]) <= 1e-4 and max(a["grad_worst"]) <= 1e-4
          and c["loss_rel"][0] <= 1e-4 and c["grad_worst"][0] <= 1e-4
          and all(all(r["a"]["same"]) and all(r["c"]["same"]) for r in ranks)
          and all(r["launches"] >= 1 for r in ranks)
          and all(r["history"] == h for r in ranks)
          and r0["eval_equal"] == r0["eval_total"] == r0["n_captions"] and r0["eval_order"]
          and np.isfinite(h["train_loss"][0]["total"]))
    if not ok:
        raise SystemExit("the tp/sp steps, fit or eval disagree with one process")
    return sum(r["launches"] for r in ranks)



# ------------------------------------------------------------------ 13. the transformer on tp/sp
class GradOnly:
    """Stands in for the optimizer of a reference step: keeps each leaf's
    gradient on the host and updates nothing."""

    def __init__(self, params):
        self.named = named_leaves(params)
        self.leaves = [p.requires_grad_(True) for _, p in self.named]

    def step(self):
        self.grads = {k: p.grad.detach().cpu().clone() for k, p in self.named}


def rel_norm(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def grads_three_way(mesh, one, f64):
    """13 (a)'s gradient check, leaf by leaf: each of the mesh's gathered
    gradients within 1e-4 relative in norm of one process's from the same
    parameters and batch, except the attention key biases, whose gradient
    is zero (softmax shift invariance): within 1e-7 of the largest leaf's
    norm on both.  A float64 step is the exact reference: the leaves that
    float32 does not resolve (one process further than 1e-4 from float64: a
    small sum of large cancelling terms, phase 9 (b)) are counted, and must
    be within 1e-3 of float64 on the mesh and alone.  Returns the numbers
    and whether all hold."""
    top = max(float(g.double().norm()) for g in f64.values())
    zero = [k for k in f64 if k.endswith("/k/b")]
    err = {k: rel_norm(mesh[k], one[k]) for k in f64 if k not in zero}
    unresolved = {k: (rel_norm(mesh[k], f64[k]), r) for k in err
                  if (r := rel_norm(one[k], f64[k])) > 1e-4}
    z = max(float(g[k].double().norm()) / top for g in (mesh, one) for k in zero)
    worst = max(err, key=err.get)
    worst_u = max(unresolved, key=lambda k: max(unresolved[k])) if unresolved else None
    ok = (err[worst] <= 1e-4 and z <= 1e-7
          and all(max(v) <= 1e-3 for v in unresolved.values()))
    return {"leaves": len(err), "worst": (worst, err[worst]),
            "median": float(np.median(list(err.values()))), "unresolved": len(unresolved),
            "worst_unresolved": (worst_u, *unresolved[worst_u]) if worst_u else None,
            "zero": (len(zero), z), "ok": ok}


def transformer_tpsp_rank(rank, world, ds, vocab_path, device, t_spawn):
    """One of 13's ranks, all on ``device`` over gloo, of a (1, 2, 2) mesh,
    ``TransformerCaptioning`` at full width: (a) the train steps, (c) the
    step at T=28, L=8, its collectives and the gradient buckets, (b) the
    fit.  Rank 0 also takes each of (a)'s steps alone from the mesh's
    parameters, in float32 and float64, and decodes the val set alone."""
    import torch.distributed as dist

    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.data.dataset import (
        VideoCaptioningDataset,
        collate_av_batch,
        video_dataset_to_video_captions_loader,
    )
    from mvc_tpu_torch.data.loader import DataLoader
    from mvc_tpu_torch.parallel import gather_params, make_global_mesh, shard_params
    from mvc_tpu_torch.parallel import mesh as mesh_lib
    from mvc_tpu_torch.training import optimizer as opt_lib
    from mvc_tpu_torch.training.trainer import Trainer, _tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    mesh = make_global_mesh(*TPSP_SHAPE)
    out = {"rank": rank, "coords": mesh.coords(), "started": time.time() - t_spawn}
    shard, n_shards = mesh.data_shard()
    data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    data.metadata = data.metadata[:TPSP_ROWS]
    batches = list(DataLoader(data, batch_size=TRAIN_B, shuffle=False, prefetch=0,
                              process_index=shard, process_count=n_shards))
    cfg = TrainerConfig(batch_size=TRAIN_B)
    model, init = transformer_model(device)
    init = spread_generator(init)
    out["n_params"] = sum(x.numel() for _, x in named_leaves(init))

    def clone(tree):
        return _tree_map(lambda t: t.detach().clone(), tree)

    def start(m, capture=True):
        """(trainer, step, params, optimizer) on ``m`` (None: one process)."""
        tr = Trainer("unused.ckpt", log_dir=None, mesh=m)
        step, _ = tr._build_train_step(model, cfg)
        params = clone(init) if m is None else shard_params(m, clone(init))
        opt = opt_lib.make_optimizer(cfg, params)
        if capture:
            opt = WholeGradCapture(opt, params, m)
        return tr, step, params, opt

    # (a) three steps, the last batch padded; rank 0 takes each alone from
    # the parameters the mesh starts it from
    out["rows"] = [int(b["sample_mask"].sum()) for b in batches]
    out["T"] = [int(b["feat_mask"].shape[1]) for b in batches]
    tr, step, params, opt = start(mesh)
    if rank == 0:
        alone = Trainer("unused.ckpt", log_dir=None)
        one_step, _ = alone._build_train_step(model, cfg)
        model64, _ = float64_transformer(device)
        f64_step, _ = alone._build_train_step(model64, cfg)
    res = {"loss_rel": [], "checks": [], "same": [], "step_ms": []}
    for host in batches:
        b = tr._put_batch(host, device)
        b.pop("_n_real")
        b = tr._agree_lengths(b)
        whole = gather_params(mesh, params, V)          # a collective: every rank takes part
        before = clone(whole) if rank == 0 else None
        del whole
        sync(device)
        t0 = time.perf_counter()
        params, metrics = step(params, opt, b, None)
        sync(device)
        res["step_ms"].append(1e3 * (time.perf_counter() - t0))
        digests = [None] * world
        dist.all_gather_object(digests, (mesh.coords(), leaf_digests(params, mesh)))
        res["same"].append(len({d[1][0] for d in digests}) == 1
                           and all(d[1][1] == e[1][1] for d in digests for e in digests
                                   if d[0][1] == e[0][1]))
        if rank == 0:
            u = alone._put_batch(host, device)
            u.pop("_n_real")
            u64 = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
                   for k, v in u.items()}
            refs = {}
            for key, st, p, ub in (("f32", one_step, clone(before), u),
                                   ("f64", f64_step, to_device(before, device, torch.float64),
                                    u64)):
                cap = GradOnly(p)
                _, m = st(p, cap, ub, None)
                refs[key] = (float(m[0]), cap.grads)
            res["loss_rel"].append(abs(float(metrics[0]) - refs["f32"][0]) / abs(refs["f32"][0]))
            res["checks"].append(grads_three_way(opt.grads, refs["f32"][1], refs["f64"][1]))
            del before, refs
    out["a"] = res
    sharded = mesh_lib.sharded_leaves(mesh, params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.leaves]
    buckets = {"replicated, all 4 ranks": ([g for g, s in zip(grads, sharded) if not s],
                                           mesh.group),
               "embedding slice, dp x sp ranks": ([g for g, s in zip(grads, sharded) if s],
                                                  mesh.groups["dp_sp"])}
    out["buckets"] = {}
    for name, (gs, group) in buckets.items():
        mesh_lib.sum_over_ranks(gs, group)
        ms = device_ms(lambda: mesh_lib.sum_over_ranks(gs, group), 3, device)
        out["buckets"][name] = (sum(g.numel() for g in gs), ms)
    del params, opt, grads, buckets
    if rank == 0:
        del model64

    # (c) the step at bench.py's T=28, L=8 (median of 5 after 2), then one
    # more on the mesh with every all-reduce counted
    rng = np.random.default_rng(11)
    items = [{"audio": rng.standard_normal((28, 128), dtype=np.float32),
              "visual": rng.standard_normal((28, 2048), dtype=np.float32),
              "caption": np.concatenate([[1], rng.integers(4, V, 6), [2]]).astype(np.int32)}
             for _ in range(TRAIN_B)]
    host28 = collate_av_batch(items, frame_buckets=(28,), caption_buckets=(8,))

    def step28(m):
        tr_, step_, params_, opt_ = start(m, capture=False)
        b = tr_._put_batch(host28, device)
        b.pop("_n_real")
        times = []
        for _ in range(7):
            sync(device)
            t0 = time.perf_counter()
            params_, _m = step_(params_, opt_, b, None)
            sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times[2:])), (step_, params_, opt_, b)

    out["step28_ms"], (step_, params_, opt_, b28) = step28(mesh)
    calls = []
    real = dist.all_reduce

    def counted(tensor, *a, **k):
        calls.append(tensor.numel() * tensor.element_size())
        return real(tensor, *a, **k)

    dist.all_reduce = counted
    try:
        step_(params_, opt_, b28, None)
    finally:
        dist.all_reduce = real
    out["collectives"] = (len(calls), sum(calls), sorted(calls, reverse=True)[:6])
    del params_, opt_, b28
    if rank == 0:       # the baseline in the same run; the others wait in (b)'s first collective
        out["step28_alone_ms"] = step28(None)[0]

    # (b) a 1-epoch fit on the mesh, its evals over the gathered parameters
    fit_data = VideoCaptioningDataset(ds, "MSVD", "train", vocab_path=vocab_path, verbose=False)
    fit_data.metadata = fit_data.metadata[:TPSP_FIT_ROWS]
    val = VideoCaptioningDataset(ds, "MSVD", "val", vocab_path=vocab_path, verbose=False)
    loaders = [DataLoader(d, batch_size=TRAIN_B, shuffle=False, prefetch=0,
                          process_index=shard, process_count=n_shards) for d in (fit_data, val)]
    tr = smoke_trainer(os.path.join(TRAIN_ROOT, "tpsp_transformer", f"rank{rank}", "fit.ckpt"),
                       mesh=mesh)
    cfg1 = TrainerConfig(batch_size=TRAIN_B, epochs=1)
    t0 = time.perf_counter()
    params, _, hist = tr.fit(model, init, loaders[0], loaders[1], loaders[1], cfg1)
    sync(device)
    out["fit_s"] = time.perf_counter() - t0
    out["eval_s"] = tr.eval_s
    out["history"] = hist
    caps = tr.generated["val", 1]
    out["n_captions"] = len(caps)
    if rank == 0:
        vc = video_dataset_to_video_captions_loader(val, batch_size=TRAIN_B)
        alone = Trainer("unused.ckpt", log_dir=None)
        alone.set_vocab(data.vocab)
        alone._transfer_dtype = tr._transfer_dtype       # the fit's wire: bf16 features
        _, _, want = alone.eval(model, params, vc, "val", 1, get_scores=False,
                                max_caption_len=cfg1.eval_max_caption_len)
        equal = total = 0
        for v, c in want.items():
            k, p = caps[v][0].split() + ["<EOS>"], c[0].split() + ["<EOS>"]
            equal += sum(x == y for x, y in zip(k, p))
            total += max(len(k), len(p))
        out["tokens"] = (equal, total)
        out["eval_equal"] = sum(caps.get(v) == c for v, c in want.items())
        out["eval_total"] = len(want)
        out["eval_order"] = list(caps) == list(want)
        out["eval_differ"] = [(v, caps.get(v), c) for v, c in want.items()
                              if caps.get(v) != c][:3]
    return out


def transformer_tpsp_phase(card, ds, vocab_path, device):
    """13: four spawned ranks on the one card over gloo, a (dp=1, tp=2,
    sp=2) mesh, ``TransformerCaptioning`` at full width."""
    from mvc_tpu_torch.parallel.smoke import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(transformer_tpsp_rank, int(np.prod(TPSP_SHAPE)),
                        os.path.join(TRAIN_ROOT, "tpsp_transformer_rdzv"),
                        args=(ds, vocab_path, str(device), time.time()), backend="gloo",
                        device=str(device), timeout_s=400)
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    a = r0["a"]
    h = r0["history"]
    checks = "; ".join(
        f"step {i + 1}: {c['leaves']} leaves against one process, worst {c['worst'][1]:.3e} "
        f"({c['worst'][0]}), median {c['median']:.3e} (1e-4); {c['unresolved']} leaves float32 "
        f"does not resolve (one process over 1e-4 from float64), worst (mesh vs float64, one "
        f"process vs float64) {c['worst_unresolved']} (1e-3); {c['zero'][0]} key biases / "
        f"largest leaf {c['zero'][1]:.3e} (1e-7)" for i, c in enumerate(a["checks"]))
    log(f"[{card}] [transformer tp/sp a] 4 ranks (dp, tp, sp) {[r['coords'] for r in ranks]} "
        f"over gloo on {device}, TransformerCaptioning at full width, {r0['n_params']} params, "
        f"V={V}: {secs:.2f} s with start-up; rows a step {r0['rows']} (T {r0['T']}); loss vs one "
        f"process from the same parameters {[f'{x:.3e}' for x in a['loss_rel']]} (1e-4); "
        f"gradients, gathered, relative in norm: {checks}; replicated parameters equal and "
        f"slices consistent {[all(r['a']['same'][k] for r in ranks) for k in range(len(a['same']))]}"
        "; step ms " + "; ".join(f"rank {r['rank']} {[round(x, 2) for x in r['a']['step_ms']]}"
                                  for r in ranks))
    n, nbytes, top = r0["collectives"]
    log(f"[{card}] [transformer tp/sp c] step B={TRAIN_B} T=28 L=8 V={V} f32 over the 4 ranks "
        f"(median of 5): " + ", ".join(f"rank {r['rank']} {r['step28_ms']:.2f} ms" for r in ranks)
        + f"; one process alone on the same batch {r0['step28_alone_ms']:.2f} ms "
        f"({max(r['step28_ms'] for r in ranks) / r0['step28_alone_ms']:.2f}x); all-reduces in one "
        f"step on rank 0 {n}, {nbytes / 1e6:.1f} MB (largest {[round(x / 1e6, 2) for x in top]} "
        "MB); gloo all-reduce of each gradient bucket on the card (median of 3, rank 0): "
        + ", ".join(f"{k}: {m} f32 ({4 * m / 1e6:.1f} MB) {ms:.4f} ms"
                    for k, (m, ms) in r0["buckets"].items())
        + f"; ranks up and meshed {max(r['started'] for r in ranks):.2f} s after the spawn")
    eq, tot = r0["tokens"]
    log(f"[{card}] [transformer tp/sp b] 1-epoch fit over {TPSP_FIT_ROWS} train rows: train "
        f"{h['train_loss'][0]} val {h['val_loss'][0]} CIDEr {h['val_score'][0]['CIDEr']:.6f}; "
        f"{r0['fit_s']:.2f} s ({r0['eval_s']:.2f} s of evals on rank 0); gathered val captions "
        f"against one process's decode of the same params: tokens, EOS included, {eq}/{tot} "
        f"({100 * eq / tot:.2f} %), captions {r0['eval_equal']}/{r0['eval_total']} (order "
        f"{r0['eval_order']}); differing (video, gathered, one process): {r0['eval_differ']}")
    ok = (max(a["loss_rel"]) <= 1e-4 and all(c["ok"] for c in a["checks"])
          and all(all(r["a"]["same"]) for r in ranks)
          and all(r["history"] == h for r in ranks)
          and r0["eval_total"] == r0["n_captions"] and r0["eval_order"] and eq >= 0.99 * tot
          and np.isfinite(h["train_loss"][0]["total"]))
    if not ok:
        raise SystemExit("the transformer's tp/sp steps, fit or eval disagree with one process")


# -- 14. the benchmark entry points ------------------------------------------

SERVING_ARGS = ["--concurrency", "1", "64", "--n", "256", "--n-open", "256", "--http-n", "5"]


def bench_phase(card, device):
    """14: ``cli.bench`` with all five metrics at its full shapes and counts,
    then ``cli.bench_serving`` in direct and beam mode at reduced counts,
    in this process; each kernel's count is set to 0 just before each run
    and read just after.  Every line (printed by the CLIs themselves) must
    name the card, every metric be correct with no share above 100 %, every
    kernel launch once a timed call, and every serving request attempted
    complete.  Returns {kernel: {path: launches}}."""
    from mvc_tpu_torch.cli import bench, bench_serving
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import greedy as gr

    name = torch.cuda.get_device_name(device)
    wrappers = {"dual_greedy": dg.dual_greedy_decode, "beam": bm.beam_decode,
                "greedy": gr.greedy_decode}
    kernel_of = {"beam_captions_per_sec": "beam", "greedy_captions_per_sec": "greedy",
                 "bulk_greedy_captions_per_sec": "dual_greedy"}
    launches = {k: {} for k in wrappers}
    t0 = time.perf_counter()
    for w in wrappers.values():
        w.launches = 0
    line = bench.main([])
    for k, w in wrappers.items():
        launches[k]["cli.bench"] = w.launches
    bench_s = time.perf_counter() - t0
    metrics = line["metrics"]
    bad = [m for m, e in metrics.items()
           if not e["correct"] or max(e["mfu_pct"], e["hbm_pct"]) > 100.0]
    bad += [m for m, k in kernel_of.items()
            if metrics[m]["kernel_launches"] != metrics[m]["calls"]]
    log(f"[{card}] [bench] cli.bench in {bench_s:.1f} s: " + "; ".join(
        f"{m} {e['value']:.2f} {e['unit']} ({e['calls']} calls, correct {e['correct']}, MFU "
        f"{e['mfu_pct']:.4f} %, HBM {e['hbm_pct']:.4f} % of the triad, {e['bound']})"
        for m, e in metrics.items()) + f"; kernel launches {launches}")
    if (line["device"]["name"] != name or line["device"]["platform"] != "gpu"
            or set(metrics) != {n for n, _unit, _base in bench.METRICS.values()} or bad):
        raise SystemExit(f"cli.bench: a metric is missing, wrong or not on the card: {bad}")
    for mode, kernel in (("direct", "dual_greedy"), ("beam", "beam")):
        t0 = time.perf_counter()
        wrappers[kernel].launches = 0
        lines = bench_serving.main(["--mode", mode] + SERVING_ARGS)
        launches[kernel][f"cli.bench_serving --mode {mode}"] = wrappers[kernel].launches
        phases = [e["phase"] for e in lines]
        log(f"[{card}] [bench_serving {mode}] {len(lines)} lines {phases} in "
            f"{time.perf_counter() - t0:.1f} s; {kernel} launches "
            f"{wrappers[kernel].launches}")
        if (any(e["device"]["name"] != name or e["completed"] != e["attempted"] or e["failed"]
                for e in lines) or wrappers[kernel].launches < 1
                or phases.count("closed_loop") != 3 or phases.count("open_loop") != 3):
            raise SystemExit(f"cli.bench_serving --mode {mode}: a line is wrong or a request "
                             "failed")
    return launches


# -- 15. any clip length, beams up to 16 -----------------------------------

LONG_B = 8                          # clips of the long-clip cases
WIDE_B = 16                         # clips of the wide-beam cases


def long_wide_phase(card, device, model, decoders, s_dec, vocab):
    """Phase 15: the kernels at clips longer than they keep in shared
    memory and at beams of 9 to 16, each exactly its plain version in
    float32 (tokens, and a beam's per-clip step counts), with its time
    beside the plain version's and its bound; the serving and bench shapes
    on the layouts and tiles they had; the service and ``AVCaptioningDual.predict`` on a
    clip the service refused before.  Returns ({kernel: {path: launches}},
    {kernel: largest max_abs_err})."""
    from mvc_tpu_torch.models.captioning import captions_from_tokens
    from mvc_tpu_torch.ops import _decode_common as dc
    from mvc_tpu_torch.ops import beam as bm
    from mvc_tpu_torch.ops import dual_greedy as dg
    from mvc_tpu_torch.ops import greedy as gr

    t_start = time.perf_counter()
    f32, cells = torch.float32, ("LSTM", "LSTM")
    errs = {"dual_greedy": 0.0, "greedy": 0.0, "beam": 0.0}

    def timed(label, kernel_fn, plain_fn, work):
        ms, plain = cuda_ms(kernel_fn, 3), cuda_ms(plain_fn, 3)
        whole, kern, by = bounds(*work)
        log(f"[{card}] {label}: wrapper {ms:.4f} ms, plain {plain:.4f} ms, bound {whole:.4f} ms "
            f"whole call / {kern:.4f} ms kernel ({by})")

    # (a) the serving and bench shapes keep their layouts: the greedy
    # kernels' score rows in shared memory (the layout of the Python
    # replica), the beam's 15-row tile with no workspace
    for b in (B, 1024):
        vf, af, mask = decode_inputs(30, device, b=b)
        args, _tok, keep = dg.prepare_kernel_call(decoders, [vf, af], mask, L, f32, cells)
        lay = stream_layout(card, "dual_greedy", dg._library(), args, keep[0])
        if lay["att_global"]:
            raise SystemExit(f"dual_greedy at B={b} T={T} left its shared-memory layout")
        del keep
    vf, af, mask = decode_inputs(30, device)
    args, _tok, keep = gr.prepare_kernel_call(s_dec, torch.cat([af, vf], -1), mask, L, f32)
    if stream_layout(card, "greedy", gr._library(), args, keep[0])["att_global"]:
        raise SystemExit(f"greedy at B={B} T={T} left its shared-memory layout")
    del keep
    blib = bm._library()
    for dec_, feats_ in ((decoders, [vf, af]), ([s_dec], [torch.cat([af, vf], -1)])):
        args, _tok, _st, keep = bm.prepare_kernel_call(dec_, feats_, mask, L, W, 0.0, f32,
                                                       cells[:len(dec_)])
        tile, ws = blib.beam_tile_rows(ctypes.byref(args)), blib.beam_workspace_floats(
            ctypes.byref(args), 0)
        log(f"beam {len(dec_)} decoder(s) at B={B} T={T} W={W}: tile R={tile}, workspace {ws}")
        if tile != 15 or ws:
            raise SystemExit("the serving shape no longer takes the 15-row tile in shared memory")
        del keep

    # (b) long clips: dual_greedy.cu at T=1024 and T=4096, greedy.cu at
    # T=4096, beam.cu (dual, W=5) at T=2048, all past their shared-memory fit
    for t in (1024, 4096):
        vf, af, mask = decode_inputs(40 + t, device, b=LONG_B, t=t)
        args, _tok, keep = dg.prepare_kernel_call(decoders, [vf, af], mask, L, f32, cells)
        if not stream_layout(card, "dual_greedy", dg._library(), args, keep[0])["att_global"]:
            raise SystemExit(f"dual_greedy at T={t} should keep its score rows in the workspace")
        del keep
        errs["dual_greedy"] = max(errs["dual_greedy"], check_dual_greedy(
            dg, decoders, [vf, af], mask, cells, f32, exact=True))
        timed(f"dual_greedy_decode f32 B={LONG_B} T={t}",
              lambda: dg.dual_greedy_decode(decoders, [vf, af], mask, L, f32, cells),
              lambda: dg.dual_greedy_decode_reference(decoders, [vf, af], mask, L, f32, cells),
              decode_work(decoders, (2048, 128), LONG_B * (L - 1), LONG_B * L, 4, b=LONG_B, t=t))
    sf = torch.cat([af, vf], -1)
    args, _tok, keep = gr.prepare_kernel_call(s_dec, sf, mask, L, f32)
    if not stream_layout(card, "greedy", gr._library(), args, keep[0])["att_global"]:
        raise SystemExit("greedy at T=4096 should keep its score rows in the workspace")
    del keep
    errs["greedy"] = check_single_greedy(gr, s_dec, sf, mask, "LSTM", f32, True, "T=4096 ")
    timed(f"greedy_decode f32 AVCaptioning F=2176 B={LONG_B} T=4096",
          lambda: gr.greedy_decode(s_dec, sf, mask, L, f32),
          lambda: gr.greedy_decode_reference(s_dec, sf, mask, L, f32),
          decode_work([s_dec], (2176,), LONG_B * (L - 1), LONG_B * L, 4, b=LONG_B, t=4096))
    del vf, af, sf
    vf, af, mask = decode_inputs(42, device, b=LONG_B, t=2048)
    args, _tok, _st, keep = bm.prepare_kernel_call(decoders, [vf, af], mask, L, W, 0.0, f32, cells)
    tile, ws = blib.beam_tile_rows(ctypes.byref(args)), blib.beam_workspace_floats(
        ctypes.byref(args), 0)
    log(f"beam dual at T=2048 W={W}: tile R={tile}, workspace {ws} floats")
    if tile != 8 or not ws:
        raise SystemExit("beam at T=2048 should take the 8-row tile with its score rows in the "
                         "workspace")
    del keep
    err, _tok, steps = check_beam(bm, decoders, [vf, af], mask, cells, f32, 0.0, True, device,
                                  "T=2048 ", tiles=(0,))
    errs["beam"] = max(errs["beam"], err)
    timed(f"beam_decode dual f32 B={LONG_B} T=2048 W={W}",
          lambda: bm.beam_decode(decoders, [vf, af], mask, L, W, 0.0, f32, cells),
          lambda: bm.beam_decode_reference(decoders, [vf, af], mask, L, W, 0.0, f32, cells),
          decode_work(decoders, (2048, 128), int(steps.sum()) * W, LONG_B * (L + 2), 4,
                      b=LONG_B, t=2048))
    del vf, af

    # (c) beams of 9 to 16 on the 16-row tile; 17 is refused
    if bm.max_width() != 16 or model.max_beam_width() != 16:
        raise SystemExit(f"the beam kernel's widest beam is {bm.max_width()}, not 16")
    vf, af, mask = decode_inputs(43, device, b=WIDE_B)
    for w in (9, 12, 16):
        args, _tok, _st, keep = bm.prepare_kernel_call(decoders, [vf, af], mask, L, w, 0.0, f32,
                                                       cells)
        tile = blib.beam_tile_rows(ctypes.byref(args))
        del keep
        if tile != 16:
            raise SystemExit(f"W={w} takes the {tile}-row tile, not the 16-row one")
        err, _tok, steps = check_beam(bm, decoders, [vf, af], mask, cells, f32, 0.7, True, device,
                                      f"W={w} ", w=w, tiles=(0,))
        errs["beam"] = max(errs["beam"], err)
        timed(f"beam_decode dual f32 B={WIDE_B} T={T} W={w} (16-row tile)",
              lambda w=w: bm.beam_decode(decoders, [vf, af], mask, L, w, 0.7, f32, cells),
              lambda w=w: bm.beam_decode_reference(decoders, [vf, af], mask, L, w, 0.7, f32,
                                                   cells),
              decode_work(decoders, (2048, 128), int(steps.sum()) * w, WIDE_B * (L + 2), 4,
                          b=WIDE_B, t=T))
    try:
        bm.beam_decode(decoders, [vf, af], mask, L, 17, 0.0, f32, cells)
        raise SystemExit("a beam of 17 launched")
    except ValueError as e:
        log(f"W=17 raises ValueError: {e}")

    # (d) the main path: the service answers a clip it refused before;
    # AVCaptioningDual.predict gives the captions of the plain tokens
    plain_params = {"v_decoder": decoders[0], "a_decoder": decoders[1],
                    "v_reconstructor": None, "a_reconstructor": None}
    launches = {"dual_greedy": {}, "beam": {}, "greedy": {}}
    launches["dual_greedy"]["serve dual direct, a T=1024 clip with 8 short ones"] = \
        serve_long_clip(model, plain_params, vocab, device,
                        lambda f, m: dg.dual_greedy_decode_reference(decoders, f, m, L), 1024)
    vf, af, mask = decode_inputs(44, device, b=LONG_B, t=1024)
    for mode, wrapper, plain in (
            ("direct", dg.dual_greedy_decode,
             lambda: dg.dual_greedy_decode_reference(decoders, [vf, af], mask, L)),
            ("beam", bm.beam_decode,
             lambda: bm.beam_decode_reference(decoders, [vf, af], mask, L, W))):
        wrapper.launches = 0
        got = model.predict(plain_params, vocab, af, vf, max_caption_len=L, mode=mode,
                            beam_width=W, feat_mask=mask)
        n = wrapper.launches
        want = captions_from_tokens(vocab, plain().cpu())
        log(f"AVCaptioningDual.predict {mode} B={LONG_B} T=1024: {sum(map(str.__eq__, got, want))}"
            f"/{LONG_B} captions equal the plain tokens'; launches {n}; {got[0]!r}")
        if got != want or n != 1:
            raise SystemExit(f"AVCaptioningDual.predict ({mode}) is not the plain decode")
        name = "dual_greedy" if mode == "direct" else "beam"
        launches[name][f"AVCaptioningDual.predict {mode}, T=1024"] = n
    if model.max_frames(plain_params, B, "direct") is not None:
        raise SystemExit("AVCaptioningDual.max_frames reports a limit")
    log(f"[{card}] phase 15: {time.perf_counter() - t_start:.1f} s")
    return launches, errs


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
    t_big = largest_t(lambda a: blib.beam_smem_bytes(a, 15),
                      lambda a: blib.beam_workspace_floats(a, 15), xa, dc.MAX_SMEM_BYTES) + 1
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
    g_pre, g_kern, g_bytes = decode_work(decoders, (2048, 128), B * (L - 1), B * L, 4, b=B, t=T)
    g_bound, g_bound_k, g_by = bounds(g_pre, g_kern, g_bytes)
    log(f"[{card}] dual_greedy_decode (wrapper: keys/P matmuls + kernel) f32 B={B} T={T} "
        f"L={L} V={V}: {g_ms:.4f} ms")
    log(f"[{card}] dual_greedy kernel launch alone: {g_launch:.4f} ms")
    log(f"[{card}] dual_greedy plain PyTorch version: {g_plain:.4f} ms")
    log(f"[{card}] dual_greedy bound (whole call, operations {(g_pre + g_kern) / 1e9:.2f} GFLOP "
        f"at 67 TFLOP/s f32; bytes {g_bytes / 1e6:.1f} MB at 3.35 TB/s): {g_bound:.4f} ms")
    log(f"[{card}] dual_greedy bound (kernel alone, {g_kern / 1e9:.2f} GFLOP): {g_bound_k:.4f} ms")
    lib = dg._library()
    stream_layout(card, "dual_greedy", lib, g_args, g_keep[0])
    g_repack = cuda_ms(lambda: [dc.stream_operands(p, V) for p in g_keep[0]], 5)
    log(f"[{card}] dual_greedy weight repack inside the wrapper (f32): {g_repack:.4f} ms")
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
    b_pre, b_kern, b_bytes = decode_work(decoders, (2048, 128), row_steps, B * (L + 2), 4, b=B, t=T)
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
        pre, kern, nbytes = decode_work([dec_], (2176,), B * (L - 1), B * L, nbytes_w, b=B, t=T)
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
            stream_layout(card, "greedy", gr._library(), s_args, s_keep[0])
            repack = cuda_ms(lambda: [dc.stream_operands(p, V) for p in s_keep[0]], 5)
            log(f"[{card}] greedy weight repack inside the wrapper (f32): {repack:.4f} ms")
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
    pre, kern, nbytes = decode_work([s_dec], (2176,), row_steps, B * (L + 2), 4, b=B, t=T)
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
    captions_csv = os.path.join(TRAIN_ROOT, "results", "captions_cached_last_val_direct.csv")
    extract_phase(card, device, captions_csv)

    # -- 9. the transformer, int8 weights and the router, on the same tree
    p9 = phase9(card, device, ds, vocab_path, vocab, model,
                {"v_decoder": decoders[0], "a_decoder": decoders[1]},
                {"decoder": s_dec, "reconstructor": None})

    # -- 10. the real-data rehearsal, weights from files, the native runtime
    p10 = rehearsal_phase(card, device, captions_csv)

    # -- 11. the data-parallel mesh, on the same tree and phase 3's trees
    p11 = mesh_phase(card, device, ds, vocab_path, vocab, model,
                     {"v_decoder": decoders[0], "a_decoder": decoders[1],
                      "v_reconstructor": None, "a_reconstructor": None},
                     single, {"decoder": s_dec, "reconstructor": None})

    # -- 12. tensor and sequence parallelism, on the same tree
    t0 = time.perf_counter()
    p11["dual_greedy_decode"]["tp/sp fit eval, 4 gloo ranks (1, 2, 2) on one card"] = \
        tpsp_phase(card, ds, vocab_path, device)
    log(f"[{card}] phase 12: {time.perf_counter() - t0:.1f} s")

    # -- 13. the transformer on the tp/sp mesh, on the same tree
    t0 = time.perf_counter()
    transformer_tpsp_phase(card, ds, vocab_path, device)
    log(f"[{card}] phase 13: {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)

    # -- 14. the benchmark entry points
    t0 = time.perf_counter()
    p14 = bench_phase(card, device)
    log(f"[{card}] phase 14: {time.perf_counter() - t0:.1f} s")

    # -- 15. any clip length, beams up to 16
    p15, p15_err = long_wide_phase(card, device, model, decoders, s_dec, vocab)

    record = {"kernels": [
        {"name": "dual_greedy_decode", "route": "cuda",
         "source": "mvc_tpu_torch/csrc/dual_greedy.cu",
         "replaces": "mvc_tpu/ops/pallas_dual_greedy.py:314",
         "launches": g_launches, "max_abs_err": max(g_err, p15_err["dual_greedy"]),
         "ms": g_ms, "plain_ms": g_plain, "bound_ms": g_bound, "bound_by": g_by,
         "library_ms": None,
         "launches_by_path": {"serve dual direct": g_launches,
                              "train fit direct eval": fit_launches["dual_greedy"],
                              **{k.split(" ", 1)[1]: v for k, v in rest_launches.items()
                                 if k.startswith("dual_greedy ")},
                              **p9["dual_greedy"], **p10["dual_greedy"],
                              **p11["dual_greedy_decode"], **p14["dual_greedy"],
                              **p15["dual_greedy"]}},
        {"name": "beam_decode", "route": "cuda",
         "source": "mvc_tpu_torch/csrc/beam.cu",
         "replaces": "mvc_tpu/ops/pallas_beam.py:578",
         "launches": b_launches, "max_abs_err": max(b_err, p15_err["beam"]),
         "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by,
         "library_ms": None,
         "launches_by_path": {"serve dual beam": b_launches, "serve single beam": sb_launches,
                              "train fit beam eval": fit_launches["beam"],
                              **{k.split(" ", 1)[1]: v for k, v in rest_launches.items()
                                 if k.startswith("beam ")},
                              **p9["beam"], **p10["beam"], **p11["beam_decode"],
                              **p14["beam"], **p15["beam"]}},
        {"name": "greedy_decode", "route": "cuda",
         "source": "mvc_tpu_torch/csrc/greedy.cu",
         "replaces": "mvc_tpu/ops/pallas_decode.py:366",
         "launches": s_launches, "max_abs_err": max(s_err, p15_err["greedy"]),
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None,
         "launches_by_path": {"serve single direct": s_launches,
                              **{k.split(" ", 1)[1]: v for k, v in rest_launches.items()
                                 if k.startswith("greedy ")},
                              **p9["greedy"], **p11["greedy_decode"], **p14["greedy"]}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
