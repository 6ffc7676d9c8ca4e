"""The work a call does, counted from its shapes, and the card's roofline.

One yardstick for ``chip_smoke.py`` and ``cli/bench.py``: FLOPs and bytes
of a decode call (``decode_work``), a train step (``train_step_work``), a
transformer decode (``transformer_work``) and any function of a parameter
tree that ``FlopCounterMode`` can trace on shape-only tensors
(``model_flops``); the H100's published peaks; a measured HBM triad; and
``roofline``, which turns a counted call and a measured rate into shares
of those peaks.  Counts are exact products of the shapes (2 FLOPs a
multiply-add); bytes are each input read once and each output written
once, whatever a kernel reads again.

The peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W
power limit (dense, no sparsity).  A card set below it runs slower under
load; the bench prints the limit beside every share.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

PEAK_F32_FLOPS = 67e12       # H100 SXM float32, outside the tensor cores
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense
PEAK_BYTES = 3.35e12         # H100 SXM HBM3

TRIAD_MIB, TRIAD_PASSES = 256, 40
# a share at or above this is what bounds the call; below it on both
# rooflines the call waits on launches, the host or dependent steps
BOUND_SHARE_PCT = 40.0


def decode_work(decoders, feat_dims, row_steps, out_elems, weight_bytes, *, b, t):
    """(FLOPs outside the kernel, FLOPs of the kernel, bytes) of one decode
    call over ``b`` clips of ``t`` frames: the keys/P matmuls outside the
    kernel, then per (row, step) in ``row_steps`` the query, energies,
    context or P-sum, gates and vocab projection of each decoder.  Bytes:
    each input read once (the mask counted at 4 bytes a frame, the features
    in float32, the weights at ``weight_bytes``), the ``out_elems`` int32
    tokens written once."""
    from mvc_tpu_torch.ops._decode_common import _use_factored

    flops_pre = flops_kernel = 0
    nbytes = b * t * 4 + out_elems * 4
    for p, F in zip(decoders, feat_dims):
        V, E = p["embedding"]["table"].shape
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


def train_step_work(model, params, b, t, l, feature_bytes=2):
    """(FLOPs, bytes, parameter count) of one fused-loss train step of
    ``AVCaptioningDual`` at [B, T] features and L caption tokens.  FLOPs:
    3x the forward's products (each GEMM's two backward GEMMs), the forward
    being per decoder the attention keys, the embedding rows of wi, per
    step the query, energies, context (or P-sum), context rows of wi (or
    P's build once) and wh, and the vocab projection; per global
    reconstructor the input GEMM and the recurrence.  Bytes: the batch (the
    features at ``feature_bytes``), then the params, grads and three moment
    trees read once and params and moments written once."""
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
    nbytes = 4 * n * (5 + 4) + b * t * (2048 + 128) * feature_bytes + b * t + l * b * 4
    return 3 * fwd, nbytes, n


def tree_bytes(tree):
    from mvc_tpu_torch.training.optimizer import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def transformer_work(model, params, b, t, row_steps, max_len=30):
    """(FLOPs, bytes) of one transformer decode call.  FLOPs: both encoders
    over the b*t frames (input projection, per layer the four projections,
    attention over the t frames, the FFN), the cross K/V projected once,
    then for each (rows, position) in ``row_steps`` both decoder stacks'
    layer step (self q/k/v/o and cross q/o projections, the FFN, attention
    over the positions decoded so far and the t frames) and the two
    generator heads.  Bytes: every parameter, the features and the mask
    read once, the ``max_len + 2`` tokens of each clip written once."""
    cfg = model.cfg
    D, dff, nl, bt = cfg.d_model, cfg.d_ff, cfg.num_layers, b * t
    enc = 2 * bt * (cfg.visual_dim + cfg.audio_dim) * D
    enc += 2 * nl * (2 * bt * (4 * D * D + 2 * D * dff) + 4 * b * t * t * D)
    cross = 2 * nl * 2 * 2 * bt * D * D
    steps = 0
    for rows, pos in row_steps:
        layer = 2 * (6 * D * D + 2 * D * dff) + 4 * ((pos + 1) + t) * D
        steps += rows * (2 * nl * layer + 2 * 2 * D * cfg.vocab_size)
    nbytes = (tree_bytes(params) + bt * (cfg.visual_dim + cfg.audio_dim) * 4 + bt
              + b * (max_len + 2) * 4)
    return enc + cross + steps, nbytes


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


def extract_work(fe, frames, examples, samples, clips):
    """(FLOPs, bytes) of one clip of a ``FeatureExtractor`` sweep over
    ``clips`` clips of ``frames`` frames, ``examples`` VGGish examples and
    ``samples`` waveform samples each: the visual CNN's FLOPs a frame and
    VGGish's an example (``model_flops``; log-mel and the CNNs' elementwise
    work not counted); bytes: the decoded uint8 frames and float32
    waveform read once, the float32 features written once, and the
    clip's share of the weights, which the sweep reads once."""
    from mvc_tpu_torch.models import vggish as vg

    h, w = fe.frame_size
    frame_flops = model_flops(fe._visual_features, fe.inception_params, (3, h, w))
    example_flops = model_flops(lambda p, x: vg.vggish_embeddings(p, x[:, 0]), fe.vggish_params,
                                (1, 96, 64))
    dim = 1000 if fe.visual_model == "resnet" else 2048
    weights = tree_bytes(fe.inception_params) + tree_bytes(fe.vggish_params)
    nbytes = (frames * h * w * 3 + samples * 4 + (frames * dim + examples * 128) * 4
              + weights / clips)
    return frames * frame_flops + examples * example_flops, nbytes


def measure_triad(device) -> float:
    """The card's measured HBM rate in GB/s: ``y = a*x + b`` over a 256 MiB
    float32 array, 40 passes between two buffers (one kernel a pass),
    timed with CUDA events after one untimed round; bytes are one read and
    one write a pass.  The denominator of every ``hbm_pct``."""
    x = torch.ones(TRIAD_MIB * 2**20 // 4, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    b = torch.tensor(0.5, dtype=torch.float32, device=device)

    def run():
        src, dst = x, y
        for _ in range(TRIAD_PASSES):
            torch.add(b, src, alpha=1.0001, out=dst)
            src, dst = dst, src

    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3
    return 2 * x.nbytes * TRIAD_PASSES / seconds / 1e9


def roofline(entry: dict, flops, nbytes, calls_per_sec: Optional[float], peak_flops,
             peak_bytes: Optional[float] = None) -> dict:
    """Fill a bench metric's roofline fields from the FLOPs and bytes one
    call needs and the calls per second measured (None: a run off the
    card, which gets the counts and no rate or share).

    ``gflops_per_call`` and ``gbytes_per_call``; ``achieved_tflops`` and
    ``mfu_pct`` against ``peak_flops`` (989e12 for bf16 products, 67e12 for
    float32 ones); ``hbm_gbps`` (``hbm_gbps_est`` is bench.py's name for
    the same rate; the port counts bytes from shapes and never clamps, so
    the two are equal), ``hbm_pct`` against ``peak_bytes`` (the measured
    triad; the data sheet's 3.35 TB/s when None) and
    ``hbm_pct_datasheet``; ``bound``: ``"tensor core"`` (bf16 peak) or
    ``"CUDA cores"`` (float32 peak) or ``"HBM"``, whichever share is larger
    when it reaches 40 %, else ``"latency"``.  A share above 100 % means
    the count or the time is wrong: it raises ValueError naming the
    bound."""
    entry["gflops_per_call"] = flops / 1e9
    entry["gbytes_per_call"] = nbytes / 1e9
    keys = ("achieved_tflops", "mfu_pct", "hbm_gbps", "hbm_gbps_est", "hbm_pct",
            "hbm_pct_datasheet", "bound")
    if calls_per_sec is None:
        entry.update(dict.fromkeys(keys))
        return entry
    peak_b = peak_bytes or PEAK_BYTES
    tflops = flops * calls_per_sec / 1e12
    gbps = nbytes * calls_per_sec / 1e9
    ops_name = "tensor core" if peak_flops == PEAK_BF16_FLOPS else "CUDA cores"
    shares = {ops_name: 100.0 * tflops * 1e12 / peak_flops, "HBM": 100.0 * gbps * 1e9 / peak_b}
    for name, share in shares.items():
        if share > 100.0:
            raise ValueError(f"{name} share {share:.2f} % is above 100 % of the peak: the "
                             "counted work or the measured time is wrong")
    top = max(shares, key=shares.get)
    entry.update(zip(keys, (tflops, shares[ops_name], gbps, gbps, shares["HBM"],
                            100.0 * gbps * 1e9 / PEAK_BYTES,
                            top if shares[top] >= BOUND_SHARE_PCT else "latency")))
    return entry


def trace_busy(path):
    """What a ``torch.profiler`` Chrome trace shows of the card: (span ms
    of every event, busy ms of kernels, copies and memsets summed, their
    count, {name[:60]: ms} by kernel).  Busy is None when the trace holds
    no device event (the profiler saw no CUDA activity)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)) / 1e3
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in device:
        by_name[e["name"][:60]] = by_name.get(e["name"][:60], 0.0) + e["dur"] / 1e3
    busy = sum(e["dur"] for e in device) / 1e3 if device else None
    return span, busy, len(device), by_name


def profiled_busy_pct(run, device, out_dir) -> Optional[float]:
    """The card's busy share (%) over ``run()`` (a short steady window that
    ends in a synchronize) from a ``torch.profiler`` trace of CPU and CUDA
    activity written to ``out_dir``: busy kernel, copy and memset time over
    the trace's span.  None when the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    path = os.path.join(out_dir, "bench.trace.json")
    prof.export_chrome_trace(path)
    span, busy, _n, _by = trace_busy(path)
    return None if busy is None else 100.0 * busy / span
