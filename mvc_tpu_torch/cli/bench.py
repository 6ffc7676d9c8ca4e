"""Headline benchmarks of the port on the card, with roofline accounting.

    python -m mvc_tpu_torch.cli.bench [--only beam,greedy,bulk,train,extract]
        [--seed 0] [--device cuda|cpu]

The port of the root ``bench.py``: its five metrics at its shapes (V=4000,
B=64, T=16, max_len=30, W=5; dual greedy at B=1024; the dual train step
at B=128, T=28, L=8 with global reconstructors; extraction of 16 synthetic
10-s clips at fps=1, 8 to a chunk) and in its precision (bf16 decode
weights through each kernel's bf16 instantiation; bf16 compute over float32
master parameters for the train step, whose batch already sits on the
card).  After each metric it prints one JSON line on stdout holding every
metric so far, with bench.py's keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``metrics``) plus ``device`` (the card's name, power limit
and count) and ``roofline`` (the peaks); prose goes to stderr.  Each
metric holds ``value``, ``unit``, ``vs_baseline``, ``calls`` and
``seconds`` (the timed calls: decode calls, train steps, clips of one
sweep), ``correct``, the launches of its kernel in the timed calls, and
``utils/roofline.roofline``'s fields; train adds
``device_busy_pct_measured``, extract ``host_device_split``.

Where it departs from bench.py:

- FLOPs and bytes are counted from the shapes (``utils/roofline.py``), not
  read from XLA's cost analysis, which undercounts scan bodies.  The
  decoders get spread vocab biases and an EOS bias below every other
  (``spread_bias``), so no pick is a near-tie and every beam runs all its
  steps; the beam count takes the steps the plain version ran.
- It times the route the card takes, the kernels, with the host clock
  around calls that end in a synchronize; the plain version is never a
  metric, and there is no best-of-two.
- ``correct``: a decode metric's kernel gives its plain version's tokens
  exactly in float32 on the same inputs and weights (their arithmetic is
  the same there), and in bf16 the timed call's tokens agree with the
  plain version's on >= 99.8 % (direct decodes).  The beam's bf16
  agreement is reported with the plain version's agreement with itself
  when the features are nudged by one float32 ulp
  (``tokens_equal_plain_nudged``): with every beam running 31 steps the
  plain version stays below 99.8 % against itself, so that rule does not
  hold the beam.  The first 5 train losses within 2 % of float32 compute
  from the same parameters, and finite; the first clip's features within
  1e-4 (relative in norm) of the CPU's encode of the same decode.
- No stale line, re-exec or skipped metric: a metric that raises, is not
  correct, or shows a share above 100 % makes the run exit 1 after the
  lines of the others.  ``BENCH_BASELINE.json`` is only read.
- Without a card it exits non-zero and prints nothing on stdout.
  ``--device cpu`` runs the plain versions at the sizes this module sets
  (the tests shrink them) and labels the line ``"platform": "cpu"``: counts
  of FLOPs and bytes, no rate or share of the card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BASELINE = os.path.join(REPO, "BENCH_BASELINE.json")

VOCAB, B, T, WIDTH, MAX_LEN = 4000, 64, 16, 5, 30     # bench.py:54-58
BULK_B = 1024                                         # bench.py:264
TRAIN_B, TRAIN_T, TRAIN_L = 128, 28, 8                # bench.py:60
N_CLIPS, CLIP_SECONDS, CHUNK = 16, 10.0, 8            # bench.py:61, :417
ITERS = {"beam": 50, "greedy": 50, "bulk": 30, "train": 100}   # bench.py's timed calls
CHECK_STEPS = 5          # train steps held against float32 compute
PROFILE_STEPS = 5        # train steps in the profiler's window
AGREE = 0.998            # bf16 kernel tokens equal to the plain version's
LOSS_RTOL = 0.02         # bf16 compute against float32 (tests/test_trainer.py:316)
FEATURE_RTOL = 1e-4      # card features against the CPU's, relative in norm
EOS_BIAS = -10.0         # EOS this far below the largest spread bias: below all

# --only key -> (metric name, unit, BENCH_BASELINE.json key)
METRICS = {
    "beam": ("beam_captions_per_sec", "captions/s", "captions_per_sec"),
    "greedy": ("greedy_captions_per_sec", "captions/s", "greedy_captions_per_sec"),
    "bulk": ("bulk_greedy_captions_per_sec", "captions/s", "bulk_greedy_captions_per_sec"),
    "train": ("train_samples_per_sec", "samples/s", "train_samples_per_sec"),
    "extract": ("extract_clips_per_sec", "clips/s", "extract_clips_per_sec"),
}
HEADLINE = "captions/sec (beam decode, width 5, dual model)"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def spread_bias(decoders, seed, scale=2e-3, eos_bias=0.0):
    """Spread the vocab biases (a seeded permutation x scale) so the argmax
    and top-W decisions stay clear of near-ties; tokens still vary row to
    row.  ``eos_bias`` sets EOS that far from the largest bias (above it
    when positive, below every bias when below -V*scale)."""
    from mvc_tpu_torch.config import EOS_ID

    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(decoders[0]["out"]["b"].shape[0], generator=g).float() * scale
    if eos_bias:
        perm[EOS_ID] = perm.max() + eos_bias
    out = []
    for p in decoders:
        p = {k: dict(v) for k, v in p.items()}
        p["out"]["b"] = p["out"]["b"] + perm.to(p["out"]["b"].device)
        out.append(p)
    return out


# ------------------------------------------------------------------ inputs
def decode_inputs(seed, b, t, device):
    """bench.py's decode features: audio [b, t, 128] then visual [b, t, 2048]
    float32 from ``np.random.default_rng(seed)``; every frame real."""
    gen = np.random.default_rng(seed)
    audio = gen.normal(size=(b, t, 128)).astype(np.float32)
    visual = gen.normal(size=(b, t, 2048)).astype(np.float32)
    return torch.from_numpy(audio).to(device), torch.from_numpy(visual).to(device)


def decoder_names(model):
    from mvc_tpu_torch.models import AVCaptioning

    return ["decoder"] if isinstance(model, AVCaptioning) else ["v_decoder", "a_decoder"]


def decode_model(kind, device, seed, dtype=torch.bfloat16, vocab=VOCAB, **model_kw):
    """(model, params) of a decode metric: ``AVCaptioningDual`` ("dual") or
    ``AVCaptioning`` ("single") with weights from ``seed`` and each decoder's
    vocab biases spread, EOS below them all; ``model_kw`` reaches the
    model's constructor (the tests' small widths)."""
    from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual

    cls = AVCaptioning if kind == "single" else AVCaptioningDual
    model = cls(vocab_size=vocab, dtype=dtype, device=device, **model_kw)
    params = model.init(torch.Generator().manual_seed(seed))
    names = decoder_names(model)
    params.update(zip(names, spread_bias([params[n] for n in names], seed + 1,
                                         eos_bias=EOS_BIAS)))
    return model, params


def decode_through(model, params, audio, visual, mode, dtype, max_len, width, plain):
    """One decode of the kernel ``predict_tokens`` reaches on the card,
    through its wrapper (``plain`` False: the kernel on the card, the plain
    version on the CPU) or its plain version, with the model's decoders
    cast to ``dtype`` as the model casts them: (tokens, the rows x steps
    the plain version ran; None for a wrapper's beam)."""
    from mvc_tpu_torch.models.decoder import cast_params_for_decode
    from mvc_tpu_torch.ops import beam, dual_greedy, greedy

    decs = [cast_params_for_decode(params[n], dtype) for n in decoder_names(model)]
    b = visual.shape[0]
    if len(decs) == 1:
        feats = [torch.cat([audio, visual], dim=-1)]
        cells = (model.decoder_config.rnn_type,)
    else:
        feats = [visual, audio]
        cells = (model.v_config.rnn_type, model.a_config.rnn_type)
    if mode == "beam":
        if not plain:
            return beam.beam_decode(decs, feats, None, max_len, width, 0.0, dtype, cells), None
        tokens, steps = beam.beam_decode_reference(decs, feats, None, max_len, width, 0.0, dtype,
                                                   cells, return_steps=True)
        return tokens, int(steps.sum()) * width
    if len(decs) == 1:
        fn = greedy.greedy_decode_reference if plain else greedy.greedy_decode
        return fn(decs[0], feats[0], None, max_len, dtype, cells[0]), b * (max_len - 1)
    fn = dual_greedy.dual_greedy_decode_reference if plain else dual_greedy.dual_greedy_decode
    return fn(decs, feats, None, max_len, dtype, cells), b * (max_len - 1)


def agreement(got, want) -> float:
    """Share of equal tokens (0 when the shapes differ)."""
    if got.shape != want.shape:
        return 0.0
    return float((got.long() == want.long()).float().mean())


def train_batch(seed, b=TRAIN_B, t=TRAIN_T, l=TRAIN_L, vocab=VOCAB):
    """bench.py's train batch (``bench.py:370-381``) as numpy: audio and
    visual normal, captions [l, b] int32 (SOS, then ids in [3, vocab)),
    every frame real."""
    gen = np.random.default_rng(seed)
    audio = gen.normal(size=(b, t, 128)).astype(np.float32)
    visual = gen.normal(size=(b, t, 2048)).astype(np.float32)
    captions = np.concatenate([np.full((1, b), 1, np.int32),
                               gen.integers(3, vocab, size=(l - 1, b), dtype=np.int32)])
    return {"audio": audio, "visual": visual, "captions": captions,
            "feat_mask": np.ones((b, t), bool)}


def train_setup(device, seed, dtype, params=None, vocab=VOCAB, **model_kw):
    """(step, model, params, optimizer) of bench.py's train step: the dual
    model with global reconstructors in ``dtype`` compute, float32 master
    parameters from ``seed`` (or ``params``), ``Trainer._build_train_step``
    and its optimizer at ``TrainerConfig``'s defaults."""
    from mvc_tpu_torch.config import TrainerConfig
    from mvc_tpu_torch.models import AVCaptioningDual
    from mvc_tpu_torch.training import optimizer as opt_lib
    from mvc_tpu_torch.training.trainer import Trainer

    compute = "bfloat16" if dtype == torch.bfloat16 else "float32"
    cfg = TrainerConfig(batch_size=TRAIN_B, compute_dtype=compute)
    model = AVCaptioningDual(vocab_size=vocab, reconstructor_type="global", dtype=dtype,
                             device=device, **model_kw)
    if params is None:
        params = model.init(torch.Generator().manual_seed(seed))
    step, _ = Trainer("bench", log_dir=None)._build_train_step(model, cfg)
    return step, model, params, opt_lib.make_optimizer(cfg, params)


def device_batch(batch, device):
    """A numpy batch as tensors on ``device`` (float32 features)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def write_clips(root, n, seconds, seed):
    """``n`` synthetic MJPG clips of ``seconds`` s (25 fps, 320x240, WAV
    sidecars; ``extract.synthetic.make_clip_set``), one seed a clip, written
    on host threads, as ``root/videos/clip<i>_0_<s>.avi``."""
    from mvc_tpu_torch.extract.synthetic import make_clip_set

    def one(i):
        part = os.path.join(root, "parts", str(i))
        make_clip_set(part, 1, seconds=seconds, seed=seed * 1000 + i)
        name = f"clip000_0_{int(seconds)}"
        for sub, ext in (("videos", "avi"), ("audios", "wav")):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            os.replace(os.path.join(part, sub, f"{name}.{ext}"),
                       os.path.join(root, sub, f"clip{i:03d}_0_{int(seconds)}.{ext}"))

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(one, range(n)))
    shutil.rmtree(os.path.join(root, "parts"))
    return os.path.join(root, "videos")


# ------------------------------------------------------------------ the run
class Run:
    """The device, seed and measured HBM rate every metric shares."""

    def __init__(self, device, seed):
        from mvc_tpu_torch.utils.roofline import measure_triad

        self.device, self.seed = device, seed
        self.on_card = device.type == "cuda"
        self.triad_gbps = measure_triad(device) if self.on_card else None
        if self.triad_gbps is not None:
            log(f"measured triad HBM: {self.triad_gbps:.1f} GB/s")

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def timed(self, call, iters):
        """(calls, seconds) of ``iters`` calls of ``call`` that end in a
        synchronize, host clock (warm-up is the caller's)."""
        self.sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        self.sync()
        return iters, time.perf_counter() - t0

    def entry(self, key, calls, seconds, per_call, flops, nbytes, peak_flops, correct, extra):
        """A metric's entry: rate, baseline ratio, counts and roofline."""
        from mvc_tpu_torch.utils.roofline import roofline

        name, unit, base_key = METRICS[key]
        value = calls * per_call / seconds
        base = baseline().get(base_key)
        e = {"value": value, "unit": unit, "vs_baseline": value / base if base else None,
             "calls": calls, "seconds": seconds, "correct": bool(correct), **extra}
        return roofline(e, flops, nbytes, calls / seconds if self.on_card else None,
                        peak_flops, self.triad_gbps and self.triad_gbps * 1e9)


def baseline():
    """The reference's cached CPU numbers (read only; {} when absent)."""
    if not os.path.isfile(BASELINE):
        return {}
    with open(BASELINE) as f:
        return json.load(f)


def bench_decode(run, key):
    """beam (dual, B=64, W=5), greedy (single, B=64) or bulk (dual direct,
    B=1024): ``predict_tokens`` in bf16, timed; one call against the plain
    version."""
    from mvc_tpu_torch.ops import beam, dual_greedy, greedy
    from mvc_tpu_torch.utils.roofline import PEAK_BF16_FLOPS, decode_work

    kind, b, mode, wrapper = {
        "beam": ("dual", B, "beam", beam.beam_decode),
        "greedy": ("single", B, "direct", greedy.greedy_decode),
        "bulk": ("dual", BULK_B, "direct", dual_greedy.dual_greedy_decode)}[key]
    model, params = decode_model(kind, run.device, run.seed, vocab=VOCAB)
    decs = [params[n] for n in decoder_names(model)]
    audio, visual = decode_inputs(run.seed, b, T, run.device)

    def call():
        return model.predict_tokens(params, audio, visual, max_caption_len=MAX_LEN, mode=mode,
                                    beam_width=WIDTH)

    tokens = call()                    # the warm-up call is the one checked
    run.sync()

    def through(dtype, plain, scale=1.0):
        return decode_through(model, params, audio * scale, visual * scale, mode, dtype,
                              MAX_LEN, WIDTH, plain)

    plain, row_steps = through(model.dtype, True)
    same = agreement(tokens, plain)
    # the plain version against itself with the features nudged by about
    # one float32 ulp: how far bf16 rounding points amplify such noise
    nudged = agreement(through(model.dtype, True, 1 + 2.0 ** -23)[0], plain)
    exact = torch.equal(through(torch.float32, False)[0], through(torch.float32, True)[0])
    correct = exact and (same >= AGREE or mode == "beam") and bool(
        ((tokens >= 0) & (tokens < VOCAB)).all())
    log(f"{key}: {tuple(tokens.shape)} tokens equal to the plain version's: bf16 {same:.6f} "
        f"(the plain version against itself, features nudged by one ulp: {nudged:.6f}); "
        f"float32 kernel = plain exactly: {exact}")
    before = wrapper.launches
    calls, seconds = run.timed(call, ITERS[key])
    dims = (2176,) if kind == "single" else (2048, 128)
    out = b * (MAX_LEN + 2) if mode == "beam" else b * MAX_LEN
    pre, kern, nbytes = decode_work(decs, dims, row_steps, out, 2, b=b, t=T)
    extra = {"kernel_launches": wrapper.launches - before, "tokens_equal": same,
             "tokens_equal_plain_nudged": nudged, "float32_exact": exact, "batch": b,
             "row_steps": row_steps}
    return run.entry(key, calls, seconds, b, pre + kern, nbytes, PEAK_BF16_FLOPS, correct, extra)


def bench_train(run, out_dir):
    """bench.py's train step in bf16 compute over float32 masters on a
    device-resident batch: 5 steps against float32 compute from the same
    parameters, then ``ITERS`` timed steps, then a profiled window."""
    from mvc_tpu_torch.utils.roofline import PEAK_BF16_FLOPS, profiled_busy_pct, train_step_work

    batch = device_batch(train_batch(run.seed, TRAIN_B, TRAIN_T, TRAIN_L, VOCAB), run.device)
    gen = torch.Generator().manual_seed(run.seed + 1)
    step, model, params, opt = train_setup(run.device, run.seed, torch.bfloat16, vocab=VOCAB)
    step32, _, params32, opt32 = train_setup(run.device, run.seed, torch.float32,
                                             params=copy.deepcopy(params), vocab=VOCAB)
    losses = {}
    for name, st, o in (("bfloat16", step, opt), ("float32", step32, opt32)):
        p, trace = (params if name == "bfloat16" else params32), []
        for _ in range(CHECK_STEPS):
            p, m = st(p, o, batch, gen)
            trace.append(m[0])
        losses[name] = [float(x) for x in torch.stack(trace).cpu()]
        if name == "bfloat16":
            params = p
    bf, f32 = np.array(losses["bfloat16"]), np.array(losses["float32"])
    rel = np.abs(bf - f32) / np.abs(f32)
    correct = bool(np.isfinite(bf).all() and (rel <= LOSS_RTOL).all())
    log(f"train: first {CHECK_STEPS} losses bf16 {bf.tolist()} float32 {f32.tolist()}; worst "
        f"relative difference {rel.max():.3e} (limit {LOSS_RTOL})")
    del params32, opt32
    state = {"p": params}

    def one():
        state["p"], m = step(state["p"], opt, batch, gen)
        return m

    calls, seconds = run.timed(one, ITERS["train"])
    last = float(one()[0])
    correct = correct and np.isfinite(last)
    busy = None
    if run.on_card:
        busy = profiled_busy_pct(lambda: [one() for _ in range(PROFILE_STEPS)], run.device,
                                 out_dir)
        log(f"train: card busy {busy if busy is not None else 'not measured'} % over "
            f"{PROFILE_STEPS} profiled steps")
    flops, nbytes, n_params = train_step_work(model, params, TRAIN_B, TRAIN_T, TRAIN_L,
                                              feature_bytes=4)
    extra = {"device_busy_pct_measured": busy, "losses_bf16": losses["bfloat16"],
             "losses_float32": losses["float32"], "params": n_params,
             "teacher_forcing_ratio": model.teacher_forcing_ratio}
    return run.entry("train", calls, seconds, TRAIN_B, flops, nbytes, PEAK_BF16_FLOPS, correct,
                     extra)


def bench_extract(run, out_dir):
    """``FeatureExtractor.extract_dataset`` over ``N_CLIPS`` synthetic clips
    at fps=1, ``CHUNK`` to a chunk, host decode included: one untimed
    sweep, one timed; the first clip against the CPU's encode."""
    from mvc_tpu_torch.extract import FeatureExtractor
    from mvc_tpu_torch.utils.roofline import PEAK_F32_FLOPS, extract_work

    videos = write_clips(out_dir, N_CLIPS, CLIP_SECONDS, run.seed)
    fe = FeatureExtractor(fps=1, seed=run.seed, device=run.device)
    fe.extract_dataset(videos, os.path.join(out_dir, "warm"), batch_size=CHUNK, verbose=False)
    feats = os.path.join(out_dir, "features")
    t0 = time.perf_counter()
    stats = fe.extract_dataset(videos, feats, batch_size=CHUNK, verbose=False)
    seconds = time.perf_counter() - t0
    name = sorted(os.listdir(videos))[0]
    stem = os.path.splitext(name)[0]
    v = np.load(os.path.join(feats, "video", f"{stem}.npy"))
    a = np.load(os.path.join(feats, "audio", f"{stem}.npy"))
    frames, wav = fe._decode_one(os.path.join(videos, name))
    fe_cpu = FeatureExtractor(fps=1, seed=run.seed, device="cpu") if run.on_card else fe
    want_v, want_a = fe_cpu._encode_decoded([(frames, wav)])[0]
    err = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
              for g, w in ((v, want_v), (a, want_a)))
    correct = (stats["done"] == N_CLIPS and not stats["failures"] and v.shape == want_v.shape
               and a.shape == want_a.shape and bool(np.isfinite(v).all())
               and bool(np.isfinite(a).all()) and err <= FEATURE_RTOL)
    log(f"extract: {stats}; first clip's features {v.shape} {a.shape} against the CPU's encode: "
        f"{err:.3e} relative in norm (limit {FEATURE_RTOL})")
    flops, nbytes = extract_work(fe, v.shape[0], a.shape[0], wav.shape[0], N_CLIPS)
    split = {"decode_s": stats["decode_s"], "encode_s": stats["encode_s"],
             "host_decode_frac_of_wall": stats["decode_s"] / seconds,
             "measured_bound": ("host decode" if stats["decode_s"] >= stats["encode_s"]
                                else "device encode")}
    extra = {"host_device_split": split, "clips": N_CLIPS, "clip_seconds": CLIP_SECONDS,
             "feature_rel_err": err}
    return run.entry("extract", stats["done"], seconds, 1, flops, nbytes, PEAK_F32_FLOPS,
                     correct, extra)


def device_record(device):
    """The line's ``device``: platform, name, power limit, count."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": platform.processor() or platform.machine(),
                "power_limit": None, "count": 1}
    smi = subprocess.run(["nvidia-smi", "-i", str(device.index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    return {"platform": "gpu", "name": torch.cuda.get_device_name(device),
            "power_limit": smi.rsplit(",", 1)[-1].strip(), "nvidia_smi": smi,
            "count": torch.cuda.device_count()}


def payload(metrics, device, run):
    from mvc_tpu_torch.utils.roofline import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS

    head_name = ("beam_captions_per_sec" if "beam_captions_per_sec" in metrics
                 else next(iter(metrics), None))
    head = metrics.get(head_name, {})
    return {
        "metric": HEADLINE if head_name == "beam_captions_per_sec" else head_name,
        "value": head.get("value"), "unit": head.get("unit", "captions/s"),
        "vs_baseline": head.get("vs_baseline"), "metrics": metrics, "device": device,
        "roofline": {"peak_tflops_bf16": PEAK_BF16_FLOPS / 1e12,
                     "peak_tflops_f32": PEAK_F32_FLOPS / 1e12,
                     "peak_hbm_gbps_datasheet": PEAK_BYTES / 1e9,
                     "peak_hbm_gbps_measured": run.triad_gbps,
                     "note": "H100 SXM data-sheet peaks at 700 W; hbm_pct against the measured "
                             "triad; FLOPs and bytes counted from shapes"},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="beam,greedy,bulk,train,extract",
                    help="comma list of beam,greedy,bulk,train,extract")
    ap.add_argument("--seed", type=int, default=0, help="weights and inputs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    which = [k for k in METRICS if k in args.only.split(",")]
    unknown = set(args.only.split(",")) - set(METRICS)
    if unknown or not which:
        ap.error(f"--only takes {','.join(METRICS)}; got {args.only!r}")

    from mvc_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"bench: {e}") from None
    out = sys.stdout
    metrics, failed = {}, []
    with contextlib.redirect_stdout(sys.stderr), tempfile.TemporaryDirectory() as tmp:
        run = Run(device, args.seed)
        record = device_record(device)
        log(f"device: {record}")
        for key in which:
            name = METRICS[key][0]
            work = os.path.join(tmp, key)
            os.makedirs(work)
            t0 = time.perf_counter()
            try:
                if key == "train":
                    e = bench_train(run, work)
                elif key == "extract":
                    e = bench_extract(run, work)
                else:
                    e = bench_decode(run, key)
            except Exception:                # reported; the run exits 1 at the end
                traceback.print_exc()
                failed.append(name)
                continue
            log(f"{name}: {e['value']:.2f} {e['unit']} ({time.perf_counter() - t0:.1f} s "
                f"with set-up), correct {e['correct']}")
            metrics[name] = e
            if not e["correct"]:
                failed.append(name)
            print(json.dumps(payload(metrics, record, run)), file=out, flush=True)
    if failed:
        raise SystemExit(f"bench: failed metrics {failed}")
    return payload(metrics, record, run)


if __name__ == "__main__":
    main()
