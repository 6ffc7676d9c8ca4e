"""The port's benchmark entry points (``cli/bench.py``, ``cli/bench_serving.py``)
and their yardstick (``utils/roofline.py``) on the CPU.

- The shape counters equal ``FlopCounterMode``'s count over the plain
  versions, plus the terms it cannot see (elementwise multiply-adds),
  exactly for the decodes and within a stated tolerance for the train step.
- The bench's seeded inputs and spread-bias weights give the JAX package's
  tokens, and its train step the JAX trainer's losses, at small widths in
  float32, through the weights bridge.
- ``--device cpu`` prints the line with every key, labelled CPU; without a
  card and without it, both CLIs exit non-zero and print nothing.

Small widths everywhere (H=16, E=8, A=8, V=60; the features keep their
2048/128 widths).  The CLI runs hold the decodes in float32: on the CPU the
models take their own scan path, which rounds the logits to bf16 where the
kernels' plain versions keep them in float32, so the two agree exactly only
in float32 (on the card the bench holds the kernel to its plain version in
bf16).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mvc_tpu.config import DecoderConfig as JaxDecoderConfig
from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
from mvc_tpu.models import AVCaptioning as JaxAVCaptioning
from mvc_tpu.models import AVCaptioningDual as JaxDual
from mvc_tpu.training import optimizer as jopt
from mvc_tpu.training.trainer import Trainer as JaxTrainer
from mvc_tpu_torch.cli import bench, bench_serving
from mvc_tpu_torch.config import DecoderConfig
from mvc_tpu_torch.utils import roofline as rl
from mvc_tpu_torch.utils.jax_weights import to_numpy_tree

V, B, T, L, W = 60, 2, 3, 5, 3
SMALL = dict(rnn_hidden_size=16, embedding_size=8, attn_size=8)
CPU = torch.device("cpu")


def _configs(cls, kind):
    if kind == "single":
        return {"decoder_config": cls(in_feature_size=2176, **SMALL)}
    return {"visual_decoder_config": cls(in_feature_size=2048, **SMALL),
            "audio_decoder_config": cls(in_feature_size=128, **SMALL)}


def _decode(kind, dtype=torch.float32):
    return bench.decode_model(kind, CPU, 0, dtype=dtype, vocab=V, **_configs(DecoderConfig, kind))


CASES = {"dual direct": ("dual", "direct"), "single direct": ("single", "direct"),
         "dual beam": ("dual", "beam")}


# ------------------------------------------------------------------ (a) counters
@pytest.mark.parametrize("case", list(CASES) + ["train"])
def test_counters_equal_flop_counter_over_the_plain_versions(case):
    """Decodes: ``decode_work`` = FlopCounterMode over the plain version +
    the attention energies (``(tanh(keys + q) * w).sum(-1)``, 2*T*A a row
    and step: elementwise, which FlopCounterMode does not count), exactly;
    every beam runs all max_len + 1 steps.  Train step: ``train_step_work``
    (3x the forward's products) within 5 % of FlopCounterMode over the
    step's forward and backward (0.04 % here; 4.4 % at the full widths,
    B=8, T=28, L=8): the two differ where a product is not 3x its forward,
    the keys' GEMM (its features take no gradient: one backward GEMM, not
    two) against the free-running decoders' in-loop vocab products (no
    backward) and the fused loss's recomputed logits, and in the energies,
    which FlopCounterMode does not see."""
    if case == "train":
        kw = _configs(DecoderConfig, "dual")
        step, model, params, opt = bench.train_setup(CPU, 0, torch.float32, vocab=V, **kw)
        batch = bench.device_batch(bench.train_batch(0, b=4, t=T, l=4, vocab=V), CPU)
        with FlopCounterMode(display=False) as fc:
            step(params, opt, batch, torch.Generator().manual_seed(1))
        flops, nbytes, n = rl.train_step_work(model, params, 4, T, 4, feature_bytes=4)
        assert n == sum(p.numel() for p in opt.leaves)
        assert nbytes > 4 * 9 * n
        assert abs(flops / fc.get_total_flops() - 1) <= 0.05
        return
    kind, mode = CASES[case]
    model, params = _decode(kind)
    audio, visual = bench.decode_inputs(0, B, T, CPU)
    with FlopCounterMode(display=False) as fc:
        tokens, row_steps = bench.decode_through(model, params, audio, visual, mode,
                                                 torch.float32, L, W, True)
    decs = [params[n] for n in bench.decoder_names(model)]
    dims = (2176,) if kind == "single" else (2048, 128)
    out = B * (L + 2) if mode == "beam" else B * L
    pre, kern, nbytes = rl.decode_work(decs, dims, row_steps, out, 4, b=B, t=T)
    unseen = row_steps * sum(2 * T * p["attention"]["W"].shape[1] for p in decs)
    assert pre + kern == fc.get_total_flops() + unseen
    if mode == "beam":
        assert row_steps == B * W * (L + 1)
        assert not (tokens[:, 1:] == 2).any()           # no beam ever chose EOS
    else:
        assert row_steps == B * (L - 1)
    weights = sum(x.numel() for p in decs for sub in p.values() for x in sub.values())
    assert nbytes == B * T * 4 + out * 4 + B * T * sum(dims) * 4 + weights * 4


# ------------------------------------------------------------------ (b) tokens
@pytest.mark.parametrize("case", list(CASES))
def test_bench_inputs_give_the_jax_tokens(case):
    """The bench's seeded features and spread-bias weights through the
    port's ``predict_tokens`` and the JAX model's (weights bridged), float32,
    beam at W=3: the same tokens."""
    kind, mode = CASES[case]
    model, params = _decode(kind)
    audio, visual = bench.decode_inputs(0, B, T, CPU)
    got = model.predict_tokens(params, audio, visual, max_caption_len=L, mode=mode,
                               beam_width=W)
    jcls = JaxAVCaptioning if kind == "single" else JaxDual
    jm = jcls(vocab_size=V, **_configs(JaxDecoderConfig, kind))
    jp = jax.tree.map(jnp.asarray, to_numpy_tree(params))
    want = jm.predict_tokens(jp, jnp.asarray(audio.numpy()), jnp.asarray(visual.numpy()),
                             max_caption_len=L, mode=mode, beam_width=W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ (c) train step
def test_bench_train_step_matches_the_jax_trainer():
    """The bench's train step (float32, small widths, bench.py's batch and
    model defaults) against the JAX trainer's ``_build_train_step`` from the
    same parameters: each of two steps' loss within 1e-4 relative."""
    kw = _configs(DecoderConfig, "dual")
    step, model, params, opt = bench.train_setup(CPU, 0, torch.float32, vocab=V, **kw)
    host = bench.train_batch(0, b=4, t=T, l=4, vocab=V)
    jm = JaxDual(vocab_size=V, reconstructor_type="global", **_configs(JaxDecoderConfig, "dual"))
    jcfg = JaxTrainerConfig(batch_size=bench.TRAIN_B)
    jt = JaxTrainer("bench", log_dir=None)
    jt._optimizer = jopt.make_optimizer(jcfg)
    jstep, _ = jt._build_train_step(jm, jcfg)
    jp = jax.tree.map(jnp.asarray, to_numpy_tree(params))
    js = jt._optimizer.init(jp)
    batch = bench.device_batch(host, CPU)
    jb = jax.tree.map(jnp.asarray, host)
    for _ in range(2):
        params, m = step(params, opt, batch, torch.Generator().manual_seed(1))
        jp, js, jm_ = jstep(jp, js, jb, jax.random.PRNGKey(1))
        np.testing.assert_allclose(float(m[0]), float(jm_["total"]), rtol=1e-4)


# ------------------------------------------------------------------ (d) the CLI on the CPU
class _SmallExtractor:
    """``FeatureExtractor`` at Inception's smallest input, one-frame buckets."""

    def __new__(cls, *a, **k):
        from mvc_tpu_torch.extract.features import FeatureExtractor

        fe = FeatureExtractor(*a, frame_buckets=(1, 2), audio_buckets=(1, 2), **k)
        fe.frame_size = (75, 75)
        return fe


@pytest.fixture
def small_bench(monkeypatch):
    import mvc_tpu_torch.extract as extract

    def decode_model(kind, *a, **k):
        return _decode_model(kind, *a, dtype=torch.float32, **k, **_configs(DecoderConfig, kind))

    _decode_model = bench.decode_model
    monkeypatch.setattr(bench, "decode_model", decode_model)
    monkeypatch.setattr(bench, "train_setup",
                        functools.partial(bench.train_setup, **_configs(DecoderConfig, "dual")))
    monkeypatch.setattr(extract, "FeatureExtractor", _SmallExtractor)
    for name, value in dict(VOCAB=V, B=B, T=T, MAX_LEN=L, WIDTH=W, BULK_B=4, TRAIN_B=4,
                            TRAIN_T=T, TRAIN_L=4, N_CLIPS=1, CLIP_SECONDS=1.0, CHUNK=1,
                            CHECK_STEPS=2,
                            ITERS={"beam": 2, "greedy": 2, "bulk": 2, "train": 2}).items():
        monkeypatch.setattr(bench, name, value)


ENTRY_KEYS = {"value", "unit", "vs_baseline", "calls", "seconds", "correct", "gflops_per_call",
              "gbytes_per_call", "achieved_tflops", "mfu_pct", "hbm_gbps", "hbm_gbps_est",
              "hbm_pct", "hbm_pct_datasheet", "bound"}


def test_cpu_run_prints_every_metric_and_key_labelled_cpu(small_bench, capsys):
    """One line per metric as it lands; the last holds all five, every key,
    ``platform`` cpu and no rate or share of the card; the baseline file
    is only read."""
    pytest.importorskip("cv2")
    with open(bench.BASELINE, "rb") as f:
        baseline = f.read()
    out = bench.main(["--device", "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 5 and lines[-1] == json.loads(json.dumps(out))
    line = lines[-1]
    assert {"metric", "value", "unit", "vs_baseline", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "cpu" and line["roofline"]["peak_hbm_gbps_measured"] is None
    assert list(line["metrics"]) == [m for m, _u, _b in bench.METRICS.values()]
    assert line["metric"] == bench.HEADLINE
    for name, e in line["metrics"].items():
        assert ENTRY_KEYS <= set(e), name
        assert e["correct"] is True and e["calls"] >= 1 and e["value"] > 0
        assert e["gflops_per_call"] > 0 and e["vs_baseline"] > 0
        assert e["mfu_pct"] is None and e["hbm_gbps"] is None and e["bound"] is None
    assert "device_busy_pct_measured" in line["metrics"]["train_samples_per_sec"]
    split = line["metrics"]["extract_clips_per_sec"]["host_device_split"]
    assert {"decode_s", "encode_s", "measured_bound"} <= set(split)
    with open(bench.BASELINE, "rb") as f:
        assert f.read() == baseline


# ------------------------------------------------------------------ (e) no card
@pytest.mark.parametrize("cli", [bench, bench_serving], ids=["bench", "bench_serving"])
def test_no_card_exits_nonzero_and_prints_no_metric(cli, capsys):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as e:
        cli.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


# ------------------------------------------------------------------ (f) roofline
@pytest.mark.parametrize("flops,nbytes,peak,bound", [
    (1e15, 1.0, rl.PEAK_BF16_FLOPS, "tensor core share"),    # 1,000 TFLOP/s > 989
    (7e13, 1.0, rl.PEAK_F32_FLOPS, "CUDA cores share"),      # 70 TFLOP/s > 67
    (1.0, 4e12, rl.PEAK_BF16_FLOPS, "HBM share"),            # 4 TB/s > 3.35
    (5e14, 1.0, rl.PEAK_BF16_FLOPS, "tensor core"),          # 50.6 %
    (1.0, 2e12, rl.PEAK_BF16_FLOPS, "HBM"),                  # 59.7 %
    (1e14, 1e12, rl.PEAK_BF16_FLOPS, "latency"),             # 10.1 %, 29.9 %
])
def test_roofline_names_the_bound_and_raises_above_100_pct(flops, nbytes, peak, bound):
    """FLOPs and bytes a second, as 1,000 calls a second: a share above
    100 % raises ValueError naming the bound; otherwise the larger share at
    >= 40 % bounds the call, else latency."""
    if bound.endswith("share"):
        with pytest.raises(ValueError, match=bound):
            rl.roofline({}, flops * 1e-3, nbytes * 1e-3, 1e3, peak)
        return
    e = rl.roofline({}, flops * 1e-3, nbytes * 1e-3, 1e3, peak)
    assert e["bound"] == bound and e["hbm_gbps"] == e["hbm_gbps_est"]
    assert e["mfu_pct"] == pytest.approx(100 * flops / peak)
    assert e["hbm_pct"] == pytest.approx(100 * nbytes / rl.PEAK_BYTES)


# ------------------------------------------------------------------ bench_serving
JAX_KEYS = {
    "closed_loop": {"phase", "mode", "concurrency", "captions_per_s", "p50_ms", "p95_ms",
                    "p99_ms", "mean_batch_occupancy", "batches", "h2d_mb_per_batch",
                    "max_batch", "pipeline_depth", "transfer"},
    "open_loop": {"phase", "mode", "target_qps", "achieved_qps", "frac_of_max", "p50_ms",
                  "p95_ms", "p99_ms", "max_batch", "pipeline_depth", "transfer"},
    "http_closed_loop": {"phase", "mode", "clients", "n", "captions_per_s", "p50_ms", "p95_ms",
                         "p99_ms", "http_200", "non_200", "max_batch", "transfer"},
    "http_overload": {"phase", "mode", "clients", "n", "served_per_s", "http_200",
                      "http_503_shed", "shed_counter", "max_queue"},
}


def test_bench_serving_on_the_cpu_keeps_the_jax_keys(monkeypatch, capsys):
    """A small dual model: 8 requests at concurrency 1 and 4, one open-loop
    fraction, one HTTP client, the overload phase and the ablation; every
    line has the JAX script's keys, the sample counts, and every attempted
    request completed."""
    import mvc_tpu_torch.models as models

    class Small(models.AVCaptioningDual):
        def __init__(self, *a, **k):
            super().__init__(*a, **k, **_configs(DecoderConfig, "dual"))

    monkeypatch.setattr(models, "AVCaptioningDual", Small)
    monkeypatch.setattr(bench_serving, "VOCAB", V)
    monkeypatch.setattr(bench_serving, "MAX_LEN", L)
    out = bench_serving.main(["--device", "cpu", "--n", "8", "--n-open", "8", "--concurrency",
                              "1", "4", "--qps-fracs", "0.5", "--http-clients", "1",
                              "--http-n", "2"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines == json.loads(json.dumps(out))
    assert [e["phase"] for e in lines] == ["closed_loop", "closed_loop", "open_loop",
                                           "http_closed_loop", "http_overload", "closed_loop"]
    assert [e.get("pipeline_depth") for e in lines] == [2, 2, 2, None, None, 1]
    for e in lines:
        assert JAX_KEYS[e["phase"]] <= set(e), e["phase"]
        assert e["completed"] == e["attempted"] and e["failed"] == 0
        assert e["device"]["platform"] == "cpu"
        if "p50_ms" in e:
            assert e["samples"] == e["attempted"] and e["p50_ms"] <= e["p99_ms"]
    assert [e["attempted"] for e in lines] == [8, 16, 8, 2, 2, 16]
