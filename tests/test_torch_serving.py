"""The port's caption service against the JAX service, on the CPU.

Same requests, same weights (the ``tiny`` model of tests/test_serving.py,
carried across by the bridge): the two services must return the same
captions.  Its random init leaves no near-tied argmax on these requests, so
the vocab biases are left as drawn.
Also: the HTTP front end, the card-by-default rule, and the package's
independence from JAX.
"""

import functools
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.data import Vocabulary as JaxVocabulary
from mvc_tpu.models import AVCaptioning as JaxAVCaptioning
from mvc_tpu.models import AVCaptioningDual as JaxDual
from mvc_tpu.serving import CaptionService as JaxService
from mvc_tpu.serving import ServiceConfig as JaxServiceConfig
from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
from mvc_tpu_torch.data import Vocabulary
from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual
from mvc_tpu_torch.serving import CaptionService, ServiceConfig, make_http_server
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

A_DIM, V_DIM = 8, 16
BUCKETS = (4, 8)
TINY_V = dict(rnn_type="LSTM", in_feature_size=V_DIM, rnn_hidden_size=12,
              embedding_size=8, attn_size=6, output_size=1)
TINY_A = dict(rnn_type="LSTM", in_feature_size=A_DIM, rnn_hidden_size=10,
              embedding_size=8, attn_size=6, output_size=1)
SERVICE = dict(max_batch=4, max_wait_ms=300.0, frame_buckets=BUCKETS, max_caption_len=6,
               audio_dim=A_DIM, visual_dim=V_DIM)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jvocab = JaxVocabulary(freq_threshold=1)
    jvocab.build_vocabulary(["a man plays a guitar", "a dog runs on grass",
                             "someone slices a tomato"])
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.json")
    jvocab.save(path)
    jmodel = JaxDual(vocab_size=len(jvocab), reconstructor_type="none",
                     visual_decoder_config=DecoderConfig(**TINY_V),
                     audio_decoder_config=DecoderConfig(**TINY_A))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    vocab = Vocabulary.load(path)
    assert vocab.itos == jvocab.itos and len(vocab) == len(jvocab)
    model = AVCaptioningDual(vocab_size=len(vocab), device="cpu",
                             visual_decoder_config=TorchDecoderConfig(**TINY_V),
                             audio_decoder_config=TorchDecoderConfig(**TINY_A))
    return jmodel, jvocab, params, model, vocab


def _requests(seed, n, t_lo=5, t_hi=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(t_lo, t_hi + 1))
        out.append((rng.normal(size=(t, V_DIM)).astype(np.float32),
                    rng.normal(size=(t, A_DIM)).astype(np.float32)))
    return out


def test_service_matches_jax_service(tiny):
    jmodel, jvocab, params, model, vocab = tiny
    reqs = _requests(0, 6)
    with JaxService(jmodel, jax.tree.map(jax.numpy.asarray, params), jvocab,
                    JaxServiceConfig(**SERVICE)) as svc:
        want = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
    with CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**SERVICE),
                        device="cpu") as svc:
        got = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
        stats = svc.stats()
    assert got == want
    assert len(set(got)) > 1                                    # not one constant caption
    assert stats["requests"] == 6 and stats["batches"] < 6      # batching happened
    assert stats["compiled_t_pads"] == [8]


def test_service_pads_video_only_and_above_ladder(tiny):
    _, _, params, model, vocab = tiny
    cfg = ServiceConfig(**dict(SERVICE, max_batch=2, max_wait_ms=1.0))
    visual, _ = _requests(1, 1, t_lo=11, t_hi=11)[0]
    with CaptionService(model, from_numpy_tree(params), vocab, cfg, device="cpu") as svc:
        assert svc.warmup() == [4, 8]
        svc.reset_stats()
        solo = svc.submit(visual).result(timeout=60)
        zeros = svc.submit(visual, np.zeros((11, A_DIM), np.float32)).result(timeout=60)
        assert svc.stats()["compiled_t_pads"] == [4, 8, 16]    # next multiple of 8
        with pytest.raises(ValueError):
            svc.submit(np.zeros((3, V_DIM + 1), np.float32))
    assert solo == zeros
    with pytest.raises(RuntimeError):
        svc.submit(visual)                                      # closed


def test_http_round_trip(tiny):
    _, _, params, model, vocab = tiny
    reqs = _requests(2, 3)
    with CaptionService(model, from_numpy_tree(params), vocab,
                        ServiceConfig(**dict(SERVICE, max_wait_ms=20.0)), device="cpu") as svc:
        want = [svc.submit(v, a).result(timeout=60) for v, a in reqs]
        server = make_http_server(svc, port=0)
        import threading

        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def post(path, body):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        try:
            v, a = reqs[0]
            one = post("/caption", {"visual": v.tolist(), "audio": a.tolist()})
            assert one["caption"] == want[0] and one["latency_ms"] >= 0
            batch = post("/caption_batch", {"items": [
                {"visual": v.tolist(), "audio": a.tolist()} for v, a in reqs]})
            assert batch["captions"] == want
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                assert json.loads(r.read()) == {"ok": True}
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                assert json.loads(r.read())["requests"] >= 7
            with pytest.raises(urllib.error.HTTPError) as e:
                post("/caption", {"visual": [[0.0] * (V_DIM + 1)]})
            assert e.value.code == 400
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    assert not thread.is_alive()


def test_card_is_the_default(tiny, monkeypatch):
    """With no CUDA device the default device raises; nothing falls back."""
    _, _, params, model, vocab = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        AVCaptioningDual(vocab_size=len(vocab))
    with pytest.raises(RuntimeError):
        AVCaptioning(vocab_size=len(vocab))
    with pytest.raises(RuntimeError):
        CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**SERVICE))
    from mvc_tpu_torch.cli import serve_captions

    with pytest.raises(RuntimeError):
        serve_captions.main(["--checkpoint", "absent.ckpt", "--vocab", "absent.json"])


def test_unported_modes_raise(tiny):
    """An unknown wire format or decode mode fails construction (every
    wire format of the JAX service is ported)."""
    _, _, params, model, vocab = tiny
    for transfer in ("f16", "int4"):
        with pytest.raises(ValueError):
            CaptionService(model, params, vocab,
                           ServiceConfig(**dict(SERVICE, transfer=transfer)), device="cpu")
    with pytest.raises(ValueError):
        CaptionService(model, params, vocab, ServiceConfig(**dict(SERVICE, mode="sample")),
                       device="cpu")
    with pytest.raises(ValueError):
        model.predict_tokens(from_numpy_tree(params), torch.zeros(1, 4, A_DIM),
                             torch.zeros(1, 4, V_DIM), mode="sample")


def test_beam_service_matches_jax_service(tiny):
    jmodel, jvocab, params, model, vocab = tiny
    reqs = _requests(3, 6)
    cfg = dict(SERVICE, mode="beam", beam_width=3, beam_alpha=0.7)
    with JaxService(jmodel, jax.tree.map(jax.numpy.asarray, params), jvocab,
                    JaxServiceConfig(**cfg)) as svc:
        want = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
    with CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**cfg),
                        device="cpu") as svc:
        got = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
        stats = svc.stats()
    assert got == want
    assert len(set(got)) > 1
    assert stats["mode"] == "beam" and stats["requests"] == 6 and stats["batches"] < 6


@pytest.mark.parametrize("mode", ["direct", "beam"])
def test_single_model_service_matches_jax_service(tiny, mode):
    """``CaptionService(AVCaptioning)``: one decoder over [audio | visual]."""
    _, jvocab, _, _, vocab = tiny
    single = dict(TINY_V, in_feature_size=A_DIM + V_DIM)
    jmodel = JaxAVCaptioning(vocab_size=len(jvocab), decoder_config=DecoderConfig(**single))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    assert params["reconstructor"] is None
    model = AVCaptioning(vocab_size=len(vocab), decoder_config=TorchDecoderConfig(**single),
                         device="cpu")
    reqs = _requests(4, 6)
    cfg = dict(SERVICE, mode=mode, beam_width=3, beam_alpha=0.7)
    with JaxService(jmodel, jax.tree.map(jax.numpy.asarray, params), jvocab,
                    JaxServiceConfig(**cfg)) as svc:
        want = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
    with CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**cfg),
                        device="cpu") as svc:
        got = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
        stats = svc.stats()
    assert got == want
    assert len(set(got)) > 1
    assert stats["mode"] == mode and stats["requests"] == 6 and stats["batches"] < 6


@pytest.mark.parametrize("mode", ["direct", "beam"])
@pytest.mark.parametrize("single", [False, True], ids=["dual", "single"])
@pytest.mark.parametrize("transfer", ["bf16", "int8"])
def test_wire_formats_match_jax_service(tiny, transfer, single, mode):
    """``transfer="bf16"`` (host cast, round to nearest even) and ``"int8"``
    (host quantize, device dequantize): the same captions as the JAX
    service over the same wire, for either model in either mode."""
    jmodel, jvocab, params, model, vocab = tiny
    if single:
        cfg_s = dict(TINY_V, in_feature_size=A_DIM + V_DIM)
        jmodel = JaxAVCaptioning(vocab_size=len(jvocab), decoder_config=DecoderConfig(**cfg_s))
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
        model = AVCaptioning(vocab_size=len(vocab), decoder_config=TorchDecoderConfig(**cfg_s),
                             device="cpu")
    reqs = _requests(5, 6)
    cfg = dict(SERVICE, mode=mode, beam_width=3, beam_alpha=0.7, transfer=transfer)
    with JaxService(jmodel, jax.tree.map(jax.numpy.asarray, params), jvocab,
                    JaxServiceConfig(**cfg)) as svc:
        want = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
    with CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**cfg),
                        device="cpu") as svc:
        got = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
        assert svc.stats()["transfer"] == transfer
    assert got == want
    assert len(set(got)) > 1


class _Capture:
    """Stands in for the model: keeps a copy of what each
    ``predict_tokens`` call receives and passes the call on."""

    def __init__(self, model):
        self._model = model
        self.calls = []

        @functools.wraps(model.predict_tokens)
        def predict_tokens(params, audio, visual, *a, **kw):
            self.calls.append((audio.clone(), visual.clone(), kw["feat_mask"].clone()))
            return model.predict_tokens(params, audio, visual, *a, **kw)

        self.predict_tokens = predict_tokens

    def __getattr__(self, name):
        return getattr(self._model, name)


def _served_inputs(tiny, clips, **service):
    """Serve ``clips`` ((visual, audio or None) pairs, submitted at once);
    return each call's (requests, audio, visual, feat_mask) as
    ``predict_tokens`` received them, and the service's stats.  Requests of
    one priority take the rows of a batch in arrival order."""
    _, _, params, model, vocab = tiny
    capture = _Capture(model)
    with CaptionService(capture, from_numpy_tree(params), vocab,
                        ServiceConfig(**dict(SERVICE, **service)), device="cpu") as svc:
        for f in [svc.submit(v, a) for v, a in clips]:
            f.result(timeout=300)
        stats = svc.stats()
    out, first = [], 0
    for audio, visual, mask in capture.calls:
        n = int(mask.any(dim=1).sum())
        out.append((clips[first:first + n], audio, visual, mask))
        first += n
    assert first == len(clips)
    return out, stats


def _host_padded(clips, rows, t_pad):
    """The batch as the host-padded layout builds it: each clip's frames at
    the head of its row, zeros elsewhere (audio zeros for video-only)."""
    audio = np.zeros((rows, t_pad, A_DIM), np.float32)
    visual = np.zeros((rows, t_pad, V_DIM), np.float32)
    mask = np.zeros((rows, t_pad), bool)
    for i, (v, a) in enumerate(clips):
        visual[i, :len(v)] = v
        if a is not None:
            audio[i, :len(v)] = a
        mask[i, :len(v)] = True
    return audio, visual, mask


def _as_jax_service_sends(x, transfer):
    """A padded float32 batch through the JAX service's wire format, as the
    features ``predict_tokens`` sees: bf16 rounded as ml_dtypes rounds it,
    int8 dequantized as the JAX service's jitted dequantize gives it."""
    import jax.numpy as jnp

    from mvc_tpu.data.feature_cache import quantize_int8 as jax_quantize

    if transfer == "bf16":
        return np.asarray(x.astype(jnp.bfloat16)).astype(np.float32)
    if transfer == "int8":
        q, scale = jax_quantize(x)
        return np.asarray(jax.jit(lambda q, s: q.astype(jnp.float32) * s)(q, scale))
    return x


def test_wire_formats_reach_the_model_as_the_jax_service_sends_them(tiny):
    """What ``predict_tokens`` receives: bf16 features rounded as ml_dtypes
    rounds them, and int8 features dequantized to float32 bit for bit as
    the JAX service's jitted dequantize gives them."""
    x = np.random.default_rng(6).normal(size=(4, 8, V_DIM)).astype(np.float32) * 3
    x[1, 2] = 0.0                                   # an all-zero frame: scale 1.0
    clips = [(v, None) for v in x]
    for transfer, dtype in (("bf16", torch.bfloat16), ("int8", torch.float32)):
        calls, _ = _served_inputs(tiny, clips, transfer=transfer)
        assert len(calls) == 1                      # a full batch of 8-frame clips
        (_, audio, got, mask), = calls
        assert got.dtype == audio.dtype == dtype and bool(mask.all())
        np.testing.assert_array_equal(got.float().numpy(), _as_jax_service_sends(x, transfer))
        assert not audio.float().any()


BATCHES = {
    "mixed_lengths_one_bucket": [(5, True), (8, True), (6, True)],
    "above_the_ladder": [(11, True), (3, True)],
    "video_only": [(7, False), (4, False)],
    "batch_of_one": [(6, True)],
    "full_max_batch": [(5, True), (8, False), (2, True), (7, True)],
}


@pytest.mark.parametrize("transfer", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", list(BATCHES))
def test_device_padded_batch_equals_the_host_padded_one(tiny, case, transfer):
    """The service stages only the clips' own frames and pads on the device:
    ``predict_tokens`` must still receive, element for element, the audio,
    visual and ``feat_mask`` tensors of the host-padded layout through the
    JAX service's wire format, and ``h2d_bytes`` counts the packed frames
    (int8: payload and per-frame scales) and their int64 positions."""
    rng = np.random.default_rng(7)
    clips = []
    for t, with_audio in BATCHES[case]:
        v = (rng.normal(size=(t, V_DIM)) * 3).astype(np.float32)
        a = (rng.normal(size=(t, A_DIM)) * 3).astype(np.float32) if with_audio else None
        v[t // 2] = 0.0                               # an all-zero frame: int8 scale 1.0
        clips.append((v, a))
    calls, stats = _served_inputs(tiny, clips, transfer=transfer)
    dtype = torch.bfloat16 if transfer == "bf16" else torch.float32
    for reqs, audio, visual, mask in calls:
        t_pad = visual.shape[1]
        longest = max(len(v) for v, _ in reqs)
        assert t_pad == next((b for b in BUCKETS if longest <= b), -(-longest // 8) * 8)
        want_a, want_v, want_m = _host_padded(reqs, SERVICE["max_batch"], t_pad)
        assert audio.shape == want_a.shape and visual.shape == want_v.shape
        assert audio.dtype == visual.dtype == dtype and mask.dtype == torch.bool
        assert audio.device == visual.device == mask.device == torch.device("cpu")
        np.testing.assert_array_equal(mask.numpy(), want_m)
        for got, want in ((audio, want_a), (visual, want_v)):
            got = got.float().numpy()
            np.testing.assert_array_equal(got, _as_jax_service_sends(want, transfer))
            assert not np.signbit(got[~want_m]).any()  # padding is +0.0
    frames = sum(len(v) for v, _ in clips)
    wire = {"f32": 4, "bf16": 2, "int8": 1}[transfer]
    packed = frames * (A_DIM + V_DIM) * wire + (frames * 2 * 4 if transfer == "int8" else 0)
    assert stats["h2d_bytes"] == packed + frames * 8
    assert stats["staging_waits"] == 0                # no copy to wait for on the CPU
    assert stats["frames_real"] == frames


def test_over_limit_clip_fails_alone(tiny, monkeypatch):
    """A clip whose frame bucket exceeds the kernel's limit (stubbed to 32
    here; the card's comes from the kernel) is refused at submit; the clips
    submitted with it are captioned as the JAX service captions them."""
    jmodel, jvocab, params, model, vocab = tiny
    cfg = dict(SERVICE, max_batch=16, frame_buckets=(8, 16, 32, 48))
    short = _requests(5, 8)
    with JaxService(jmodel, jax.tree.map(jax.numpy.asarray, params), jvocab,
                    JaxServiceConfig(**cfg)) as svc:
        want = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in short]]
    monkeypatch.setattr(CaptionService, "_kernel_frame_limit", lambda self: 32)
    long_v, long_a = _requests(6, 1, t_lo=40, t_hi=40)[0]          # bucket 48
    with CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**cfg),
                        device="cpu") as svc:
        assert svc.max_frames == 32
        futures = [svc.submit(v, a) for v, a in short[:4]]
        with pytest.raises(ValueError, match="above the 32 frames"):
            svc.submit(long_v, long_a)
        futures += [svc.submit(v, a) for v, a in short[4:]]
        got = [f.result(timeout=300) for f in futures]
        ok = svc.submit(long_v[:32], long_a[:32]).result(timeout=300)   # bucket 32 fits
        stats = svc.stats()
    assert got == want
    assert isinstance(ok, str)
    assert stats["requests"] == 9 and 32 in stats["compiled_t_pads"]
    assert 48 not in stats["compiled_t_pads"]


def test_beam_wider_than_the_kernel_fails_construction(tiny, monkeypatch):
    _, _, params, model, vocab = tiny
    monkeypatch.setattr(CaptionService, "_kernel_width_limit", lambda self: 2)
    cfg = dict(SERVICE, mode="beam", beam_width=3)
    with pytest.raises(ValueError, match="at most 2"):
        CaptionService(model, from_numpy_tree(params), vocab, ServiceConfig(**cfg), device="cpu")
    with CaptionService(model, from_numpy_tree(params), vocab,
                        ServiceConfig(**dict(cfg, beam_width=2)), device="cpu") as svc:
        assert svc.max_frames is None                                 # no limit on the CPU


def _cli_service(tiny, tmp_path, monkeypatch, flags):
    """The service ``serve_captions.main(flags)`` builds (stopped before it
    serves)."""
    jmodel, jvocab, params, model, vocab = tiny
    jvocab.save(str(tmp_path / "vocab.json"))
    import mvc_tpu_torch.serving as serving
    import mvc_tpu_torch.training.checkpoint as checkpoint
    from mvc_tpu_torch.cli import serve_captions

    monkeypatch.setattr(checkpoint, "load_checkpoint", lambda path: {"params": params})
    built = []

    class Stop(Exception):
        pass

    def capture(service, **kw):
        built.append(service)
        raise Stop

    monkeypatch.setattr(serving, "make_http_server", capture)
    with pytest.raises(Stop):
        serve_captions.main(["--checkpoint", "any.ckpt", "--vocab", str(tmp_path / "vocab.json"),
                             "--no_warmup", "--device", "cpu"] + flags)
    (svc,) = built
    svc.close()
    return svc


def test_cli_beam_flags_reach_the_service(tiny, tmp_path, monkeypatch):
    """``--mode beam --beam_width --beam_alpha`` build a beam service."""
    svc = _cli_service(tiny, tmp_path, monkeypatch,
                       ["--mode", "beam", "--beam_width", "3", "--beam_alpha", "0.7"])
    assert (svc.config.mode, svc.config.beam_width, svc.config.beam_alpha) == ("beam", 3, 0.7)


@pytest.mark.parametrize("transfer", ["bf16", "int8"])
def test_cli_transfer_reaches_the_service(tiny, tmp_path, monkeypatch, transfer):
    """``--transfer`` picks the service's wire format."""
    svc = _cli_service(tiny, tmp_path, monkeypatch, ["--transfer", transfer])
    assert svc.config.transfer == transfer and svc.stats()["transfer"] == transfer


def test_package_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package, and
    imports as well with OpenCV hidden: only the decode functions import
    ``cv2``."""
    root = Path(__file__).resolve().parents[1]
    for hide_cv2 in (False, True):
        code = (
            "import importlib, pkgutil, sys\n"
            + ("sys.modules['cv2'] = None\n" if hide_cv2 else "")
            + "import mvc_tpu_torch\n"
            "import mvc_tpu_torch.ops.beam, mvc_tpu_torch.models.beam, mvc_tpu_torch.ops.greedy\n"
            "import mvc_tpu_torch.extract, mvc_tpu_torch.cli.extract_features\n"
            "import mvc_tpu_torch.models.transformer, mvc_tpu_torch.serving.router\n"
            "import mvc_tpu_torch.ops.quant\n"
            "import mvc_tpu_torch.cli.rehearse_real_data, mvc_tpu_torch.cli.build_vocab\n"
            "import mvc_tpu_torch.cli.build_wordnet_tables, mvc_tpu_torch.utils.torch_oracles\n"
            "import mvc_tpu_torch.evalcap._native\n"
            "import mvc_tpu_torch.parallel, mvc_tpu_torch.parallel.smoke\n"
            "import mvc_tpu_torch.ops.sharded, mvc_tpu_torch.cli.multihost_worker\n"
            "from mvc_tpu_torch.data import build_msvd_vocab, build_msr_vtt_vocab\n"
            "from mvc_tpu_torch.evalcap import COCOEvalCap, native_status\n"
            "for m in pkgutil.walk_packages(mvc_tpu_torch.__path__, 'mvc_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'mvc_tpu')"
            " or k.startswith('jax')]\n"
            "assert not bad, bad\n"
            "assert sys.modules.get('cv2') is None, 'a module imported cv2 at import time'\n"
            "print('ok', len([k for k in sys.modules if k.startswith('mvc_tpu_torch')]))\n"
        )
        out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, (hide_cv2, out.stderr)
        assert out.stdout.startswith("ok ")
