"""The port's caption service against the JAX service, on the CPU.

Same requests, same weights (the ``tiny`` model of tests/test_serving.py,
carried across by the bridge): the two services must return the same
captions.  Its random init leaves no near-tied argmax on these requests, so
the vocab biases are left as drawn.
Also: the HTTP front end, the card-by-default rule, and the package's
independence from JAX.
"""

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


def test_wire_formats_reach_the_model_as_the_jax_service_sends_them(tiny):
    """What ``predict_tokens`` receives: bf16 features rounded as ml_dtypes
    rounds them, and int8 features dequantized to float32 bit for bit as
    the JAX service's jitted dequantize gives them."""
    import jax.numpy as jnp

    from mvc_tpu.data.feature_cache import quantize_int8 as jax_quantize

    _, _, params, model, vocab = tiny
    x = np.random.default_rng(6).normal(size=(4, 8, V_DIM)).astype(np.float32) * 3
    x[1, 2] = 0.0                                   # an all-zero frame: scale 1.0
    with CaptionService(model, from_numpy_tree(params), vocab,
                        ServiceConfig(**dict(SERVICE, transfer="bf16")), device="cpu") as svc:
        got = svc._to_device(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.bfloat16)).astype(np.float32))
    with CaptionService(model, from_numpy_tree(params), vocab,
                        ServiceConfig(**dict(SERVICE, transfer="int8")), device="cpu") as svc:
        got = svc._to_device(x)
    q, scale = jax_quantize(x)
    want = jax.jit(lambda q, s: q.astype(jnp.float32) * s)(q, scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
            "from mvc_tpu_torch.evalcap import COCOEvalCap\n"
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
