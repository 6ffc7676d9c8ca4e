"""The port's multi-model router and its HTTP front end against the JAX
package's, on the CPU, plus the transformer and an int8-weight dual model
served by ``CaptionService``.

Same requests and weights as the JAX router's services (the tiny dual model
of tests/test_torch_serving.py, the same tree int8-quantized, and a tiny
transformer); every route must return the JAX route's captions exactly.
"""

import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mvc_tpu.config import DecoderConfig
from mvc_tpu.data import Vocabulary as JaxVocabulary
from mvc_tpu.models import AVCaptioningDual as JaxDual
from mvc_tpu.models.transformer import TransformerCaptioning as JaxTransformer
from mvc_tpu.models.transformer import TransformerConfig as JaxTConfig
from mvc_tpu.ops import quant as jquant
from mvc_tpu.serving import CaptionService as JaxService
from mvc_tpu.serving import ServiceConfig as JaxServiceConfig
from mvc_tpu.serving.router import CaptionRouter as JaxRouter
from mvc_tpu_torch.config import DecoderConfig as TDecoderConfig
from mvc_tpu_torch.config import TransformerConfig
from mvc_tpu_torch.data import Vocabulary
from mvc_tpu_torch.models import AVCaptioningDual, TransformerCaptioning
from mvc_tpu_torch.ops import _decode_common
from mvc_tpu_torch.ops import quant
from mvc_tpu_torch.serving import CaptionRouter, CaptionService, ServiceConfig, make_http_server
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

A_DIM, V_DIM = 8, 16
TINY_V = dict(rnn_type="LSTM", in_feature_size=V_DIM, rnn_hidden_size=12,
              embedding_size=8, attn_size=6, output_size=1)
TINY_A = dict(rnn_type="LSTM", in_feature_size=A_DIM, rnn_hidden_size=10,
              embedding_size=8, attn_size=6, output_size=1)
TINY_T = dict(d_model=16, num_heads=2, num_layers=1, d_ff=32, max_len=32, visual_dim=V_DIM,
              audio_dim=A_DIM)
SERVICE = dict(max_batch=4, max_wait_ms=100.0, frame_buckets=(4, 8), max_caption_len=6,
               audio_dim=A_DIM, visual_dim=V_DIM)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """{name: (JAX model, port model, numpy params)} and both vocabularies."""
    jvocab = JaxVocabulary(freq_threshold=1)
    jvocab.build_vocabulary(["a man plays a guitar", "a dog runs on grass",
                             "someone slices a tomato"])
    path = str(tmp_path_factory.mktemp("vocab") / "vocab.json")
    jvocab.save(path)
    n = len(jvocab)
    jdual = JaxDual(vocab_size=n, reconstructor_type="none",
                    visual_decoder_config=DecoderConfig(**TINY_V),
                    audio_decoder_config=DecoderConfig(**TINY_A))
    dual = AVCaptioningDual(vocab_size=n, device="cpu",
                            visual_decoder_config=TDecoderConfig(**TINY_V),
                            audio_decoder_config=TDecoderConfig(**TINY_A))
    dparams = jax.tree.map(np.asarray, jdual.init(jax.random.PRNGKey(0)))
    jtr = JaxTransformer(vocab_size=n, config=JaxTConfig(**TINY_T))
    tr = TransformerCaptioning(vocab_size=n, config=TransformerConfig(**TINY_T), device="cpu")
    tparams = jax.tree.map(np.asarray, jtr.init(jax.random.PRNGKey(1)))
    return {"dual": (jdual, dual, dparams), "transformer": (jtr, tr, tparams)}, \
        jvocab, Vocabulary.load(path)


def _requests(seed, n, t_lo=5, t_hi=8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(t_lo, t_hi + 1))
        out.append((rng.normal(size=(t, V_DIM)).astype(np.float32),
                    rng.normal(size=(t, A_DIM)).astype(np.float32)))
    return out


def _services(models, jax_side):
    """{"dual", "dual_int8", "transformer"} services of one package."""
    table, jvocab, vocab = models
    out = {}
    for name, key, int8 in (("dual", "dual", False), ("dual_int8", "dual", True),
                            ("transformer", "transformer", False)):
        jm, tm, params = table[key]
        if jax_side:
            p = jax.tree.map(jnp.asarray, params)
            out[name] = JaxService(jm, jquant.quantize_model_params(p) if int8 else p, jvocab,
                                   JaxServiceConfig(**SERVICE))
        else:
            p = from_numpy_tree(params)
            out[name] = CaptionService(tm, quant.quantize_model_params(p) if int8 else p, vocab,
                                       ServiceConfig(**SERVICE), device="cpu")
    return out


def test_router_routes_as_the_jax_router(models):
    """Each route's captions equal the JAX router's; no model = the default;
    an unknown model raises KeyError; stats, reset, warmup per model."""
    reqs = _requests(0, 4)
    names = ("dual", "dual_int8", "transformer", None)
    with JaxRouter(_services(models, True), default="dual") as jr:
        want = {n: [jr.caption(v, a, model=n, timeout=300) for v, a in reqs] for n in names}
    with CaptionRouter(_services(models, False), default="dual") as router:
        got = {n: [router.caption(v, a, model=n, timeout=300) for v, a in reqs] for n in names}
        with pytest.raises(KeyError, match="unknown model 'nope'"):
            router.submit(reqs[0][0], model="nope")
        stats = router.stats()
        assert stats["default"] == "dual" and set(stats["models"]) == {
            "dual", "dual_int8", "transformer"}
        assert stats["models"]["dual"]["requests"] == 8        # its own and the default's
        assert router.warmup([5]) == {"dual": [8], "dual_int8": [8], "transformer": [8]}
        router.reset_stats()
        assert all(s["requests"] == 0 for s in router.stats()["models"].values())
    assert got == want
    assert got[None] == got["dual"] and got["transformer"] != got["dual"]
    assert all(svc._closed for svc in router.services.values())
    with pytest.raises(ValueError):
        CaptionRouter({})
    with pytest.raises(ValueError):
        CaptionRouter({"a": object()}, default="b")


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(target):
    server = make_http_server(target, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, thread, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_http_model_field_routes_and_unknown_models_get_404(models):
    reqs = _requests(1, 3)
    with CaptionRouter(_services(models, False), default="dual") as router:
        want = {n: [router.caption(v, a, model=n, timeout=120) for v, a in reqs]
                for n in ("dual", "transformer")}
        server, thread, base = _serve(router)
        try:
            v, a = reqs[0]
            body = {"visual": v.tolist(), "audio": a.tolist()}
            assert _post(base, "/caption", dict(body, model="transformer"))[1]["caption"] == \
                want["transformer"][0]
            assert _post(base, "/caption", body)[1]["caption"] == want["dual"][0]
            code, err = _post(base, "/caption", dict(body, model="nope"))
            assert code == 404 and "nope" in err["error"]
            items = [{"visual": v.tolist(), "audio": a.tolist()} for v, a in reqs]
            code, out = _post(base, "/caption_batch", {"items": items, "model": "transformer"})
            assert code == 200 and out["captions"] == want["transformer"]
            with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                assert set(json.loads(r.read())["models"]) == {"dual", "dual_int8",
                                                               "transformer"}
        finally:
            _stop(server, thread)
    # a single service still refuses the field
    _, dual, params = models[0]["dual"]
    with CaptionService(dual, from_numpy_tree(params), models[2], ServiceConfig(**SERVICE),
                        device="cpu") as svc:
        server, thread, base = _serve(svc)
        try:
            v, a = reqs[0]
            code, err = _post(base, "/caption", {"visual": v.tolist(), "model": "dual"})
            assert code == 400 and "single model" in err["error"]
        finally:
            _stop(server, thread)


@pytest.mark.parametrize("mode", ["direct", "beam"])
def test_transformer_service_matches_jax_service(models, mode):
    """The transformer has no all-EOS switch: the service detects it and
    passes none, as the JAX service does; captions equal the JAX service's."""
    jm, tm, params = models[0]["transformer"]
    cfg = dict(SERVICE, mode=mode, beam_width=3)
    reqs = _requests(2, 5, t_lo=3, t_hi=8)
    with JaxService(jm, jax.tree.map(jnp.asarray, params), models[1],
                    JaxServiceConfig(**cfg)) as svc:
        want = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
    with CaptionService(tm, from_numpy_tree(params), models[2], ServiceConfig(**cfg),
                        device="cpu") as svc:
        assert svc._predict_extra == {}
        got = [f.result(timeout=300) for f in [svc.submit(v, a) for v, a in reqs]]
        assert svc.stats()["requests"] == 5
    assert got == want and len(set(got)) > 1


def test_launch_counts_are_exact_under_concurrent_workers():
    """Several services' workers count launches of one kernel at once: the
    count loses no update (the kernels' wrappers count through this)."""
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                _decode_common.count_launch(wrapper)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000
