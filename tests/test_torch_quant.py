"""int8 weight-only decode in the port (``mvc_tpu_torch/ops/quant.py``)
against the JAX package's ``mvc_tpu/ops/quant.py`` on the CPU.

The quantizer is held bit for bit (payload and scales, a zero column and
exact half-way values included); the dequantized matrices bit for bit in
float32 and bf16.  Decode tokens of quantized trees are compared exactly
with the JAX model's on the same quantized tree (its XLA path: the JAX
kernels skip quantized trees), at small widths with the vocab biases
spread (a seeded permutation x 2e-3) so no argmax or top-W pick is a
near-tie: dual direct, dual beam, single direct and single beam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.models import AVCaptioning as JaxSingle
from mvc_tpu.models import AVCaptioningDual as JaxDual
from mvc_tpu.models.decoder import cast_params_for_decode as jax_cast
from mvc_tpu.ops import quant as jquant
from mvc_tpu_torch.config import DecoderConfig as TDecoderConfig
from mvc_tpu_torch.models import AVCaptioning, AVCaptioningDual
from mvc_tpu_torch.models import captioning as tcaptioning
from mvc_tpu_torch.models.decoder import cast_params_for_decode
from mvc_tpu_torch.ops import quant
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree, to_numpy_tree

V, B, T, L = 41, 4, 5, 8
SMALL = dict(rnn_hidden_size=32, embedding_size=16, attn_size=8)
FV, FA = 24, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _spread(params, names):
    perm = np.random.default_rng(1).permutation(V).astype(np.float32) * np.float32(2e-3)
    for n in names:
        params[n]["out"]["b"] = params[n]["out"]["b"] + perm
    return params


def _dual():
    jm = JaxDual(vocab_size=V, reconstructor_type="none",
                 visual_decoder_config=DecoderConfig(in_feature_size=FV, **SMALL),
                 audio_decoder_config=DecoderConfig(in_feature_size=FA, **SMALL))
    tm = AVCaptioningDual(vocab_size=V, device="cpu",
                          visual_decoder_config=TDecoderConfig(in_feature_size=FV, **SMALL),
                          audio_decoder_config=TDecoderConfig(in_feature_size=FA, **SMALL))
    params = _spread(_np(jm.init(jax.random.PRNGKey(0))), ("v_decoder", "a_decoder"))
    return jm, tm, params


def _single():
    cfg = dict(in_feature_size=FA + FV, **SMALL)
    jm = JaxSingle(vocab_size=V, reconstructor_type="none", decoder_config=DecoderConfig(**cfg))
    tm = AVCaptioning(vocab_size=V, device="cpu", decoder_config=TDecoderConfig(**cfg))
    params = _spread(_np(jm.init(jax.random.PRNGKey(2))), ("decoder",))
    return jm, tm, params


def _feats(seed):
    rng = np.random.default_rng(seed)
    visual = rng.normal(size=(B, T, FV)).astype(np.float32)
    audio = rng.normal(size=(B, T, FA)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[1, 3:] = False
    return visual, audio, mask


def test_quantize_weight_is_the_jax_quantizer_bit_for_bit():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 48)) * rng.uniform(0.1, 10, size=(1, 48))).astype(np.float32)
    w[:, 5] = 0.0                                   # zero column: scale 1
    # a column of amax 127 has scale 1, so these sit exactly half-way
    w[:6, 7] = [0.5, 1.5, 2.5, -0.5, -3.5, 127.0]
    w[6:, 7] = 0.25
    got, want = quant.quantize_weight(torch.from_numpy(w)), jquant.quantize_weight(w)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["s"][0, 5] == 1.0 and got["q"][:5, 7].tolist() == [0, 2, 2, 0, -4]
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        back = quant.wmat(got, tdt)
        assert back.dtype == tdt
        np.testing.assert_array_equal(back.float().numpy(),
                                      np.asarray(jquant.wmat(want, jdt)).astype(np.float32))
    np.testing.assert_array_equal(quant.wmat(torch.from_numpy(w), torch.float32).numpy(), w)


@pytest.mark.parametrize("which", ["dual", "single"])
def test_quantize_model_params_matches_jax_and_keeps_int8_under_casts(which):
    """The same leaves quantized (rnn.wi, rnn.wh, out.w), every other leaf
    shared; a bf16 cast and the dequantize keep the JAX bits."""
    _, _, params = _dual() if which == "dual" else _single()
    got = quant.quantize_model_params(from_numpy_tree(params))
    want = jquant.quantize_model_params(jax.tree.map(jnp.asarray, params))
    names = ("v_decoder", "a_decoder") if which == "dual" else ("decoder",)
    for n in names:
        assert quant.is_quantized_decoder(got[n]) and jquant.is_quantized_decoder(want[n])
        assert not quant.is_quantized(got[n]["attention"]["W"])
        for got_leaf, want_leaf in zip(jax.tree.leaves(to_numpy_tree(got[n])),
                                       jax.tree.leaves(_np(want[n]))):
            np.testing.assert_array_equal(got_leaf, want_leaf)
        cast = cast_params_for_decode(got[n], torch.bfloat16)
        jcast = jax_cast(want[n], jnp.bfloat16)
        assert cast["rnn"]["wi"]["q"].dtype == torch.int8
        assert cast["rnn"]["wi"]["s"].dtype == torch.float32
        assert cast["rnn"]["bi"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            quant.dequantize_tree(cast, torch.bfloat16)["out"]["w"].float().numpy(),
            np.asarray(jquant.wmat(jcast["out"]["w"], jnp.bfloat16)).astype(np.float32))
    assert not quant.is_quantized_decoder(params[names[0]])


@pytest.mark.parametrize("mode,width", [("direct", 5), ("beam", 3)])
@pytest.mark.parametrize("which", ["dual", "single"])
def test_int8_tokens_equal_the_jax_int8_tokens(which, mode, width):
    jm, tm, params = _dual() if which == "dual" else _single()
    visual, audio, mask = _feats(3)
    jq = jquant.quantize_model_params(jax.tree.map(jnp.asarray, params))
    tq = quant.quantize_model_params(from_numpy_tree(params))
    kw = dict(max_caption_len=L, mode=mode, beam_width=width, beam_alpha=0.7)
    want = np.asarray(jm.predict_tokens(jq, jnp.asarray(audio), jnp.asarray(visual),
                                        feat_mask=jnp.asarray(mask), **kw))
    got = tm.predict_tokens(tq, torch.from_numpy(audio), torch.from_numpy(visual),
                            feat_mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) > 1
    # the int8 route is the dequantized tree through the usual plain path
    deq = {k: quant.dequantize_tree(v, torch.float32) for k, v in tq.items()}
    again = tm.predict_tokens(deq, torch.from_numpy(audio), torch.from_numpy(visual),
                              feat_mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_array_equal(got, again)


def test_max_frames_reads_the_widths_of_a_quantized_tree(monkeypatch):
    """The kernels' limits take the same widths from a quantized tree as
    from the float one (their shared-memory query reads shapes only)."""
    _, tm, params = _dual()
    _, sm, sparams = _single()
    seen = []

    def record(decoders, *a):
        seen.append([tuple(d["rnn"]["wi"].shape) for d in decoders])
        return 7

    monkeypatch.setattr(tcaptioning, "dual_greedy_max_frames", record)
    monkeypatch.setattr(tcaptioning, "beam_max_frames", record)
    monkeypatch.setattr(tcaptioning, "greedy_max_frames",
                        lambda d, *a: record([d]))
    tp = from_numpy_tree(params)
    sp = from_numpy_tree(sparams)
    for model, p in ((tm, tp), (sm, sp)):
        for mode in ("direct", "beam"):
            assert model.max_frames(p, 64, mode) == 7
            assert model.max_frames(quant.quantize_model_params(p), 64, mode) == 7
    assert seen[0::2] == seen[1::2] and len(seen) == 8
