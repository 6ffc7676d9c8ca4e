"""The port's single-decoder greedy decode against the JAX package, exact tokens.

The plain version of the CUDA kernel ``greedy.cu`` (``greedy_decode_reference``)
is held against the JAX Pallas kernel ``greedy_decode_pallas`` run in
interpret mode (streaming and resident) and against the XLA scan
``decode_greedy_tokens``; the port's ``decode_greedy_tokens`` and
``AVCaptioning.predict_tokens`` (direct and beam, the CPU paths) against
their JAX twins, for the same weights carried across by the bridge.  Two
small decoders cover both branches at B*T=20: F=24/H=16 is factored,
F=12/H=32 direct.  Tokens are compared exactly although the summation order
differs between the frameworks: the output projection is scaled up so that
no argmax or top-W decision sits on a near-tie (the tests also check that
the tokens vary, so agreement is not one repeated token).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import EOS_ID, DecoderConfig
from mvc_tpu.models import decoder as jdec
from mvc_tpu.models.captioning import AVCaptioning as JaxAVCaptioning
from mvc_tpu.ops.pallas_decode import greedy_decode_pallas
from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
from mvc_tpu_torch.models import decoder as tdec
from mvc_tpu_torch.models.captioning import AVCaptioning
from mvc_tpu_torch.ops._decode_common import _use_factored
from mvc_tpu_torch.ops.greedy import greedy_decode, greedy_decode_reference
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

V = 29
B, T, L = 5, 4, 9
# branch: (F, H, E, A); the single model's F splits into audio F_A + visual
BRANCHES = {"factored": (24, 16, 8, 8), "direct": (12, 32, 10, 16)}
F_A = 4
CASES = [(b, c) for b in BRANCHES for c in ("LSTM", "GRU")]
IDS = [f"{b}-{c.lower()}" for b, c in CASES]


def _cfg(cls, branch, cell):
    F, H, E, A = BRANCHES[branch]
    return cls(rnn_type=cell, in_feature_size=F, rnn_hidden_size=H, embedding_size=E,
               attn_size=A, output_size=V)


def _case(branch, cell, seed=0, eos_bias=0.0):
    """JAX init (numpy leaves) with the output projection scaled up 5x, the
    features and a mask with one partly masked and one all-masked row."""
    rng = np.random.default_rng(seed)
    cfg = _cfg(DecoderConfig, branch, cell)
    p = jax.tree.map(np.array, jdec.init_decoder(jax.random.PRNGKey(7 + seed), cfg))
    p["out"]["w"] = p["out"]["w"] * 5.0
    p["out"]["b"][EOS_ID] += eos_bias
    feats = rng.normal(size=(B, T, cfg.in_feature_size)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[2, 3:] = False
    mask[4, :] = False       # an all-masked (batch padding) row
    return cfg, p, feats, mask


def _check_tokens(got):
    assert got.shape == (B, L) and got.dtype == np.int32 and (got[:, 0] == 0).all()
    assert len(np.unique(got[:, 1:])) > 3


def test_dims_cover_both_branches():
    for cell, G in (("LSTM", 4), ("GRU", 3)):
        F, H, _, _ = BRANCHES["factored"]
        assert _use_factored(B * T, F, G * H)
        F, H, _, _ = BRANCHES["direct"]
        assert not _use_factored(B * T, F, G * H)


@pytest.mark.parametrize("branch,cell", CASES, ids=IDS)
def test_reference_matches_pallas_interpret_and_xla(branch, cell):
    cfg, p, feats, mask = _case(branch, cell)
    jp = jax.tree.map(jnp.asarray, p)
    xla = np.asarray(jdec.decode_greedy_tokens(jp, cfg, jnp.asarray(feats), max_caption_len=L,
                                               feat_mask=jnp.asarray(mask)))
    got = greedy_decode_reference(from_numpy_tree(p), torch.from_numpy(feats),
                                  torch.from_numpy(mask), max_caption_len=L,
                                  rnn_type=cell).numpy()
    _check_tokens(got)
    np.testing.assert_array_equal(got, xla)
    for resident in (False, True):
        pallas = np.asarray(greedy_decode_pallas(
            jp, jnp.asarray(feats), feat_mask=jnp.asarray(mask), max_caption_len=L,
            weight_dtype="float32", interpret=True, rnn_type=cell, resident=resident))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("stop", [False, True], ids=["fixed", "stop-at-all-eos"])
@pytest.mark.parametrize("branch,cell", CASES, ids=IDS)
def test_decode_greedy_tokens_matches_jax(branch, cell, stop):
    """The CPU path of direct mode, with and without the all-EOS early exit
    (EOS lifted so that it fires)."""
    from mvc_tpu_torch.config import EOS_ID as PORT_EOS

    cfg, p, feats, mask = _case(branch, cell, seed=1, eos_bias=2.0 if stop else 0.0)
    want = np.asarray(jdec.decode_greedy_tokens(
        jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(feats), max_caption_len=L,
        feat_mask=jnp.asarray(mask), stop_at_all_eos=stop))
    got = tdec.decode_greedy_tokens(from_numpy_tree(p), _cfg(TorchDecoderConfig, branch, cell),
                                    torch.from_numpy(feats), max_caption_len=L,
                                    feat_mask=torch.from_numpy(mask),
                                    stop_at_all_eos=stop).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and (got[:, 0] == 0).all()
    assert len(np.unique(got[:, 1:])) > (1 if stop else 3)
    if stop:
        # the exit fired, and only positions after each row's first EOS differ
        assert (got[:, 1:] == PORT_EOS).any(axis=1).all() and (got[:, -1] == 0).all()
        full = greedy_decode_reference(from_numpy_tree(p), torch.from_numpy(feats),
                                       torch.from_numpy(mask), max_caption_len=L,
                                       rnn_type=cell).numpy()
        for f, e in zip(full, got):
            first = list(f[1:]).index(PORT_EOS) + 1
            np.testing.assert_array_equal(f[:first + 1], e[:first + 1])


def _models(branch, cell):
    F = BRANCHES[branch][0]
    jcfg, tcfg = _cfg(DecoderConfig, branch, cell), _cfg(TorchDecoderConfig, branch, cell)
    assert jcfg.in_feature_size == F
    return (JaxAVCaptioning(vocab_size=V, decoder_config=jcfg),
            AVCaptioning(vocab_size=V, decoder_config=tcfg, device="cpu"))


@pytest.mark.parametrize("mode", ["direct", "beam"])
@pytest.mark.parametrize("branch,cell", CASES, ids=IDS)
def test_predict_tokens_matches_jax_model(branch, cell, mode):
    """``AVCaptioning(device="cpu").predict_tokens`` against the JAX model's
    XLA path: the [audio | visual] concatenation, then greedy or beam."""
    _, p, feats, mask = _case(branch, cell, seed=2)
    audio, visual = feats[..., :F_A], feats[..., F_A:]
    jmodel, model = _models(branch, cell)
    jparams = {"decoder": p, "reconstructor": None}
    kw = dict(max_caption_len=L, mode=mode, beam_width=3, beam_alpha=0.7)
    want = np.asarray(jmodel.predict_tokens(jax.tree.map(jnp.asarray, jparams),
                                            jnp.asarray(audio), jnp.asarray(visual),
                                            feat_mask=jnp.asarray(mask), **kw))
    params = from_numpy_tree(jparams)
    got = model.predict_tokens(params, torch.from_numpy(audio), torch.from_numpy(visual),
                               feat_mask=torch.from_numpy(mask), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (B, L if mode == "direct" else L + 2) and got.dtype == np.int32
    assert len(np.unique(got[:, 1:])) > 2
    if mode == "direct":
        # the kernel's plain version agrees on the concatenated features
        ref = greedy_decode_reference(params["decoder"], torch.from_numpy(feats),
                                      torch.from_numpy(mask), max_caption_len=L,
                                      rnn_type=cell).numpy()
        np.testing.assert_array_equal(ref, want)


def test_cpu_wrapper_takes_the_plain_version():
    """``greedy_decode`` on CPU tensors is the plain version; no launch is
    counted."""
    _, p, feats, mask = _case("factored", "LSTM", seed=3)
    params, f, m = from_numpy_tree(p), torch.from_numpy(feats), torch.from_numpy(mask)
    before = greedy_decode.launches
    for wd in (torch.float32, torch.bfloat16):
        got = greedy_decode(params, f, m, max_caption_len=L, weight_dtype=wd)
        want = greedy_decode_reference(params, f, m, max_caption_len=L, weight_dtype=wd)
        assert torch.equal(got, want)
    assert greedy_decode.launches == before == 0


def test_model_predict_returns_strings():
    from mvc_tpu_torch.data import Vocabulary

    vocab = Vocabulary(freq_threshold=1)
    for i in range(len(vocab), V):
        vocab.itos[i] = f"w{i}"
    _, p, feats, mask = _case("factored", "LSTM", seed=4)
    _, model = _models("factored", "LSTM")
    caps = model.predict(from_numpy_tree({"decoder": p, "reconstructor": None}), vocab,
                         torch.from_numpy(feats[..., :F_A]), torch.from_numpy(feats[..., F_A:]),
                         max_caption_len=L, feat_mask=torch.from_numpy(mask))
    assert len(caps) == B and all(isinstance(c, str) for c in caps)
    # the single model's reconstructor is ported: it is drawn, sized H -> F
    params = AVCaptioning(vocab_size=V, reconstructor_type="global", device="cpu").init(
        torch.Generator().manual_seed(0))
    assert params["reconstructor"]["rnn"]["wh"].shape == (2176, 4 * 2176)
    with pytest.raises(ValueError):
        AVCaptioning(vocab_size=V, reconstructor_type="both", device="cpu")


def test_wrapper_rejects_what_the_kernel_cannot_take():
    _, p, feats, mask = _case("factored", "LSTM")
    params, f = from_numpy_tree(p), torch.from_numpy(feats)
    with pytest.raises(ValueError):
        greedy_decode([params, params], f)                          # two decoders
    with pytest.raises(ValueError):
        greedy_decode(params, f, max_caption_len=1)
    with pytest.raises(ValueError):
        greedy_decode(params, f, weight_dtype=torch.float16)
    with pytest.raises(ValueError):
        greedy_decode(params, f[:, :, :-1])                         # F does not match wi
    with pytest.raises(ValueError):
        greedy_decode(params, f, torch.from_numpy(mask)[:, :2])     # mask shape
    with pytest.raises(ValueError):
        greedy_decode(params, f, rnn_type="GRU")                    # wi width is 4H
    with pytest.raises(ValueError):
        greedy_decode(params, f, rnn_type="RNN")


def _unpack(packed, cols, K, N):
    """The [K, N] matrix whose columns a repacked stream operand holds:
    each of ``cols``' valid entries once, padding columns and rows zero."""
    vals = packed[..., :K, :].movedim(-2, 0).reshape(K, -1)
    flat = cols.reshape(-1)
    valid = flat >= 0
    assert sorted(flat[valid].tolist()) == list(range(N))           # a permutation
    assert not vals[:, ~valid].any() and not packed[..., K:, :].any()
    out = torch.zeros((K, N), dtype=packed.dtype)
    out[:, flat[valid]] = vals[:, valid]
    return out


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("vocab", [V, 8 * 1025 + 3, 8 * 500],
                         ids=["v29", "v8203-three-chunks", "v4000-strided-view"])
@pytest.mark.parametrize("branch,cell", CASES, ids=IDS)
def test_stream_repack_is_a_permutation(branch, cell, vocab, wd):
    """The greedy kernels' weight stream (``stream_operands``): each rank's
    slices, unpacked, give back attn_W, wi's step-input rows, wh and wout
    exactly, and the bias block the biases, for a V that CL does not
    divide (29), one whose vocab slice takes three chunks, and one taken
    as a strided view (CL divides every width: H, A and V = 4000)."""
    from mvc_tpu_torch.ops import _decode_common as dc

    _, p, feats, _ = _case(branch, cell)
    (prep,) = dc._prepare([from_numpy_tree(p)], [torch.from_numpy(feats)], wd, (cell,))
    assert prep["factored"] == (branch == "factored")
    H, A, E, F = prep["H"], prep["A"], prep["E"], prep["F"]
    g = torch.Generator().manual_seed(1)
    prep["wout"] = torch.randn(H, vocab, generator=g).to(wd)
    prep["b_out"] = torch.randn(vocab, generator=g)
    dims = (H, A, E, F, cell, prep["factored"], vocab)
    s = dc.stream_dims(*dims)
    st = dc.stream_operands(prep, vocab)
    qc, gc, vc = dc.query_columns(*dims), dc.gate_columns(*dims), dc.vocab_columns(*dims)
    Kx = E if prep["factored"] else E + F
    assert st["q"].shape == (dc.CL, s["Hp"], s["ncq"]) and st["wi"].shape == (dc.CL, s["Kxp"], s["ncg"])
    assert st["wout"].shape == (dc.CL, s["nch"], s["Hp"], s["cw"])
    assert s["nch"] == (3 if vocab == 8 * 1025 + 3 else 1)
    assert all(t.dtype == wd and t.is_contiguous() for k, t in st.items() if k != "bias")
    assert torch.equal(_unpack(st["q"], qc, H, A), prep["attn_W"])
    assert torch.equal(_unpack(st["wi"], gc, Kx, s["G"] * H), prep["wi"][:Kx])
    assert torch.equal(_unpack(st["wh"], gc, H, s["G"] * H), prep["wh"])
    assert torch.equal(_unpack(st["wout"], vc, H, vocab), prep["wout"])
    bias = st["bias"]
    assert bias.shape == (dc.CL, s["nb"]) and bias.dtype == torch.float32
    o = 0
    for name, cols in (("b_out", vc.reshape(dc.CL, -1)), ("b_gates", gc), ("b_h", gc)):
        n = cols.shape[1]
        assert torch.equal(_unpack(bias[:, None, o:o + n], cols, 1, prep[name].shape[0])[0],
                           prep[name])
        o += n
    for name in ("attn_b", "w_row"):                                # whole, in every slice
        assert torch.equal(bias[:, o:o + A], prep[name].expand(dc.CL, -1))
        assert not bias[:, o + A:o + s["Ap"]].any()
        o += s["Ap"]
