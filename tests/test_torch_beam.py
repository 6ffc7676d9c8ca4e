"""The port's beam search against the JAX package, exact tokens.

``decoder_beam_step`` and ``beam_search`` (the CPU path of
``predict_tokens(mode="beam")``) are held against their JAX twins, and the
plain version of the CUDA beam kernel (``beam_decode_reference``) against
the JAX Pallas kernel run in interpret mode and against the XLA scan, for
the same weights carried across by the bridge.  Widths are those of
tests/test_pallas.py's beam cases; the beam widths (1 to 8) and batch
sizes (4 and 7 clips: not whole groups of the CUDA kernel's three clips
per 15-row tile) cover the kernel's packings.  Tokens are compared exactly although
the summation order differs between the frameworks: the output projection
is scaled up so that no top-W decision sits on a near-tie (the tests also
check that the tokens vary).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import EOS_ID, DecoderConfig
from mvc_tpu.models import attention as jattn
from mvc_tpu.models import beam as jbeam
from mvc_tpu.models import decoder as jdec
from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
from mvc_tpu.models.captioning import _beam_init_state as jax_beam_init
from mvc_tpu.ops.pallas_beam import beam_decode_pallas
from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
from mvc_tpu_torch.models import attention as tattn
from mvc_tpu_torch.models import beam as tbeam
from mvc_tpu_torch.models import decoder as tdec
from mvc_tpu_torch.models.captioning import AVCaptioningDual, _beam_init_state
from mvc_tpu_torch.ops import _decode_common as _dc
from mvc_tpu_torch.ops.beam import TILES, _launch, beam_decode, beam_decode_reference
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

V = 29
V_DIM, A_DIM = 24, 12


def _cfg(cls, cell, feat, hidden=16, emb=8, attn=8):
    return cls(rnn_type=cell, in_feature_size=feat, rnn_hidden_size=hidden,
               embedding_size=emb, attn_size=attn, output_size=V)


def _decoder(cfg, key, eos_bias=0.0):
    """JAX init (numpy leaves) with the output projection scaled up 5x: the
    logits then spread far enough apart that no top-W decision sits on a
    near-tie, and depend enough on the state that the tokens vary."""
    p = jax.tree.map(np.array, jdec.init_decoder(jax.random.PRNGKey(key), cfg))
    p["out"]["w"] = p["out"]["w"] * 5.0
    p["out"]["b"][EOS_ID] += eos_bias
    return p


# name: (cells, B, T, L, W, alpha, masked, eos_bias); one cell = visual only.
# The eos-staggered cases move EOS just enough that the clips of one batch
# stop at different steps (some never); the wide cases push it down so the
# search does not end on a first-step EOS.
CASES = {
    "dual-lstm": (("LSTM", "LSTM"), 4, 6, 11, 4, 0.0, True, 0.0),
    "dual-lstm-alpha": (("LSTM", "LSTM"), 4, 6, 11, 4, 0.7, True, 0.0),
    "single-lstm": (("LSTM",), 3, 4, 9, 3, 0.0, True, 0.0),
    "single-gru": (("GRU",), 3, 5, 8, 3, 0.0, False, 0.0),
    "dual-gru-lstm-alpha": (("GRU", "LSTM"), 3, 5, 8, 3, 0.7, True, 0.0),
    "dual-w1": (("LSTM", "LSTM"), 4, 6, 9, 1, 0.0, True, 0.0),
    "eos-heavy": (("LSTM",), 4, 4, 20, 3, 0.7, False, 4.0),
    "dual-w8": (("LSTM", "LSTM"), 4, 6, 9, 8, 0.0, True, -3.0),
    "dual-b7": (("LSTM", "LSTM"), 7, 5, 9, 5, 0.7, True, -3.0),
    "eos-staggered": (("GRU", "LSTM"), 7, 5, 16, 5, 0.7, False, -0.5),
    "eos-staggered-w3": (("LSTM",), 7, 4, 20, 3, 0.7, False, 0.1),
}


def _case(name, seed=0):
    cells, B, T, L, W, alpha, masked, eos_bias = CASES[name]
    rng = np.random.default_rng(seed)
    dims = [(V_DIM, 16, 8), (A_DIM, 16, 10)][:len(cells)]
    cfgs = [_cfg(DecoderConfig, c, f, h, e) for c, (f, h, e) in zip(cells, dims)]
    tcfgs = [_cfg(TorchDecoderConfig, c, f, h, e) for c, (f, h, e) in zip(cells, dims)]
    params = [_decoder(c, 1 + d, eos_bias) for d, c in enumerate(cfgs)]
    feats = [rng.normal(size=(B, T, f)).astype(np.float32) for f, _, _ in dims]
    mask = None
    if masked:
        mask = np.ones((B, T), bool)
        mask[1, T - 2:] = False
        mask[-1, 2:] = False
    return dict(cells=cells, B=B, T=T, L=L, W=W, alpha=alpha, cfgs=cfgs, tcfgs=tcfgs,
                params=params, feats=feats, mask=mask, eos_bias=eos_bias)


def _jax_scan(c):
    """The JAX XLA beam: beam_search over summed decoder_beam_steps."""
    jp = [jax.tree.map(jnp.asarray, p) for p in c["params"]]
    jf = [jnp.asarray(f) for f in c["feats"]]
    jm = None if c["mask"] is None else jnp.asarray(c["mask"])
    keys = [jattn.precompute_keys(p["attention"], f) for p, f in zip(jp, jf)]

    def step_fn(prev, state):
        total, new = 0.0, []
        for p, cfg, s, f, k in zip(jp, c["cfgs"], state, jf, keys):
            lp, ns = jdec.decoder_beam_step(p, cfg, prev, s, f, k, jm, jnp.float32)
            total, new = total + lp, new + [ns]
        return total, tuple(new)

    init = tuple(jax_beam_init(cfg.rnn_type, c["B"], c["W"], cfg.rnn_hidden_size, jnp.float32)
                 for cfg in c["cfgs"])
    return np.asarray(jbeam.beam_search(step_fn, init, c["B"], V, max_caption_len=c["L"],
                                        beam_alpha=c["alpha"], beam_width=c["W"]))


def _torch_scan(c):
    """The port's beam_search over summed decoder_beam_steps."""
    tp = [from_numpy_tree(p) for p in c["params"]]
    tf = [torch.from_numpy(f) for f in c["feats"]]
    tm = None if c["mask"] is None else torch.from_numpy(c["mask"])
    keys = [tattn.precompute_keys(p["attention"], f) for p, f in zip(tp, tf)]

    def step_fn(prev, state):
        total, new = 0.0, []
        for p, cfg, s, f, k in zip(tp, c["tcfgs"], state, tf, keys):
            lp, ns = tdec.decoder_beam_step(p, cfg, prev, s, f, k, tm)
            total, new = total + lp, new + [ns]
        return total, tuple(new)

    init = tuple(_beam_init_state(cfg.rnn_type, c["B"], c["W"], cfg.rnn_hidden_size,
                                  torch.float32, "cpu") for cfg in c["tcfgs"])
    return tbeam.beam_search(step_fn, init, c["B"], V, max_caption_len=c["L"],
                             beam_alpha=c["alpha"], beam_width=c["W"]).numpy()


def _reference(c, **kw):
    return beam_decode_reference(
        [from_numpy_tree(p) for p in c["params"]], [torch.from_numpy(f) for f in c["feats"]],
        None if c["mask"] is None else torch.from_numpy(c["mask"]), max_caption_len=c["L"],
        beam_width=c["W"], beam_alpha=c["alpha"], rnn_types=c["cells"], **kw)


def _check_tokens(got, c):
    assert got.shape == (c["B"], c["L"] + 2) and got.dtype == np.int32
    assert (got[:, 0] == 1).all()                              # SOS
    # not one repeated token (an EOS-heavy search stops early on few tokens)
    assert len(np.unique(got[:, 1:])) > (1 if c["eos_bias"] > 0 else 2)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("factored", [False, True], ids=["direct", "factored"])
def test_decoder_beam_step_matches_jax(cell, masked, factored):
    rng = np.random.default_rng(3)
    B, W, T, F, H = 3, 4, 5, 12, 16
    jcfg, tcfg = _cfg(DecoderConfig, cell, F, H), _cfg(TorchDecoderConfig, cell, F, H)
    params = jax.tree.map(np.asarray, jdec.init_decoder(jax.random.PRNGKey(5), jcfg))
    feats = rng.normal(size=(B, T, F)).astype(np.float32)
    prev = rng.integers(0, V, size=(B, W)).astype(np.int32)
    h = rng.normal(size=(B, W, H)).astype(np.float32)
    cst = rng.normal(size=(B, W, H)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, T), bool)
        mask[1, 3:] = False
        mask[2, :] = False               # an all-masked (batch padding) clip
    jp, jf = jax.tree.map(jnp.asarray, params), jnp.asarray(feats)
    jkeys = jattn.precompute_keys(jp["attention"], jf)
    jP = jf @ jp["rnn"]["wi"][8:] if factored else None
    jstate = (jnp.asarray(h), jnp.asarray(cst)) if cell == "LSTM" else jnp.asarray(h)
    jlogp, jnew = jdec.decoder_beam_step(jp, jcfg, jnp.asarray(prev), jstate, jf, jkeys,
                                         None if mask is None else jnp.asarray(mask), P=jP)
    tp, tf = from_numpy_tree(params), torch.from_numpy(feats)
    tkeys = tattn.precompute_keys(tp["attention"], tf)
    tP = tf @ tp["rnn"]["wi"][8:] if factored else None
    t = torch.from_numpy
    tstate = (t(h), t(cst)) if cell == "LSTM" else t(h)
    tlogp, tnew = tdec.decoder_beam_step(tp, tcfg, t(prev).long(), tstate, tf, tkeys,
                                         None if mask is None else t(mask), P=tP)
    assert tlogp.shape == (B, W, V) and tlogp.dtype == torch.float32
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=1e-5, rtol=0)
    jh = jnew[0] if cell == "LSTM" else jnew
    th = tnew[0] if cell == "LSTM" else tnew
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["dual-lstm", "dual-lstm-alpha", "single-lstm", "single-gru",
                                  "dual-gru-lstm-alpha", "dual-w1", "dual-w8", "dual-b7"])
def test_beam_search_matches_jax(name):
    c = _case(name)
    want = _jax_scan(c)
    got = _torch_scan(c)
    _check_tokens(got, c)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["dual-lstm", "dual-lstm-alpha", "single-lstm",
                                  "dual-gru-lstm-alpha", "eos-heavy", "dual-w1", "dual-w8",
                                  "dual-b7", "eos-staggered", "eos-staggered-w3"])
def test_reference_matches_pallas_interpret_and_xla(name):
    c = _case(name)
    got = _reference(c).numpy()
    _check_tokens(got, c)
    np.testing.assert_array_equal(got, _jax_scan(c))
    pallas = np.asarray(beam_decode_pallas(
        [jax.tree.map(jnp.asarray, p) for p in c["params"]],
        [jnp.asarray(f) for f in c["feats"]],
        feat_mask=None if c["mask"] is None else jnp.asarray(c["mask"]),
        max_caption_len=c["L"], beam_width=c["W"], beam_alpha=c["alpha"],
        weight_dtype="float32", interpret=True, rnn_types=c["cells"]))
    np.testing.assert_array_equal(got, pallas)


def test_early_exit_steps():
    """EOS fires well before max length, the search stops early for every
    clip, and the steps counted per clip are those of the kernel's rule."""
    c = _case("eos-heavy")
    tokens, steps = _reference(c, return_steps=True)
    tokens, steps = tokens.numpy(), steps.numpy()
    assert (tokens[:, 1:] == EOS_ID).any(axis=1).all()
    first_eos = np.argmax(tokens[:, 1:] == EOS_ID, axis=1)
    assert (first_eos < c["L"] // 2).all()
    assert steps.shape == (c["B"],) and (steps < c["L"] + 1).all() and (steps > 1).all()
    # after the search stops, beam 0's history holds only zeros
    for row, s in zip(tokens, steps):
        assert (row[1 + s:] == 0).all()


@pytest.mark.parametrize("name", ["eos-staggered", "eos-staggered-w3"])
def test_per_clip_steps(name):
    """Clips of one batch stop at different steps, and each clip's count is
    its own: the count of the same clip searched alone (where the search
    ends with it), with the lone search's tokens and only zeros after the
    count, however long the other clips run."""
    c = _case(name)
    tokens, steps = (x.numpy() for x in _reference(c, return_steps=True))
    assert len(set(steps.tolist())) > 2 and steps.min() < c["L"] + 1
    for b in range(c["B"]):
        alone = dict(c, B=1, feats=[f[b:b + 1] for f in c["feats"]],
                     mask=None if c["mask"] is None else c["mask"][b:b + 1])
        tok_b, steps_b = _reference(alone, return_steps=True)
        assert steps[b] == int(steps_b[0])
        np.testing.assert_array_equal(tokens[b], tok_b[0].numpy())
        assert (tokens[b, 1 + steps[b]:] == 0).all()


@pytest.mark.parametrize("cells", [("LSTM", "LSTM"), ("GRU", "LSTM")], ids=["lstm-lstm", "gru-lstm"])
def test_predict_tokens_beam_matches_jax_model(cells):
    name = "dual-lstm-alpha" if cells[0] == "LSTM" else "dual-gru-lstm-alpha"
    c = _case(name, seed=1)
    vcfg, acfg = c["cfgs"]
    jmodel = JaxDual(vocab_size=V, visual_decoder_config=vcfg, audio_decoder_config=acfg)
    jparams = {"v_decoder": c["params"][0], "a_decoder": c["params"][1],
               "v_reconstructor": None, "a_reconstructor": None}
    vf, af = c["feats"]
    kw = dict(max_caption_len=c["L"], mode="beam", beam_alpha=c["alpha"], beam_width=c["W"])
    want = np.asarray(jmodel.predict_tokens(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(af), jnp.asarray(vf),
        feat_mask=jnp.asarray(c["mask"]), **kw))
    tv, ta = c["tcfgs"]
    model = AVCaptioningDual(vocab_size=V, visual_decoder_config=tv, audio_decoder_config=ta,
                             device="cpu")
    params = from_numpy_tree(jparams)
    got = model.predict_tokens(params, torch.from_numpy(af), torch.from_numpy(vf),
                               feat_mask=torch.from_numpy(c["mask"]), **kw).numpy()
    _check_tokens(got, c)
    np.testing.assert_array_equal(got, want)
    # the CPU wrapper call takes the plain version: no kernel launch is counted
    before = beam_decode.launches
    wrapped = beam_decode([params["v_decoder"], params["a_decoder"]],
                          [torch.from_numpy(vf), torch.from_numpy(af)],
                          torch.from_numpy(c["mask"]), max_caption_len=c["L"],
                          beam_width=c["W"], beam_alpha=c["alpha"], rnn_types=cells).numpy()
    np.testing.assert_array_equal(wrapped, want)
    assert beam_decode.launches == before == 0


def test_kernel_constants_match_the_wrappers():
    """The CUDA sources' shared-memory limit and row tiles are the ones the
    wrappers check against and name."""
    csrc = Path(_dc.__file__).resolve().parent.parent / "csrc"
    common = (csrc / "decode_common.cuh").read_text()
    beam_src = (csrc / "beam.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert const(common, "SMEM_LIMIT") == _dc.MAX_SMEM_BYTES
    assert (const(beam_src, "WIDE_ROWS"), const(common, "ROWS")) == TILES
    assert const(beam_src, "MAX_WIDTH") == 8


def test_beam_wrapper_rejects_what_it_cannot_take():
    c = _case("dual-lstm")
    params = [from_numpy_tree(p) for p in c["params"]]
    feats = [torch.from_numpy(f) for f in c["feats"]]
    with pytest.raises(ValueError):
        beam_decode(params * 2, feats * 2, rnn_types=("LSTM",) * 4)
    with pytest.raises(ValueError):
        beam_decode(params, feats, beam_width=0)
    with pytest.raises(ValueError):
        beam_decode(params, feats, beam_width=V + 1)
    with pytest.raises(ValueError):
        beam_decode(params, feats, weight_dtype=torch.float16)
    with pytest.raises(ValueError):
        beam_decode(params, [feats[0], feats[1][:, :2]])
    with pytest.raises(ValueError):
        beam_decode(params, feats, rnn_types=("GRU", "LSTM"))      # wi width is 4H
    with pytest.raises(ValueError):                                 # not one of TILES
        _launch(None, torch.float32, torch.device("cpu"), rows=12)
