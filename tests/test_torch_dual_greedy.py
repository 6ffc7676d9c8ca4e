"""The port's dual greedy decode against the JAX package, exact tokens.

The port's plain version of the CUDA kernel (``dual_greedy_decode_reference``)
and its CPU predict path are held against the JAX Pallas kernel run in
interpret mode (streaming and resident) and against the XLA scan
``dual_greedy_tokens_fused``, for the same weights carried across by the
bridge.  The dims are those of tests/test_pallas.py's dual case: at B*T=20
the visual decoder takes the factored branch and the audio one the direct
branch.  Tokens are compared exactly although the summation order differs
between the frameworks: these seeds leave no argmax decision near a tie, so
the vocab biases are left as drawn (the tests also check that the tokens
vary, so agreement is not one repeated token).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.models import decoder as jdec
from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
from mvc_tpu.models.captioning import dual_greedy_tokens_fused as jax_tokens_fused
from mvc_tpu.ops.pallas_dual_greedy import dual_greedy_decode_pallas
from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
from mvc_tpu_torch.models.captioning import AVCaptioningDual
from mvc_tpu_torch.models.captioning import dual_greedy_tokens_fused
from mvc_tpu_torch.ops._decode_common import _use_factored
from mvc_tpu_torch.ops.dual_greedy import dual_greedy_decode, dual_greedy_decode_reference
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

V = 29
B, T, L = 5, 4, 9
V_DIM, A_DIM = 24, 12


def _cfgs(cls, v_cell, a_cell):
    v = cls(rnn_type=v_cell, in_feature_size=V_DIM, rnn_hidden_size=16, embedding_size=8,
            attn_size=8, output_size=V)
    a = cls(rnn_type=a_cell, in_feature_size=A_DIM, rnn_hidden_size=32, embedding_size=10,
            attn_size=16, output_size=V)
    return v, a


def _case(v_cell, a_cell, seed=0):
    rng = np.random.default_rng(seed)
    vcfg, acfg = _cfgs(DecoderConfig, v_cell, a_cell)
    vp = jax.tree.map(np.array, jdec.init_decoder(jax.random.PRNGKey(3), vcfg))
    ap = jax.tree.map(np.array, jdec.init_decoder(jax.random.PRNGKey(4), acfg))
    vfeats = rng.normal(size=(B, T, V_DIM)).astype(np.float32)
    afeats = rng.normal(size=(B, T, A_DIM)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[2, 3:] = False
    mask[4, :] = False       # an all-masked (batch padding) row
    return vcfg, acfg, vp, ap, vfeats, afeats, mask


CELLS = [("LSTM", "LSTM"), ("GRU", "LSTM")]


def test_dims_cover_both_branches():
    assert _use_factored(B * T, V_DIM, 4 * 16)
    assert not _use_factored(B * T, A_DIM, 4 * 32)


@pytest.mark.parametrize("cells", CELLS, ids=["lstm-lstm", "gru-lstm"])
def test_reference_matches_pallas_interpret_and_xla(cells):
    vcfg, acfg, vp, ap, vfeats, afeats, mask = _case(*cells)
    jv, ja = jax.tree.map(jnp.asarray, vp), jax.tree.map(jnp.asarray, ap)
    xla = np.asarray(jax_tokens_fused(jv, ja, vcfg, acfg, jnp.asarray(vfeats),
                                      jnp.asarray(afeats), max_caption_len=L,
                                      feat_mask=jnp.asarray(mask)))
    got = dual_greedy_decode_reference(
        [from_numpy_tree(vp), from_numpy_tree(ap)],
        [torch.from_numpy(vfeats), torch.from_numpy(afeats)],
        torch.from_numpy(mask), max_caption_len=L, rnn_types=cells).numpy()
    assert got.shape == (B, L) and got.dtype == np.int32 and (got[:, 0] == 0).all()
    assert len(np.unique(got[:, 1:])) > 3
    np.testing.assert_array_equal(got, xla)
    for resident in (False, True):
        pallas = np.asarray(dual_greedy_decode_pallas(
            [jv, ja], [jnp.asarray(vfeats), jnp.asarray(afeats)],
            feat_mask=jnp.asarray(mask), max_caption_len=L, weight_dtype="float32",
            interpret=True, resident=resident, rnn_types=cells))
        np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("cells", CELLS, ids=["lstm-lstm", "gru-lstm"])
def test_predict_tokens_matches_jax_model(cells):
    vcfg, acfg, vp, ap, vfeats, afeats, mask = _case(*cells, seed=1)
    jmodel = JaxDual(vocab_size=V, visual_decoder_config=vcfg, audio_decoder_config=acfg)
    jparams = {"v_decoder": vp, "a_decoder": ap, "v_reconstructor": None,
               "a_reconstructor": None}
    want = np.asarray(jmodel.predict_tokens(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(afeats), jnp.asarray(vfeats),
        max_caption_len=L, feat_mask=jnp.asarray(mask)))

    tv, ta = _cfgs(TorchDecoderConfig, *cells)
    model = AVCaptioningDual(vocab_size=V, visual_decoder_config=tv, audio_decoder_config=ta,
                             device="cpu")
    params = from_numpy_tree(jparams)
    before = dual_greedy_decode.launches
    got = model.predict_tokens(params, torch.from_numpy(afeats), torch.from_numpy(vfeats),
                               max_caption_len=L, feat_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:, 1:])) > 3
    # the CPU wrapper call takes the plain version: no kernel launch is counted
    wrapped = dual_greedy_decode(
        [params["v_decoder"], params["a_decoder"]],
        [torch.from_numpy(vfeats), torch.from_numpy(afeats)], torch.from_numpy(mask),
        max_caption_len=L, rnn_types=cells).numpy()
    np.testing.assert_array_equal(wrapped, want)
    assert dual_greedy_decode.launches == before == 0


def test_stop_at_all_eos_keeps_caption_text():
    """The early exit only zeroes positions after every row's first EOS."""
    from mvc_tpu_torch.config import EOS_ID

    vcfg, acfg, vp, ap, vfeats, afeats, mask = _case("LSTM", "LSTM", seed=2)
    for p in (vp, ap):       # make EOS the likely pick so the exit triggers
        p["out"]["b"][EOS_ID] += 3.0
    tv, ta = _cfgs(TorchDecoderConfig, "LSTM", "LSTM")
    args = (from_numpy_tree(vp), from_numpy_tree(ap), tv, ta, torch.from_numpy(vfeats),
            torch.from_numpy(afeats), L, torch.from_numpy(mask))
    full = dual_greedy_tokens_fused(*args).numpy()
    early = dual_greedy_tokens_fused(*args, stop_at_all_eos=True).numpy()
    for f, e in zip(full, early):
        stop = list(f[1:]).index(EOS_ID) + 1 if EOS_ID in f[1:] else L
        np.testing.assert_array_equal(f[:stop + 1], e[:stop + 1])


def test_wrapper_rejects_what_the_kernel_cannot_take():
    vcfg, acfg, vp, ap, vfeats, afeats, mask = _case("LSTM", "LSTM")
    params = [from_numpy_tree(vp), from_numpy_tree(ap)]
    feats = [torch.from_numpy(vfeats), torch.from_numpy(afeats)]
    with pytest.raises(ValueError):
        dual_greedy_decode(params[:1], feats[:1])
    with pytest.raises(ValueError):
        dual_greedy_decode(params, feats, max_caption_len=1)
    with pytest.raises(ValueError):
        dual_greedy_decode(params, feats, weight_dtype=torch.float16)
    with pytest.raises(ValueError):
        dual_greedy_decode(params, [feats[0], feats[1][:, :2]])
    with pytest.raises(ValueError):
        dual_greedy_decode(params, feats, rnn_types=("GRU", "LSTM"))   # wi width is 4H


def test_stream_constants_and_layout_match_the_kernel():
    """The Python replica of the greedy kernels' weight stream and
    shared-memory layout (``_decode_common.stream_plan``, ``greedy_layout``)
    uses the constants ``csrc/greedy_common.cuh`` declares and lays out its
    regions in the source's order; at the serving widths every stage is
    one 16-byte-multiple bulk copy within a ring stage, the stages of a
    segment cover its rows, and both kernels take T >= 256."""
    import re
    from pathlib import Path

    from mvc_tpu_torch.ops import _decode_common as dc

    csrc = Path(dc.__file__).resolve().parent.parent / "csrc"
    src = (csrc / "greedy_common.cuh").read_text()
    common = (csrc / "decode_common.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))

    assert (const(src, "RB"), const(src, "STAGE_BYTES"), const(src, "CHUNK")) == (
        dc.STREAM_RB, dc.STAGE_BYTES, dc.CHUNK)
    assert (const(src, "MIN_STAGES"), const(src, "MAX_STAGES")) == (dc.MIN_STAGES, dc.MAX_STAGES)
    assert (const(src, "N_MARKS"), const(src, "TIMER_HEAD")) == (dc.N_MARKS, dc.TIMER_HEAD)
    assert (const(common, "CL"), const(common, "ROWS"), const(common, "NT")) == (
        dc.CL, dc.ROWS, 32 * dc.NWARPS)
    regions = re.findall(r"\bL\.(\w+)(?:\[d\])? = o[;+ ]", src)
    replica = dc.greedy_layout([dict(H=16, A=8, E=8, F=24, cell="GRU", factored=True)], 4, V)
    order = list(dict.fromkeys(re.sub(r"\d+$", "", k) for k in replica))
    assert regions == [k for k in order if k not in ("pv", "stages", "bytes")]

    vis = dict(H=512, A=256, E=300, F=2048, cell="LSTM", factored=True)
    aud = dict(H=512, A=256, E=300, F=128, cell="LSTM", factored=False)
    one = dict(vis, F=2176)
    for decs in ([vis, aud], [one], [dict(vis, cell="GRU"), aud]):
        for wb in (4, 2):
            for name, Kp, ncp, stages in dc.stream_plan(decs, 4000, wb):
                assert all(0 < b <= dc.STAGE_BYTES and b % 16 == 0 for b in stages), name
                assert sum(stages) == Kp * ncp * wb, name
        lay = dc.greedy_layout(decs, 16, 4000)
        assert lay["bytes"] <= dc.MAX_SMEM_BYTES and lay["stages"] >= 3
        assert dc.greedy_layout(decs, 256, 4000)["bytes"] <= dc.MAX_SMEM_BYTES
    dual_bytes = sum(sum(st) for *_, st in dc.stream_plan([vis, aud], 4000, 4))
    assert round(dual_bytes / 1e6, 2) == 4.00                       # per block and step
