"""The port's model parts against the JAX package on the CPU, float32.

Inputs are made from a numpy seed and handed to both frameworks.  Tolerance
is atol=rtol=1e-5: the math is the same, the summation order is not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.models import attention as jattn
from mvc_tpu.models import decoder as jdec
from mvc_tpu.models import rnn as jrnn
from mvc_tpu.ops._gates import apply_gate_tile
from mvc_tpu_torch.config import DecoderConfig as TorchDecoderConfig
from mvc_tpu_torch.models import attention as tattn
from mvc_tpu_torch.models import decoder as tdec
from mvc_tpu_torch.models import rnn as trnn
from mvc_tpu_torch.ops._gates import apply_gates
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

TOL = dict(atol=1e-5, rtol=1e-5)
B, T, F, H, E, A, V = 4, 6, 12, 16, 8, 8, 23


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mask(masked):
    if not masked:
        return None
    m = np.ones((B, T), bool)
    m[1, 4:] = False
    m[3, :] = False          # an all-masked (batch padding) row
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_attend_matches_jax(masked):
    rng = np.random.default_rng(0)
    params = _np(jattn.init_attention(jax.random.PRNGKey(0), H, F, A))
    h = rng.normal(size=(B, H)).astype(np.float32)
    feats = rng.normal(size=(B, T, F)).astype(np.float32)
    mask = _mask(masked)
    jctx, jw = jattn.attend(jax.tree.map(jnp.asarray, params), jnp.asarray(h),
                            jnp.asarray(feats), mask=None if mask is None else jnp.asarray(mask))
    tctx, tw = tattn.attend(from_numpy_tree(params), _t(h), _t(feats),
                            mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    if masked:               # the all-masked row: exact zeros, no NaN
        assert (tw[3] == 0).all() and (tctx[3] == 0).all()


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rnn_step_matches_jax(cell):
    rng = np.random.default_rng(1)
    params = _np(jrnn.init_rnn(jax.random.PRNGKey(1), cell, F, H))
    x = rng.normal(size=(B, F)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    jstate = (jnp.asarray(h), jnp.asarray(c)) if cell == "LSTM" else jnp.asarray(h)
    tstate = (_t(h), _t(c)) if cell == "LSTM" else _t(h)
    step_j = jrnn.lstm_step if cell == "LSTM" else jrnn.gru_step
    step_t = trnn.lstm_step if cell == "LSTM" else trnn.gru_step
    jh, jnew = step_j(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jstate)
    th, tnew = step_t(from_numpy_tree(params), _t(x), tstate)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    if cell == "LSTM":
        np.testing.assert_allclose(tnew[1].numpy(), np.asarray(jnew[1]), **TOL)
    # the precomputed-preactivation form steps to the same state
    gi = _t(x) @ _t(params["wi"]) + _t(params["bi"])
    th_pre, _ = trnn.rnn_step_pre(from_numpy_tree(params), cell, gi, tstate)
    np.testing.assert_allclose(th_pre.numpy(), th.numpy(), **TOL)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_gate_twin_matches_jax_gate_tile(cell):
    """ops/_gates.apply_gates (the twin of csrc/gates.cuh) against the JAX
    kernels' shared gate tile, over the whole hidden width as one tile."""
    rng = np.random.default_rng(2)
    G = 4 if cell == "LSTM" else 3
    gv = rng.normal(size=(B, G * H)).astype(np.float32)
    gh = rng.normal(size=(B, G * H)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    i_parts, g_parts, c_parts, h_parts = [None], [None], [jnp.asarray(c)], [None]
    for gate in range(G):
        sl = slice(gate * H, (gate + 1) * H)
        apply_gate_tile(cell, gate, 0, jnp.asarray(gv[:, sl]), jnp.asarray(gh[:, sl]),
                        i_parts, g_parts, c_parts, h_parts, jnp.asarray(h), H)
    th, tc = apply_gates(cell, _t(gv), _t(gh), _t(h), _t(c) if cell == "LSTM" else None)
    np.testing.assert_allclose(th.numpy(), np.asarray(h_parts[0]), **TOL)
    if cell == "LSTM":
        np.testing.assert_allclose(tc.numpy(), np.asarray(c_parts[0]), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("factored", [False, True], ids=["direct", "factored"])
def test_decoder_step_matches_jax(cell, masked, factored):
    rng = np.random.default_rng(3)
    kw = dict(rnn_type=cell, in_feature_size=F, rnn_hidden_size=H, embedding_size=E,
              attn_size=A, output_size=V)
    jcfg, tcfg = DecoderConfig(**kw), TorchDecoderConfig(**kw)
    params = _np(jdec.init_decoder(jax.random.PRNGKey(5), jcfg))
    feats = rng.normal(size=(B, T, F)).astype(np.float32)
    prev = rng.integers(0, V, size=(B,)).astype(np.int32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    mask = _mask(masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)

    jp = jax.tree.map(jnp.asarray, params)
    jf = jnp.asarray(feats)
    jkeys = jattn.precompute_keys(jp["attention"], jf)
    jP = jf @ jp["rnn"]["wi"][E:] if factored else None
    jstate = (jnp.asarray(h), jnp.asarray(c)) if cell == "LSTM" else jnp.asarray(h)
    jlogp, jnew, jw = jdec.decoder_step(jp, jcfg, jnp.asarray(prev), jstate, jf, jkeys,
                                        jm, P=jP)

    tp = from_numpy_tree(params)
    tf = _t(feats)
    tkeys = tattn.precompute_keys(tp["attention"], tf)
    tP = tf @ tp["rnn"]["wi"][E:] if factored else None
    tstate = (_t(h), _t(c)) if cell == "LSTM" else _t(h)
    tlogp, tnew, tw = tdec.decoder_step(tp, tcfg, _t(prev).long(), tstate, tf, tkeys, tm, P=tP)

    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), **TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(trnn.state_hidden(cell, tnew).numpy(),
                               np.asarray(jrnn.state_hidden(cell, jnew)), **TOL)


def test_factored_P_follows_the_rule():
    """factored_P is taken exactly where _use_factored says (wide features
    at small B*T), in both packages."""
    from mvc_tpu.ops.pallas_beam import _use_factored as jax_rule
    from mvc_tpu_torch.ops._decode_common import _use_factored

    for bt in (1, 20, 137, 138, 1024, 4096):
        for f, h4 in ((2048, 2048), (128, 2048), (24, 64), (12, 128)):
            assert _use_factored(bt, f, h4) == jax_rule(bt, f, h4)
    cfg = TorchDecoderConfig(in_feature_size=F, rnn_hidden_size=H, embedding_size=E,
                             attn_size=A, output_size=V)
    params = tdec.init_decoder(torch.Generator().manual_seed(0), cfg)
    feats = torch.zeros((1, 2, F))
    assert tdec.factored_P(params, feats, torch.float32).shape == (1, 2, 4 * H)
    assert tdec.factored_P(params, torch.zeros((64, 64, F)), torch.float32) is None
