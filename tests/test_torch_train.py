"""The port's training path against the JAX package on the CPU, float32.

The same numpy-seeded inputs and the same weights (JAX ``init`` -> numpy ->
``from_numpy_tree``) go through each JAX function and its port.  Values
and gradients are held to rtol 1e-5 (the math is the same, the float order
of the hoisted GEMMs and the online log-sum-exp merge is not); the train
step's gradients to rtol 1e-4, atol 1e-6; the two-epoch trajectory to
1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
from mvc_tpu.models import reconstructor as jrec
from mvc_tpu.models import rnn as jrnn
from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
from mvc_tpu.training import fused_loss as jfused
from mvc_tpu.training import losses as jlosses
from mvc_tpu.training import optimizer as jopt
from mvc_tpu_torch.config import DecoderConfig as TDecoderConfig
from mvc_tpu_torch.config import ReconstructorConfig as TRecConfig
from mvc_tpu_torch.config import TrainerConfig
from mvc_tpu_torch.models import AVCaptioningDual
from mvc_tpu_torch.models import reconstructor as trec
from mvc_tpu_torch.models import rnn as trnn
from mvc_tpu_torch.training import fused_loss as tfused
from mvc_tpu_torch.training import losses as tlosses
from mvc_tpu_torch.training import optimizer as topt
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree, to_numpy_tree

TOL = dict(rtol=1e-5, atol=1e-6)
B, T, L, H, E, A, V = 4, 5, 7, 32, 16, 8, 41
FV, FA = 24, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_(True) if grad else t


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _close_trees(got, want, **tol):
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close_trees(got[k], want[k], **tol)
        return
    _close(got, want, **tol)


def _captions(rng, b=B, length=L, vocab=V):
    """[L, B] int32: SOS, words, EOS, PAD tail; one all-PAD padding row."""
    caps = np.zeros((length, b), np.int32)
    for i in range(b - 1):
        n = int(rng.integers(2, length - 1))
        caps[0, i] = 1
        caps[1:n + 1, i] = rng.integers(4, vocab, size=n)
        caps[n + 1, i] = 2
    return caps


def _feats(rng, b=B, t=T):
    visual = rng.normal(size=(b, t, FV)).astype(np.float32)
    audio = rng.normal(size=(b, t, FA)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[0, 3:] = False
    mask[b - 1] = False                     # the batch-padding row
    sample = np.ones((b,), bool)
    sample[b - 1] = False
    return visual, audio, mask, sample


def _models(rec="global", tf=1.0, cell="LSTM"):
    small = dict(rnn_hidden_size=H, embedding_size=E, attn_size=A, rnn_type=cell)
    jm = JaxDual(vocab_size=V, teacher_forcing_ratio=tf, reconstructor_type=rec,
                 visual_decoder_config=DecoderConfig(in_feature_size=FV, **small),
                 audio_decoder_config=DecoderConfig(in_feature_size=FA, **small))
    tm = AVCaptioningDual(vocab_size=V, teacher_forcing_ratio=tf, reconstructor_type=rec,
                          visual_decoder_config=TDecoderConfig(in_feature_size=FV, **small),
                          audio_decoder_config=TDecoderConfig(in_feature_size=FA, **small),
                          device="cpu")
    params = _np(jm.init(jax.random.PRNGKey(3)))
    return jm, tm, params


# ---------------------------------------------------------------- rnn scan


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
def test_rnn_scan_pre_outputs_and_grads_match_jax(cell):
    rng = np.random.default_rng(0)
    G, Hs, Ls = (4 if cell == "LSTM" else 3), 6, 5
    wh = rng.normal(size=(Hs, G * Hs)).astype(np.float32) * 0.4
    bh = rng.normal(size=(G * Hs,)).astype(np.float32)
    gi = rng.normal(size=(Ls, B, G * Hs)).astype(np.float32)
    h0 = rng.normal(size=(B, Hs)).astype(np.float32)
    c0 = rng.normal(size=(B, Hs)).astype(np.float32)
    dh = rng.normal(size=(Ls, B, Hs)).astype(np.float32)
    inputs = (wh, bh, gi, h0, c0) if cell == "LSTM" else (wh, bh, gi, h0)

    def jf(*xs):
        state = (xs[3], xs[4]) if cell == "LSTM" else xs[3]
        return jrnn.rnn_scan_pre({"wh": xs[0], "bh": xs[1]}, cell, xs[2], state)

    jout, vjp = jax.vjp(jf, *inputs)
    jgrads = vjp(jnp.asarray(dh))
    ts = [_t(x, grad=True) for x in inputs]
    state = (ts[3], ts[4]) if cell == "LSTM" else ts[3]
    tout = trnn.rnn_scan_pre({"wh": ts[0], "bh": ts[1]}, cell, ts[2], state)
    (tout * _t(dh)).sum().backward()
    _close(tout.detach(), jout)
    for t, g in zip(ts, jgrads):
        _close(t.grad, g)


# ---------------------------------------------------------------- reconstructors


@pytest.mark.parametrize("kind", ["global", "local"])
def test_reconstructors_and_caption_mask_match_jax(kind):
    rng = np.random.default_rng(1)
    F = 20
    cfg = dict(type=kind, hidden_size=F, decoder_size=H, attn_size=A)
    from mvc_tpu.config import ReconstructorConfig

    jcfg, tcfg = ReconstructorConfig(**cfg), TRecConfig(**cfg)
    params = _np(jrec.init_reconstructor(jax.random.PRNGKey(0), jcfg))
    hiddens = rng.normal(size=(L, B, H)).astype(np.float32)
    hiddens[0] = 0
    caps = _captions(rng)
    outputs = rng.normal(size=(L, B, V)).astype(np.float32)
    jmask = jrec.build_caption_mask(jnp.asarray(outputs), jnp.asarray(caps))
    tmask = trec.build_caption_mask(_t(outputs), _t(caps))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # EOS is out of the reconstructor's mask (the loss keeps it)
    assert not tmask.numpy()[caps == 2].any()
    np.testing.assert_array_equal(
        trec.build_caption_mask(_t(outputs), None).numpy(),
        np.asarray(jrec.build_caption_mask(jnp.asarray(outputs), None)))
    want = jrec.reconstruct(params, jcfg, jnp.asarray(hiddens), jnp.asarray(outputs),
                            jnp.asarray(caps), feat_len=T)
    got = trec.reconstruct(from_numpy_tree(params), tcfg, _t(hiddens), _t(outputs), _t(caps),
                           feat_len=T)
    assert got.shape == want.shape == ((B, L, F) if kind == "global" else (B, T, F))
    _close(got.detach(), want, rtol=1e-5, atol=1e-6)
    if kind == "global":
        assert float(got[:, 0].abs().max()) == 0.0
        assert bool(torch.isfinite(got).all())       # the all-PAD row: max(len, 1)


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("masked", [False, True], ids=["no_sample_mask", "sample_mask"])
@pytest.mark.parametrize("compat", [False, True], ids=["vocab_axis", "batch_axis"])
def test_loss_terms_match_jax(masked, compat):
    rng = np.random.default_rng(2)
    caps = _captions(rng)
    logits = rng.normal(size=(L, B, V)).astype(np.float32)
    outputs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    visual, _, fmask, sample = _feats(rng)
    sm = sample if masked else None
    recons_g = rng.normal(size=(B, L, FV)).astype(np.float32)
    recons_l = rng.normal(size=(B, T, FV)).astype(np.float32)
    j = lambda x: None if x is None else jnp.asarray(x)   # noqa: E731
    t = lambda x: None if x is None else _t(x)            # noqa: E731
    _close(tlosses.nll_loss(_t(outputs), _t(caps)), jlosses.nll_loss(j(outputs), j(caps)))
    ign = caps[1:] == 0
    _close(tlosses.entropy_loss(_t(outputs[1:]), _t(ign), compat, t(sm)),
           jlosses.entropy_loss(j(outputs[1:]), j(ign), compat, j(sm)))
    for fm in (None, fmask):
        _close(tlosses.global_reconstruction_loss(_t(visual), _t(recons_g), _t(caps != 0),
                                                  t(fm), t(sm)),
               jlosses.global_reconstruction_loss(j(visual), j(recons_g), j(caps != 0),
                                                  j(fm), j(sm)))
        _close(tlosses.local_reconstruction_loss(_t(visual), _t(recons_l), t(fm), t(sm)),
               jlosses.local_reconstruction_loss(j(visual), j(recons_l), j(fm), j(sm)))
    for rec_type, recons in (("global", recons_g), ("local", recons_l), ("none", None)):
        tfn = tlosses.ModalityWiseReconstructionLossBuilder(5e-4, 0.3, 0.5, rec_type, compat)
        jfn = jlosses.ModalityWiseReconstructionLossBuilder(5e-4, 0.3, 0.5, rec_type, compat)
        a_rec = None if recons is None else recons[:, :, :FA]
        got = tfn(_t(outputs), _t(caps), _t(visual[:, :, :FA]), t(a_rec), _t(visual), t(recons),
                  feat_mask=_t(fmask), sample_mask=t(sm))
        want = jfn(j(outputs), j(caps), j(visual[:, :, :FA]), j(a_rec), j(visual), j(recons),
                   feat_mask=j(fmask), sample_mask=j(sm))
        for g, w in zip(got, want):
            _close(g, w)
        got1 = tlosses.total_reconstruction_loss(_t(outputs), _t(caps), _t(visual), t(recons),
                                                 5e-4, 0.5, rec_type, _t(fmask), compat, t(sm))
        want1 = jlosses.total_reconstruction_loss(j(outputs), j(caps), j(visual), j(recons),
                                                  5e-4, 0.5, rec_type, j(fmask), compat, j(sm))
        for g, w in zip(got1, want1):
            _close(g, w)


# ---------------------------------------------------------------- fused CE + entropy


@pytest.mark.parametrize("n_streams", [1, 2])
def test_fused_ce_entropy_matches_jax_and_the_materializing_path(n_streams):
    rng = np.random.default_rng(3)
    caps = _captions(rng)
    _, _, _, sample = _feats(rng)
    hs = [rng.normal(size=(L, B, H)).astype(np.float32) for _ in range(n_streams)]
    for h in hs:
        h[0] = 0
    outs = [{"w": rng.normal(size=(H, V)).astype(np.float32) * 0.3,
             "b": rng.normal(size=(V,)).astype(np.float32)} for _ in range(n_streams)]
    tile = 16                                   # does not divide V=41
    for sm in (None, sample):
        def jloss(hs_, outs_):
            ce, ent = jfused.ce_entropy_from_hiddens(
                hs_, outs_, jnp.asarray(caps), None if sm is None else jnp.asarray(sm),
                compute_dtype=jnp.float32, tile_v=tile)
            return ce + 0.7 * ent, (ce, ent)

        (_, (jce, jent)), (jgh, jgo) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            [jnp.asarray(h) for h in hs], [jax.tree.map(jnp.asarray, o) for o in outs])
        th = [_t(h, grad=True) for h in hs]
        to = [{k: _t(v, grad=True) for k, v in o.items()} for o in outs]
        tce, tent = tfused.ce_entropy_from_hiddens(
            th, to, _t(caps), None if sm is None else _t(sm), compute_dtype=torch.float32,
            tile_v=tile)
        (tce + 0.7 * tent).backward()
        _close(tce.detach(), jce)
        _close(tent.detach(), jent)
        for d in range(n_streams):
            _close(th[d].grad, jgh[d])
            _close(to[d]["w"].grad, jgo[d]["w"])
            _close(to[d]["b"].grad, jgo[d]["b"])
        # the port's own materializing path: summed log-softmax, then the losses
        mh = [_t(h, grad=True) for h in hs]
        mo = [{k: _t(v, grad=True) for k, v in o.items()} for o in outs]
        outputs = sum(torch.log_softmax(h @ o["w"] + o["b"], dim=-1) for h, o in zip(mh, mo))
        mce = tlosses.nll_loss(outputs, _t(caps))
        ment = tlosses.entropy_loss(outputs[1:], _t(caps[1:] == 0), False,
                                    None if sm is None else _t(sm))
        (mce + 0.7 * ment).backward()
        _close(tce.detach(), mce.detach())
        _close(tent.detach(), ment.detach())
        for d in range(n_streams):
            _close(th[d].grad, mh[d].grad)
            _close(to[d]["w"].grad, mo[d]["w"].grad)


# ---------------------------------------------------------------- dual model forwards


@pytest.mark.parametrize("tf", [1.0, 0.0])
@pytest.mark.parametrize("rec", ["none", "global", "local"])
def test_dual_forward_and_forward_hiddens_match_jax(rec, tf):
    rng = np.random.default_rng(4)
    jm, tm, params = _models(rec, tf)
    visual, audio, fmask, _ = _feats(rng)
    caps = _captions(rng)
    tparams = from_numpy_tree(params)
    params = jax.tree.map(jnp.asarray, params)
    args = (jnp.asarray(audio), jnp.asarray(visual), jnp.asarray(caps))
    targs = (_t(audio), _t(visual), _t(caps))
    jout, ja, jv = jm.forward(params, *args, feat_mask=jnp.asarray(fmask))
    tout, ta, tv = tm.forward(tparams, *targs, feat_mask=_t(fmask))
    assert tout.shape == (L, B, V)
    _close(tout, jout)
    for got, want in ((ta, ja), (tv, jv)):
        if rec == "none":
            assert got is None and want is None
        else:
            _close(got, want)
    (jh, jo, ja2, jv2) = jm.forward_hiddens(params, *args, feat_mask=jnp.asarray(fmask))
    (th, to, ta2, tv2) = tm.forward_hiddens(tparams, *targs, feat_mask=_t(fmask))
    for g, w in zip(th, jh):
        _close(g, w)
    assert to[0] is tparams["v_decoder"]["out"] and to[1] is tparams["a_decoder"]["out"]
    if rec != "none":
        _close(ta2, ja2)
        _close(tv2, jv2)


@pytest.mark.parametrize("tf", [1.0, 0.0])
@pytest.mark.parametrize("cell,t", [("LSTM", 5), ("GRU", 6)])
def test_single_decoder_decode_and_decode_hiddens_match_jax(cell, t, tf):
    """One decoder's training decodes; at T=5 < L-1 the context rows ride
    P = feats @ wi_ctx (the training factoring rule), at T=6 they do not."""
    from mvc_tpu.models import decoder as jdec
    from mvc_tpu_torch.models import decoder as tdec

    rng = np.random.default_rng(9)
    small = dict(rnn_hidden_size=H, embedding_size=E, attn_size=A, rnn_type=cell,
                 in_feature_size=FV, output_size=V)
    jcfg, tcfg = DecoderConfig(**small), TDecoderConfig(**small)
    params = _np(jdec.init_decoder(jax.random.PRNGKey(5), jcfg))
    visual, _, fmask, _ = _feats(rng, t=t)
    caps = _captions(rng)
    assert tdec._train_factored(B, t, FV, params["rnn"]["wi"].shape[1], L) == (t < L - 1)
    tparams = from_numpy_tree(params)
    jargs = (jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(visual), jnp.asarray(caps))
    targs = (tparams, tcfg, _t(visual), _t(caps))
    jout, jh = jdec.decode(*jargs, teacher_forcing_ratio=tf, feat_mask=jnp.asarray(fmask))
    tout, th = tdec.decode(*targs, teacher_forcing_ratio=tf, feat_mask=_t(fmask))
    assert tout.shape == (L, B, V)
    _close(tout, jout)
    _close(th, jh)
    _close(tdec.decode_hiddens(*targs, teacher_forcing_ratio=tf, feat_mask=_t(fmask)),
           jdec.decode_hiddens(*jargs, teacher_forcing_ratio=tf, feat_mask=jnp.asarray(fmask)))


def test_dual_model_defaults_to_the_card_and_draws_reconstructors():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            AVCaptioningDual(vocab_size=V, teacher_forcing_ratio=1.0, reconstructor_type="global")
    _, tm, params = _models("global")
    tparams = tm.init(torch.Generator().manual_seed(0))
    assert set(tparams) == {"v_decoder", "a_decoder", "v_reconstructor", "a_reconstructor"}
    shapes = jax.tree.map(lambda x: tuple(x.shape), params)
    tshapes = jax.tree.map(lambda x: tuple(x.shape), to_numpy_tree(tparams))
    assert shapes == tshapes
    with pytest.raises(ValueError):
        AVCaptioningDual(vocab_size=V, reconstructor_type="bogus", device="cpu")


# ---------------------------------------------------------------- optimizer


def test_optimizer_matches_make_optimizer_with_a_midway_lr_change():
    rng = np.random.default_rng(5)
    params = {"a": {"w": rng.normal(size=(6, 4)).astype(np.float32)},
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 4).astype(np.float32), params)
             for _ in range(5)]
    cfg = JaxTrainerConfig(lr=1e-2)
    jtx = jopt.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = from_numpy_tree(params)
    topt_ = topt.make_optimizer(TrainerConfig(lr=1e-2), tp)
    for i, g in enumerate(grads):
        if i == 3:
            js = jopt.set_learning_rate(js, 3e-3)
            topt.set_learning_rate(topt_, 3e-3)
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for leaf, gl in zip(topt.tree_leaves(tp), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(np.array(gl))
        topt_.step()
    assert topt.get_learning_rate(topt_) == pytest.approx(jopt.get_learning_rate(js))
    _close_trees(to_numpy_tree(tp), _np(jp), rtol=1e-6, atol=1e-8)
    # the state round-trips through the port's format
    sd = topt_.state_dict()
    again = topt.make_optimizer(TrainerConfig(lr=1e-2), from_numpy_tree(params))
    again.load_state_dict(sd)
    assert again.lr == pytest.approx(3e-3)
    with pytest.raises(ValueError):
        again.load_state_dict({"not": "ours"})


def test_optimizer_without_amsgrad_matches_make_optimizer():
    rng = np.random.default_rng(8)
    params = {"w": rng.normal(size=(7, 3)).astype(np.float32)}
    cfg = JaxTrainerConfig(lr=1e-2, amsgrad=False)
    jtx = jopt.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = from_numpy_tree(params)
    topt_ = topt.make_optimizer(TrainerConfig(lr=1e-2, amsgrad=False), tp)
    for _ in range(4):
        g = (rng.normal(size=(7, 3)) * 4).astype(np.float32)
        upd, js = jtx.update({"w": jnp.asarray(g)}, js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        tp["w"].grad = torch.from_numpy(g)
        topt_.step()
    _close_trees(to_numpy_tree(tp), _np(jp), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("mode", ["max", "min"])
def test_plateau_scheduler_matches_jax(mode):
    j = jopt.PlateauScheduler(lr=1e-3, patience=1, mode=mode)
    t = topt.PlateauScheduler(lr=1e-3, patience=1, mode=mode)
    for metric in (0.1, 0.2, 0.2, 0.15, 0.1, 0.3, 0.3, 0.3):
        assert t.step(metric) == j.step(metric)
        assert t.state_dict() == j.state_dict()


# ---------------------------------------------------------------- the train step


def _jax_compute_loss(jm, cfg, params, batch, fused):
    """The JAX trainer's compute_loss (mvc_tpu/training/trainer.py:143-184)."""
    fm, sm, caps = batch["feat_mask"], batch["sample_mask"], batch["captions"]
    if fused:
        h, outs, a_rec, v_rec = jm.forward_hiddens(params, batch["audio"], batch["visual"], caps,
                                                   feat_mask=fm)
        ce, ent = jfused.ce_entropy_from_hiddens(h, outs, caps, sample_mask=sm,
                                                 compute_dtype=jnp.float32)
        a_l = jlosses._single_reconstruction_loss(caps, batch["audio"], a_rec,
                                                  jm.reconstructor_type, fm, sm)
        v_l = jlosses._single_reconstruction_loss(caps, batch["visual"], v_rec,
                                                  jm.reconstructor_type, fm, sm)
        return (ce + cfg.reg_lambda * ent + cfg.audio_recon_lambda * a_l
                + cfg.visual_recon_lambda * v_l)
    fn = jlosses.ModalityWiseReconstructionLossBuilder(
        cfg.reg_lambda, cfg.audio_recon_lambda, cfg.visual_recon_lambda, jm.reconstructor_type,
        cfg.compat_batch_axis_entropy)
    outputs, a_rec, v_rec = jm.forward(params, batch["audio"], batch["visual"], caps,
                                       feat_mask=fm)
    return fn(outputs, caps, batch["audio"], a_rec, batch["visual"], v_rec, feat_mask=fm,
              sample_mask=sm)[0]


class _GradCapture:
    """Stands in for the optimizer: keeps the gradients the step made."""

    def __init__(self, params):
        self.leaves = topt.tree_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)

    def step(self):
        self.grads = [p.grad.clone() for p in self.leaves]


@pytest.mark.parametrize("rec,compat", [("global", False), ("local", False), ("none", False),
                                        ("global", True)])
def test_train_step_loss_and_every_gradient_match_jax(rec, compat):
    from mvc_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(6)
    jm, tm, params = _models(rec, 1.0)
    visual, audio, fmask, sample = _feats(rng)
    batch = {"audio": audio, "visual": visual, "captions": _captions(rng),
             "feat_mask": fmask, "sample_mask": sample}
    cfg = TrainerConfig(reg_lambda=5e-4, audio_recon_lambda=0.3, visual_recon_lambda=0.5,
                        compat_batch_axis_entropy=compat)
    jcfg = JaxTrainerConfig(reg_lambda=5e-4, audio_recon_lambda=0.3, visual_recon_lambda=0.5,
                            compat_batch_axis_entropy=compat)
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_compute_loss(jm, jcfg, p, jb, not compat)))(jax.tree.map(jnp.asarray, params))
    trainer = Trainer("unused.ckpt", log_dir=None)
    step, _ = trainer._build_train_step(tm, cfg)
    tparams = from_numpy_tree(params)
    cap = _GradCapture(tparams)
    _, metrics = step(tparams, cap, {k: _t(v) for k, v in batch.items()}, None)
    _close(metrics[0], jloss, rtol=1e-4, atol=1e-6)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(cap.grads)
    for g, w in zip(cap.grads, jleaves):
        _close(g, w, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- trainer


class _Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def close(self):
        pass


def _fixture_models(vocab_size, rec):
    """Dual models at small widths over the fixture's 2048/128 features."""
    small = dict(rnn_hidden_size=H, embedding_size=E, attn_size=A)
    jm = JaxDual(vocab_size=vocab_size, teacher_forcing_ratio=1.0, reconstructor_type=rec,
                 visual_decoder_config=DecoderConfig(in_feature_size=2048, **small),
                 audio_decoder_config=DecoderConfig(in_feature_size=128, **small))
    tm = AVCaptioningDual(vocab_size=vocab_size, teacher_forcing_ratio=1.0,
                          reconstructor_type=rec,
                          visual_decoder_config=TDecoderConfig(in_feature_size=2048, **small),
                          audio_decoder_config=TDecoderConfig(in_feature_size=128, **small),
                          device="cpu")
    return jm, tm, _np(jm.init(jax.random.PRNGKey(7)))


def test_trainer_trajectory_matches_jax_over_two_epochs(synthetic_msvd):
    """Trainer.train over 2 epochs of the fixture, same batch order: every
    step's total within 1e-4 relative, and each final parameter leaf within
    1e-4 relative in norm."""
    from mvc_tpu.data import get_loader as jax_get_loader
    from mvc_tpu.training.trainer import Trainer as JaxTrainer
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.training.trainer import Trainer

    root, vocab = str(synthetic_msvd), str(synthetic_msvd / "metadata" / "vocab.json")
    kw = dict(batch_size=8, vocab_path=vocab, verbose=False, caption_buckets=(12, 16))
    jloader, jds = jax_get_loader(root, "MSVD", "train", **kw)
    tloader, _ = get_loader(root, "MSVD", "train", **kw)
    jm, tm, params = _fixture_models(len(jds.vocab), "global")
    cfg = TrainerConfig(batch_size=8, lr=1e-3, reg_lambda=5e-4, audio_recon_lambda=0.3,
                        visual_recon_lambda=0.5)
    jcfg = JaxTrainerConfig(batch_size=8, lr=1e-3, reg_lambda=5e-4, audio_recon_lambda=0.3,
                            visual_recon_lambda=0.5)

    jt = JaxTrainer("unused.ckpt", log_dir=None)
    jt.summary_writer, jt.previous_epochs = _Recorder(), 0
    jt._optimizer = jopt.make_optimizer(jcfg)
    jt._train_step, _ = jt._build_train_step(jm, jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jt._optimizer.init(jp)

    tt = Trainer("unused.ckpt", log_dir=None)
    tt.summary_writer = _Recorder()
    tp = from_numpy_tree(params)
    topt_ = topt.make_optimizer(cfg, tp)
    tt._train_step, _ = tt._build_train_step(tm, cfg)
    for epoch in (1, 2):
        jp, js, javg = jt.train(jm, jp, js, jloader, epoch, jax.random.PRNGKey(epoch))
        tp, topt_, tavg = tt.train(tm, tp, topt_, tloader, epoch, torch.Generator())
        assert tavg.keys() == javg.keys()
    jtot = [v for tag, v, _ in jt.summary_writer.scalars if tag == "train/loss"]
    ttot = [v for tag, v, _ in tt.summary_writer.scalars if tag == "train/loss"]
    assert len(ttot) == len(jtot) == 2 * len(jloader) == 6
    _close(ttot, jtot, rtol=1e-4, atol=0)
    assert ttot[-1] < ttot[0]
    # each final leaf within 1e-4 of the JAX leaf, relative in norm: Adam
    # turns the last-ulp differences of gradients that nearly cancel into
    # step-sized differences of single elements
    for got, want in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-4, rel
    tags = {tag for tag, _, _ in tt.summary_writer.scalars}
    assert tags == {tag for tag, _, _ in jt.summary_writer.scalars}


def test_fit_end_to_end_then_resume(synthetic_msvd, tmp_path):
    """Trainer.fit on the CPU: history keys, scores with CIDEr, the main,
    _best and _last files; a second fit resumes from the checkpoint."""
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.training.checkpoint import load_checkpoint
    from mvc_tpu_torch.training.trainer import Trainer

    root, vocab = str(synthetic_msvd), str(synthetic_msvd / "metadata" / "vocab.json")
    kw = dict(batch_size=8, vocab_path=vocab, verbose=False)
    train_loader, ds = get_loader(root, "MSVD", "train", **kw)
    val_loader, _ = get_loader(root, "MSVD", "val", shuffle=False, **kw)
    _, tm, params = _fixture_models(len(ds.vocab), "global")
    tparams = from_numpy_tree(params)
    before = to_numpy_tree(tparams)
    ckpt = str(tmp_path / "ck" / "model.ckpt")
    cfg = TrainerConfig(batch_size=8, epochs=2, lr=1e-3)
    trainer = Trainer(ckpt, log_dir=None, eval_freq=1)
    trainer.summary_writer = rec = _Recorder()
    out, opt, history = trainer.fit(tm, tparams, train_loader, val_loader, val_loader, cfg)
    assert set(history) == {"train_loss", "train_score", "val_loss", "val_score", "test_loss",
                            "test_score"}
    assert len(history["train_loss"]) == len(history["val_score"]) == 2
    assert set(history["train_loss"][0]) == {"total", "ce", "e", "a_recon", "v_recon"}
    for score in history["val_score"]:
        assert {"Bleu_4", "METEOR", "ROUGE_L", "CIDEr"} <= set(score)
    tags = {tag for tag, _, _ in rec.scalars}
    assert {"train/loss", "train_epoch/samples_per_sec", "val_epoch/loss",
            "val/captions_per_sec", "val/score/direct/CIDEr"} <= tags
    _close_trees(to_numpy_tree(tparams), before, rtol=0, atol=0)     # caller's tensors kept
    assert load_checkpoint(ckpt.replace(".ckpt", "_last.ckpt"))["epoch"] == 2
    best = load_checkpoint(ckpt.replace(".ckpt", "_best.ckpt"))
    assert (best is not None) == (max(s["CIDEr"] for s in history["val_score"]) > 0)
    main = load_checkpoint(ckpt)
    assert main["epoch"] in (1, 2) and main["opt_state"]["format"] == topt.STATE_FORMAT
    if main["epoch"] == 2:
        _close_trees(main["params"], to_numpy_tree(out), rtol=0, atol=0)

    # resume: 3 epochs from the epoch-2 checkpoint trains one more
    again = Trainer(ckpt, log_dir=None, eval_freq=1)
    cfg3 = dataclasses.replace(cfg, epochs=3)
    _, opt3, history3 = again.fit(tm, from_numpy_tree(params), train_loader, val_loader,
                                  val_loader, cfg3)
    assert len(history3["train_loss"]) == 3
    assert history3["train_loss"][:main["epoch"]] == history["train_loss"][:main["epoch"]]
    state = opt3.inner.state_dict()["state"]
    assert state[0]["step"] == 2 * len(train_loader) + len(train_loader)


def test_fit_refuses_what_is_not_ported(tmp_path):
    """Nothing of the JAX trainer is left unported: the data-parallel,
    tensor- and sequence-parallel meshes (for the transformer too), the
    feature cache, int8 transfer and bf16 Adam state.  A tp or sp mesh held
    by one process (the trainer takes one process a shard), a --dp or a
    ``--model transformer --tp/--sp`` wider than the devices at hand and a
    transfer dtype of neither package raise ValueError."""
    from mvc_tpu_torch.cli.train import main
    from mvc_tpu_torch.parallel import make_mesh
    from mvc_tpu_torch.training.trainer import Trainer

    for kw in (dict(dp=1, tp=2), dict(dp=1, sp=2)):
        with pytest.raises(ValueError, match="one process a shard"):
            Trainer(str(tmp_path / "x.ckpt"), log_dir=None,
                    mesh=make_mesh(devices=["cpu"] * 2, **kw))
    Trainer(str(tmp_path / "x.ckpt"), log_dir=None, mesh=make_mesh(devices=["cpu"] * 2))
    for extra in (["--tp", "2"], ["--sp", "2"]):
        with pytest.raises(ValueError, match=r"not divisible by tp\*sp=2"):
            main(["--device", "cpu", "--model", "transformer"] + extra)
    with pytest.raises(ValueError, match="needs more than 1 devices"):
        main(["--device", "cpu", "--dp", "2", "--data_root", str(tmp_path)])
    with pytest.raises(ValueError):
        Trainer(str(tmp_path / "x.ckpt"), log_dir=None).fit(
            None, None, None, None, None, TrainerConfig(transfer_dtype="int4"))


def test_host_bf16_cast_rounds_as_the_jax_trainer():
    """transfer_dtype="bfloat16": torch's host cast and the JAX trainer's
    (ml_dtypes) round every feature to the same bf16 value."""
    from mvc_tpu.training.trainer import Trainer as JaxTrainer
    from mvc_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 6, 33)).astype(np.float32) * np.float32(3.0)
    # values exactly between two bf16 numbers: round to nearest even
    x.reshape(-1)[:4] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 2 ** -130],
                                 np.float32)
    batch = {"audio": x, "visual": x[..., :7].copy(), "captions": np.ones((3, 4), np.int32),
             "sample_mask": np.ones(4, bool)}
    jt = JaxTrainer("unused.ckpt", log_dir=None)
    jt._transfer_dtype = jnp.dtype("bfloat16")
    jb = jt._put_batch(batch)
    tt = Trainer("unused.ckpt", log_dir=None)
    tt._transfer_dtype = torch.bfloat16
    tb = tt._put_batch(batch, torch.device("cpu"))
    for k in ("audio", "visual"):
        assert tb[k].dtype == torch.bfloat16
        want = np.asarray(jb[k]).astype(np.float32)
        np.testing.assert_array_equal(tb[k].float().numpy(), want)
    assert tb["captions"].dtype == torch.int32 and tb["_n_real"] == jb["_n_real"] == 4


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    from mvc_tpu.training.checkpoint import load_checkpoint as jax_load
    from mvc_tpu.training.checkpoint import restore_params_like as jax_restore
    from mvc_tpu_torch.training.checkpoint import (
        AsyncSaver,
        load_checkpoint,
        restore_params_like,
    )

    jm, tm, params = _models("global")
    tparams = tm.init(torch.Generator().manual_seed(1))
    path = str(tmp_path / "port.ckpt")
    saver = AsyncSaver()
    saver.submit([(path, {"epoch": 4, "params": tparams, "history": {"x": [1.0]}})])
    saver.wait()
    ckpt = jax_load(path)
    assert ckpt["epoch"] == 4 and ckpt["history"] == {"x": [1.0]}
    restored = jax_restore(jax.tree.map(jnp.asarray, params), ckpt["params"])
    _close_trees(_np(restored), to_numpy_tree(tparams), rtol=0, atol=0)
    back = restore_params_like(from_numpy_tree(params), load_checkpoint(path)["params"])
    _close_trees(to_numpy_tree(back), to_numpy_tree(tparams), rtol=0, atol=0)
    with pytest.raises(ValueError):
        restore_params_like(from_numpy_tree(_models("none")[2]), ckpt["params"])


def test_train_cli_on_the_cpu(synthetic_msvd, tmp_path, monkeypatch):
    """``python -m mvc_tpu_torch.cli.train --reconstructor none`` for one
    epoch on the CPU at the reference widths (one experiment, the JAX
    single-experiment name), with ``--dp 1`` (the same history), then with
    ``--model transformer`` (the transformer's checkpoint under the JAX
    name); in one process, which holds one shard, ``--tp``/``--sp`` above 1
    raise ValueError (two ranks run them in
    ``tests/test_torch_tensor_parallel.py``)."""
    from mvc_tpu_torch.cli.train import main

    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "MSVD").symlink_to(synthetic_msvd)
    monkeypatch.chdir(tmp_path)
    args = ["--data_root", "data", "--epochs", "1", "--batch_size", "16", "--lr", "0.001",
            "--device", "cpu", "--reconstructor", "none"]
    (history,) = main(args)
    assert len(history["train_loss"]) == len(history["val_score"]) == 1
    assert (tmp_path / "checkpoints" / "MSVD" / "rnn_1_epochs_custom_none_0.001_last.ckpt").exists()
    assert (tmp_path / "checkpoints" / "MSVD" / "rnn_1_epochs_custom_none_0.001.json").exists()
    for extra in (["--tp", "2"], ["--sp", "2"]):
        with pytest.raises(ValueError, match="not divisible"):
            main(args + extra)
    # --dp 1 (the default -1 alone is the same 1x1 mesh): the same run
    (tmp_path / "dp1").mkdir()
    (tmp_path / "dp1" / "data").symlink_to(tmp_path / "data")
    monkeypatch.chdir(tmp_path / "dp1")
    (meshed,) = main(args + ["--dp", "1"])
    assert meshed["train_loss"] == history["train_loss"]
    assert meshed["val_score"] == history["val_score"]
    monkeypatch.chdir(tmp_path)
    (history,) = main(args + ["--model", "transformer"])
    assert len(history["train_loss"]) == len(history["val_score"]) == 1
    ckpt = tmp_path / "checkpoints" / "MSVD" / "transformer_1_epochs_custom_none_0.001_last.ckpt"
    from mvc_tpu_torch.training.checkpoint import load_checkpoint

    params = load_checkpoint(str(ckpt))["params"]
    assert len(params["v_decoder"]) == 2 and params["generator"]["w"].shape[0] == 512
