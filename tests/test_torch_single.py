"""The single model's training path (``AVCaptioning`` with a reconstructor)
against the JAX package on the CPU, float32.

The same numpy-seeded inputs and the same weights (JAX ``init`` -> numpy ->
``from_numpy_tree``) go through each JAX function and its port: the
forwards within rtol 1e-5, the train step's loss and every gradient within
rtol 1e-4 (atol 1e-6), and a two-epoch ``Trainer`` trajectory within 1e-4
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
from mvc_tpu.models.captioning import AVCaptioning as JaxSingle
from mvc_tpu.training import fused_loss as jfused
from mvc_tpu.training import losses as jlosses
from mvc_tpu.training import optimizer as jopt
from mvc_tpu_torch.config import DecoderConfig as TDecoderConfig
from mvc_tpu_torch.config import TrainerConfig
from mvc_tpu_torch.models import AVCaptioning
from mvc_tpu_torch.training import optimizer as topt
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree

TOL = dict(rtol=1e-5, atol=1e-6)
B, T, L, H, E, A, V = 4, 5, 7, 32, 16, 8, 41
FV, FA = 24, 12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


def _captions(rng):
    """[L, B] int32: SOS, words, EOS, PAD tail; one all-PAD padding row."""
    caps = np.zeros((L, B), np.int32)
    for i in range(B - 1):
        n = int(rng.integers(2, L - 1))
        caps[0, i] = 1
        caps[1:n + 1, i] = rng.integers(4, V, size=n)
        caps[n + 1, i] = 2
    return caps


def _batch(rng):
    visual = rng.normal(size=(B, T, FV)).astype(np.float32)
    audio = rng.normal(size=(B, T, FA)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[0, 3:] = False
    mask[B - 1] = False                     # the batch-padding row
    sample = np.ones((B,), bool)
    sample[B - 1] = False
    return {"audio": audio, "visual": visual, "captions": _captions(rng), "feat_mask": mask,
            "sample_mask": sample}


def _models(rec, tf=1.0, f=FA + FV, vocab=V, seed=3):
    small = dict(rnn_hidden_size=H, embedding_size=E, attn_size=A, in_feature_size=f)
    jm = JaxSingle(vocab_size=vocab, teacher_forcing_ratio=tf, reconstructor_type=rec,
                   decoder_config=DecoderConfig(**small))
    tm = AVCaptioning(vocab_size=vocab, teacher_forcing_ratio=tf, reconstructor_type=rec,
                      decoder_config=TDecoderConfig(**small), device="cpu")
    return jm, tm, _np(jm.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("tf", [1.0, 0.0])
@pytest.mark.parametrize("rec", ["none", "global", "local"])
def test_single_forward_and_forward_hiddens_match_jax(rec, tf):
    """[audio | visual] through the decoder, the reconstruction split at
    the audio width, audio first; the reconstructor is sized to the
    decoder (H) and the concatenated features (F)."""
    rng = np.random.default_rng(4)
    jm, tm, params = _models(rec, tf)
    assert (tm.reconstructor_config.decoder_size, tm.reconstructor_config.hidden_size) == (H, FA + FV)
    b = _batch(rng)
    tparams = from_numpy_tree(params)
    jp = jax.tree.map(jnp.asarray, params)
    args = (jnp.asarray(b["audio"]), jnp.asarray(b["visual"]), jnp.asarray(b["captions"]))
    targs = (_t(b["audio"]), _t(b["visual"]), _t(b["captions"]))
    jfm, tfm = jnp.asarray(b["feat_mask"]), _t(b["feat_mask"])
    jout, ja, jv = jm.forward(jp, *args, feat_mask=jfm)
    tout, ta, tv = tm.forward(tparams, *targs, feat_mask=tfm)
    assert tout.shape == (L, B, V)
    _close(tout, jout)
    (jh,), _, ja2, jv2 = jm.forward_hiddens(jp, *args, feat_mask=jfm)
    (th,), (to,), ta2, tv2 = tm.forward_hiddens(tparams, *targs, feat_mask=tfm)
    _close(th, jh)
    assert to is tparams["decoder"]["out"]
    for got, want in ((ta, ja), (tv, jv), (ta2, ja2), (tv2, jv2)):
        if rec == "none":
            assert got is None and want is None
        else:
            _close(got, want)
    if rec != "none":
        assert ta.shape[2] == FA and tv.shape[2] == FV


def _jax_compute_loss(jm, cfg, params, batch):
    """The JAX trainer's fused-path compute_loss (mvc_tpu/training/trainer.py:154)."""
    fm, sm, caps = batch["feat_mask"], batch["sample_mask"], batch["captions"]
    h, outs, a_rec, v_rec = jm.forward_hiddens(params, batch["audio"], batch["visual"], caps,
                                               feat_mask=fm)
    ce, ent = jfused.ce_entropy_from_hiddens(h, outs, caps, sample_mask=sm,
                                             compute_dtype=jnp.float32)
    a_l = jlosses._single_reconstruction_loss(caps, batch["audio"], a_rec,
                                              jm.reconstructor_type, fm, sm)
    v_l = jlosses._single_reconstruction_loss(caps, batch["visual"], v_rec,
                                              jm.reconstructor_type, fm, sm)
    return ce + cfg.reg_lambda * ent + cfg.audio_recon_lambda * a_l + cfg.visual_recon_lambda * v_l


class _GradCapture:
    """Stands in for the optimizer: keeps the gradients the step made."""

    def __init__(self, params):
        self.leaves = topt.tree_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)

    def step(self):
        self.grads = [p.grad.clone() for p in self.leaves]


@pytest.mark.parametrize("rec", ["none", "global"])
def test_single_train_step_loss_and_every_gradient_match_jax(rec):
    """The trainer's fused CE + entropy step with one stream."""
    from mvc_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(6)
    jm, tm, params = _models(rec)
    batch = _batch(rng)
    kw = dict(reg_lambda=5e-4, audio_recon_lambda=0.3, visual_recon_lambda=0.5)
    cfg, jcfg = TrainerConfig(**kw), JaxTrainerConfig(**kw)
    jb = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: _jax_compute_loss(jm, jcfg, p, jb)))(jax.tree.map(jnp.asarray, params))
    step, _ = Trainer("unused.ckpt", log_dir=None)._build_train_step(tm, cfg)
    tparams = from_numpy_tree(params)
    cap = _GradCapture(tparams)
    _, metrics = step(tparams, cap, {k: _t(v) for k, v in batch.items()}, None)
    _close(metrics[0], jloss, rtol=1e-4, atol=1e-6)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(cap.grads) == (11 if rec == "none" else 15)
    for g, w in zip(cap.grads, jleaves):
        _close(g, w, rtol=1e-4, atol=1e-6)


class _Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def close(self):
        pass


def test_single_trainer_trajectory_matches_jax_over_two_epochs(synthetic_msvd):
    """Trainer.train of AVCaptioning + a global reconstructor (F=2176 over
    the fixture's features) over 2 epochs, same batch order: every step's
    total within 1e-4 relative, each final leaf within 1e-4 relative in
    norm."""
    from mvc_tpu.data import get_loader as jax_get_loader
    from mvc_tpu.training.trainer import Trainer as JaxTrainer
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.training.trainer import Trainer

    root, vocab = str(synthetic_msvd), str(synthetic_msvd / "metadata" / "vocab.json")
    kw = dict(batch_size=8, vocab_path=vocab, verbose=False, caption_buckets=(12, 16))
    jloader, jds = jax_get_loader(root, "MSVD", "train", **kw)
    tloader, _ = get_loader(root, "MSVD", "train", **kw)
    jm, tm, params = _models("global", f=2176, vocab=len(jds.vocab), seed=7)
    kw = dict(batch_size=8, lr=1e-3, reg_lambda=5e-4, audio_recon_lambda=0.3,
              visual_recon_lambda=0.5)
    cfg, jcfg = TrainerConfig(**kw), JaxTrainerConfig(**kw)

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
        jp, js, _ = jt.train(jm, jp, js, jloader, epoch, jax.random.PRNGKey(epoch))
        tp, topt_, _ = tt.train(tm, tp, topt_, tloader, epoch, torch.Generator())
    jtot = [v for tag, v, _ in jt.summary_writer.scalars if tag == "train/loss"]
    ttot = [v for tag, v, _ in tt.summary_writer.scalars if tag == "train/loss"]
    assert len(ttot) == len(jtot) == 6
    _close(ttot, jtot, rtol=1e-4, atol=0)
    assert ttot[-1] < ttot[0]
    for got, want in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-4, rel


def test_single_model_checks_its_reconstructor_type():
    with pytest.raises(ValueError):
        AVCaptioning(vocab_size=V, reconstructor_type="both", device="cpu")
    _, tm, _ = _models("local")
    params = tm.init(torch.Generator().manual_seed(0))
    assert set(params) == {"decoder", "reconstructor"}
    assert set(params["reconstructor"]) == {"rnn", "attention"}
