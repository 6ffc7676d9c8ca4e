"""The port's transformer captioner against the JAX package on the CPU.

The same numpy-seeded inputs and the same weights (JAX ``init`` -> numpy ->
``from_numpy_tree``) go through ``mvc_tpu.models.transformer`` and
``mvc_tpu_torch.models.transformer`` at a tiny width (d_model 32, 4 heads,
2 layers, d_ff 64, F 24/12, V=50).  Tolerances, float32: ``forward``
log-probs rtol 1e-5 / atol 1e-5; the train step's loss and gradients rtol
1e-4 / atol 1e-6; a 2-epoch fit's per-step losses 1e-4 relative.  Decode
tokens are compared exactly, with the generator bias spread (a seeded
permutation x 2e-3, as on the card) so no argmax or top-W pick is a near-tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
from mvc_tpu.models.transformer import TransformerCaptioning as JaxTransformer
from mvc_tpu.models.transformer import TransformerConfig as JaxTConfig
from mvc_tpu.models.transformer import positional_encoding as jax_pe
from mvc_tpu.training import losses as jlosses
from mvc_tpu.training import optimizer as jopt
from mvc_tpu_torch.config import TrainerConfig, TransformerConfig
from mvc_tpu_torch.models import TransformerCaptioning
from mvc_tpu_torch.models import beam as tbeam
from mvc_tpu_torch.models.transformer import positional_encoding
from mvc_tpu_torch.training import optimizer as topt
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree, to_numpy_tree

V, FV, FA = 50, 24, 12
SMALL = dict(d_model=32, num_heads=4, num_layers=2, d_ff=64, visual_dim=FV, audio_dim=FA,
             max_len=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(vocab_size=V, spread=True, jdtype=jnp.float32, tdtype=torch.float32, **widths):
    """(JAX model, port model, numpy params) with the same weights."""
    small = dict(SMALL, **widths)
    jm = JaxTransformer(vocab_size=vocab_size, config=JaxTConfig(**small), dtype=jdtype)
    tm = TransformerCaptioning(vocab_size=vocab_size, config=TransformerConfig(**small),
                               dtype=tdtype, device="cpu")
    params = _np(jm.init(jax.random.PRNGKey(0)))
    if spread:
        perm = np.random.default_rng(1).permutation(vocab_size).astype(np.float32)
        params["generator"]["b"] = params["generator"]["b"] + perm * np.float32(2e-3)
    return jm, tm, params


def _inputs(rng, b=3, t=5, length=8, masked=True):
    visual = rng.normal(size=(b, t, FV)).astype(np.float32)
    audio = rng.normal(size=(b, t, FA)).astype(np.float32)
    mask = np.ones((b, t), bool)
    if masked:
        mask[b - 1, t - 2:] = False
    caps = rng.integers(4, V, size=(length, b)).astype(np.int32)
    caps[0] = 1
    return visual, audio, mask, caps


def _t(x):
    return torch.from_numpy(np.array(x))


def test_own_copies_match_the_jax_package():
    assert dataclasses.asdict(TransformerConfig()) == dataclasses.asdict(JaxTConfig())
    pe = positional_encoding(3660, 512)
    assert pe.dtype == np.float32
    np.testing.assert_array_equal(pe, jax_pe(3660, 512))


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "feat_mask"])
def test_forward_matches_jax(masked):
    jm, tm, params = _models()
    visual, audio, mask, caps = _inputs(np.random.default_rng(0), masked=masked)
    fm = mask if masked else None
    want, ja, jv = jm.forward(jax.tree.map(jnp.asarray, params), jnp.asarray(audio),
                              jnp.asarray(visual), jnp.asarray(caps),
                              feat_mask=None if fm is None else jnp.asarray(fm))
    got, ta, tv = tm.forward(from_numpy_tree(params), _t(audio), _t(visual), _t(caps),
                             feat_mask=None if fm is None else _t(fm))
    assert ja is jv is ta is tv is None
    assert got.shape == (caps.shape[0], caps.shape[1], V) and got.dtype == torch.float32
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_causality_and_feat_mask_equal_truncation():
    """A later caption token changes no earlier output; masked frames give
    the outputs of the truncated clip."""
    _, tm, params = _models()
    tp = from_numpy_tree(params)
    visual, audio, _, caps = _inputs(np.random.default_rng(1), b=2, t=6, masked=False)
    out1, _, _ = tm.forward(tp, _t(audio), _t(visual), _t(caps))
    caps2 = caps.copy()
    caps2[-1] = (caps2[-1] + 1) % (V - 4) + 4
    out2, _, _ = tm.forward(tp, _t(audio), _t(visual), _t(caps2))
    np.testing.assert_allclose(out1[:-1].numpy(), out2[:-1].numpy(), rtol=1e-5, atol=1e-6)

    t_real = 4
    a_p, v_p = audio.copy(), visual.copy()
    a_p[:, t_real:] = 0
    v_p[:, t_real:] = 0
    mask = np.zeros((2, 6), bool)
    mask[:, :t_real] = True
    masked, _, _ = tm.forward(tp, _t(a_p), _t(v_p), _t(caps), feat_mask=_t(mask))
    trunc, _, _ = tm.forward(tp, _t(audio[:, :t_real]), _t(visual[:, :t_real]), _t(caps))
    np.testing.assert_allclose(masked.numpy(), trunc.numpy(), rtol=1e-4, atol=1e-5)


def test_cached_greedy_equals_full_prefix_and_jax():
    """The K/V-cached direct decode gives the full-prefix decode's tokens at
    every step, and the JAX model's tokens exactly; column 0 is SOS."""
    jm, tm, params = _models()
    visual, audio, mask, _ = _inputs(np.random.default_rng(2), b=4, t=5)
    L = 9
    tp = from_numpy_tree(params)
    got = tm.predict_tokens(tp, _t(audio), _t(visual), max_caption_len=L, mode="direct",
                            feat_mask=_t(mask)).numpy()
    want = np.asarray(jm.predict_tokens(jax.tree.map(jnp.asarray, params), jnp.asarray(audio),
                                        jnp.asarray(visual), max_caption_len=L, mode="direct",
                                        feat_mask=jnp.asarray(mask)))
    assert got.dtype == np.int32 and got.shape == (4, L)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[:, 0] == 1)

    a_mem, v_mem, cross = tm._encode(tp, _t(audio), _t(visual), _t(mask))
    full = np.full((4, L), 1, np.int32)
    with torch.no_grad():
        for t in range(1, L):
            logp = tm._decode_logits(tp, _t(full), a_mem, v_mem, cross)
            full[:, t] = logp[:, t - 1].argmax(-1).numpy()
    np.testing.assert_array_equal(got, full)
    assert len({tuple(r) for r in got[:, 1:]}) > 1


@pytest.mark.parametrize("alpha,width,length", [(0.0, 3, 7), (0.7, 4, 6)])
def test_cached_beam_equals_full_prefix_and_jax(alpha, width, length):
    """The cached beam (caches [B, W, Lh, D] in the search state, regathered
    with their beams) gives the full-prefix beam's tokens and JAX's."""
    jm, tm, params = _models()
    visual, audio, mask, _ = _inputs(np.random.default_rng(3), b=3, t=5)
    tp = from_numpy_tree(params)
    got = tm.predict_tokens(tp, _t(audio), _t(visual), max_caption_len=length, mode="beam",
                            beam_width=width, beam_alpha=alpha, feat_mask=_t(mask)).numpy()
    want = np.asarray(jm.predict_tokens(jax.tree.map(jnp.asarray, params), jnp.asarray(audio),
                                        jnp.asarray(visual), max_caption_len=length,
                                        mode="beam", beam_width=width, beam_alpha=alpha,
                                        feat_mask=jnp.asarray(mask)))
    assert got.shape == (3, length + 2)
    np.testing.assert_array_equal(got, want)

    # the full-prefix oracle: each step re-decodes the whole history
    B, W = 3, width
    with torch.no_grad():
        a_mem, v_mem, cross = tm._encode(tp, _t(audio), _t(visual), _t(mask))
        rep = [x.repeat_interleave(W, dim=0) for x in (a_mem, v_mem, cross)]

        def step_fn(prev, hist):
            seq = torch.cat([hist, prev[:, :, None]], dim=2).reshape(B * W, -1)
            logp = tm._decode_logits(tp, seq, *rep)[:, -1]
            return logp.reshape(B, W, -1), torch.cat([hist, prev[:, :, None]], dim=2)

        oracle = tbeam.beam_search(step_fn, torch.zeros((B, W, 0), dtype=torch.long), B, V,
                                   max_caption_len=length, beam_alpha=alpha, beam_width=W)
    np.testing.assert_array_equal(got, oracle.numpy())


def test_bf16_model_promotes_as_jax_does():
    """A bf16 model over f32 params: the float32 positional encoding lifts
    the residual stream to float32 (torch.matmul would refuse f32 @ bf16),
    so forward is float32 and within the float32 tolerance of JAX's bf16
    model; both decodes run."""
    jm, tm, params = _models(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    visual, audio, mask, caps = _inputs(np.random.default_rng(4))
    bf = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    want, _, _ = jm.forward(bf, jnp.asarray(audio), jnp.asarray(visual), jnp.asarray(caps),
                            feat_mask=jnp.asarray(mask))
    tp = from_numpy_tree(params, dtype=torch.bfloat16)
    got, _, _ = tm.forward(tp, _t(audio), _t(visual), _t(caps), feat_mask=_t(mask))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for mode in ("direct", "beam"):
        tok = tm.predict_tokens(from_numpy_tree(params), _t(audio), _t(visual),
                                max_caption_len=6, mode=mode, beam_width=2, feat_mask=_t(mask))
        assert tok.dtype == torch.int32 and tok.shape[1] == (6 if mode == "direct" else 8)


def _jax_loss(jm, cfg, params, batch):
    """The JAX trainer's materializing compute_loss for a model without
    forward_hiddens (mvc_tpu/training/trainer.py:136-141, :180-184)."""
    fn = jlosses.ModalityWiseReconstructionLossBuilder(
        cfg.reg_lambda, cfg.audio_recon_lambda, cfg.visual_recon_lambda, jm.reconstructor_type,
        cfg.compat_batch_axis_entropy)
    outputs, a_rec, v_rec = jm.forward(params, batch["audio"], batch["visual"], batch["captions"],
                                       feat_mask=batch["feat_mask"])
    return fn(outputs, batch["captions"], batch["audio"], a_rec, batch["visual"], v_rec,
              feat_mask=batch["feat_mask"], sample_mask=batch["sample_mask"])[0]


class _GradCapture:
    """Stands in for the optimizer: keeps the gradients the step made."""

    def __init__(self, params):
        self.leaves = topt.tree_leaves(params)
        for p in self.leaves:
            p.requires_grad_(True)

    def step(self):
        self.grads = [p.grad.clone() for p in self.leaves]


def test_train_step_loss_and_every_gradient_match_jax():
    """The trainer's step on the transformer takes the materializing loss
    (no forward_hiddens); its loss and each gradient leaf against jax.grad."""
    from mvc_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(6)
    jm, tm, params = _models()
    visual, audio, mask, caps = _inputs(rng, b=4)
    caps[5:, 1] = 0                       # PAD tail
    sample = np.array([True, True, True, False])
    batch = {"audio": audio, "visual": visual, "captions": caps, "feat_mask": mask,
             "sample_mask": sample}
    cfg = TrainerConfig(reg_lambda=5e-4)
    jcfg = JaxTrainerConfig(reg_lambda=5e-4)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: _jax_loss(jm, jcfg, p, jax.tree.map(
        jnp.asarray, batch))))(jax.tree.map(jnp.asarray, params))
    tparams = from_numpy_tree(params)
    cap = _GradCapture(tparams)
    step, _ = Trainer("unused.ckpt", log_dir=None)._build_train_step(tm, cfg)
    _, metrics = step(tparams, cap, {k: _t(v) for k, v in batch.items()}, None)
    np.testing.assert_allclose(float(metrics[0]), float(jloss), rtol=1e-4, atol=1e-6)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(cap.grads) == len(jax.tree.leaves(params))
    for g, w in zip(cap.grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6)


def test_list_tree_through_the_optimizer_and_both_checkpoint_formats(tmp_path):
    """The transformer's lists of layers: ClippedAdam trains every leaf as
    the JAX chain does, and a list tree round-trips through either
    package's checkpoint, both ways."""
    from mvc_tpu.training.checkpoint import load_checkpoint as jax_load
    from mvc_tpu.training.checkpoint import restore_params_like as jax_restore
    from mvc_tpu.training.checkpoint import save_checkpoint as jax_save
    from mvc_tpu_torch.training.checkpoint import (
        AsyncSaver,
        load_checkpoint,
        restore_params_like,
    )

    _, _, params = _models(d_model=16, num_heads=2, num_layers=2, d_ff=32)
    rng = np.random.default_rng(9)
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape) * 3).astype(np.float32), params)
             for _ in range(3)]
    jtx = jopt.make_optimizer(JaxTrainerConfig(lr=1e-2))
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    jupdate = jax.jit(jtx.update)
    tp = from_numpy_tree(params)
    opt = topt.make_optimizer(TrainerConfig(lr=1e-2), tp)
    assert len(opt.leaves) == len(jax.tree.leaves(params)) > 40
    for g in grads:
        upd, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        for leaf, gl in zip(topt.tree_leaves(tp), jax.tree.leaves(g)):
            leaf.grad = torch.from_numpy(np.array(gl))
        opt.step()
    for got, want in zip(jax.tree.leaves(to_numpy_tree(tp)), jax.tree.leaves(_np(jp))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)

    port_path, jax_path = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    saver = AsyncSaver()
    saver.submit([(port_path, {"epoch": 1, "params": tp, "history": {"x": [1.0]}})])
    saver.wait()
    ckpt = jax_load(port_path)
    assert isinstance(ckpt["params"]["v_decoder"], list)
    restored = _np(jax_restore(jax.tree.map(jnp.asarray, params), ckpt["params"]))
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(to_numpy_tree(tp))):
        np.testing.assert_array_equal(got, want)
    jax_save(jax_path, {"epoch": 2, "params": jp})
    back = restore_params_like(from_numpy_tree(params), load_checkpoint(jax_path)["params"])
    assert isinstance(back["a_encoder"], list)
    for got, want in zip(jax.tree.leaves(to_numpy_tree(back)), jax.tree.leaves(_np(jp))):
        np.testing.assert_array_equal(got, want)
    short = from_numpy_tree(params)
    short["v_decoder"] = short["v_decoder"][:1]
    with pytest.raises(ValueError):
        restore_params_like(short, ckpt["params"])


class _Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def close(self):
        pass


def test_trainer_trajectory_matches_jax_over_two_epochs(synthetic_msvd):
    """Trainer.train of the transformer over 2 epochs of the fixture (F
    2048/128), same batch order: every step's total loss within 1e-4
    relative of the JAX Trainer's, and each final leaf within 1e-4 relative
    in norm."""
    from mvc_tpu.data import get_loader as jax_get_loader
    from mvc_tpu.training.trainer import Trainer as JaxTrainer
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.training.trainer import Trainer

    root, vocab = str(synthetic_msvd), str(synthetic_msvd / "metadata" / "vocab.json")
    kw = dict(batch_size=8, vocab_path=vocab, verbose=False, caption_buckets=(12, 16))
    jloader, jds = jax_get_loader(root, "MSVD", "train", **kw)
    tloader, _ = get_loader(root, "MSVD", "train", **kw)
    jm, tm, params = _models(len(jds.vocab), spread=False, visual_dim=2048, audio_dim=128)
    cfg = TrainerConfig(batch_size=8, lr=1e-3, reg_lambda=5e-4)
    jcfg = JaxTrainerConfig(batch_size=8, lr=1e-3, reg_lambda=5e-4)

    jt = JaxTrainer("unused.ckpt", log_dir=None)
    jt.summary_writer, jt.previous_epochs = _Recorder(), 0
    jt._optimizer = jopt.make_optimizer(jcfg)
    jt._train_step, _ = jt._build_train_step(jm, jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jt._optimizer.init(jp)

    tt = Trainer("unused.ckpt", log_dir=None)
    tt.summary_writer = _Recorder()
    tp = from_numpy_tree(params)
    opt = topt.make_optimizer(cfg, tp)
    tt._train_step, _ = tt._build_train_step(tm, cfg)
    for epoch in (1, 2):
        jp, js, _ = jt.train(jm, jp, js, jloader, epoch, jax.random.PRNGKey(epoch))
        tp, opt, _ = tt.train(tm, tp, opt, tloader, epoch, torch.Generator())
    jtot = [v for tag, v, _ in jt.summary_writer.scalars if tag == "train/loss"]
    ttot = [v for tag, v, _ in tt.summary_writer.scalars if tag == "train/loss"]
    assert len(ttot) == len(jtot) == 2 * len(jloader) == 6
    np.testing.assert_allclose(ttot, jtot, rtol=1e-4, atol=0)
    assert ttot[-1] < ttot[0]
    for got, want in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        want = np.asarray(want)
        rel = np.linalg.norm(got.detach().numpy() - want) / np.linalg.norm(want)
        assert rel <= 1e-4, rel


def test_fit_evaluates_without_the_all_eos_switch(synthetic_msvd, tmp_path):
    """A 1-epoch Trainer.fit of the transformer: the eval calls
    predict_tokens without stop_at_all_eos (it has none) and the fit writes
    its checkpoints; the captions equal a plain decode of the params."""
    from mvc_tpu_torch.data import get_loader
    from mvc_tpu_torch.data.dataset import video_dataset_to_video_captions_loader
    from mvc_tpu_torch.models.captioning import captions_from_tokens
    from mvc_tpu_torch.training.trainer import Trainer

    root, vocab = str(synthetic_msvd), str(synthetic_msvd / "metadata" / "vocab.json")
    loader, ds = get_loader(root, "MSVD", "train", batch_size=8, vocab_path=vocab,
                            verbose=False, caption_buckets=(12, 16))
    _, tm, params = _models(len(ds.vocab), spread=False, visual_dim=2048, audio_dim=128)

    class Recording(Trainer):
        def eval(self, *a, **k):
            out = super().eval(*a, **k)
            self.generated = out[2]
            return out

    ckpt = str(tmp_path / "t.ckpt")
    tr = Recording(ckpt, log_dir=None)
    cfg = TrainerConfig(batch_size=8, epochs=1, lr=1e-3, eval_max_caption_len=8,
                        transfer_dtype=None)
    out, _, history = tr.fit(tm, from_numpy_tree(params), loader, loader, loader, cfg)
    assert len(history["val_score"]) == 1 and (tmp_path / "t_last.ckpt").exists()
    vc = video_dataset_to_video_captions_loader(ds, batch_size=8,
                                                frame_buckets=tuple(cfg.frame_buckets))
    plain = {}
    for b in vc:
        tok = tm.predict_tokens(out, _t(b["audio"]), _t(b["visual"]), max_caption_len=8,
                                feat_mask=_t(b["feat_mask"]))
        plain.update(zip(b["video_ids"], captions_from_tokens(ds.vocab, tok)))
    assert {v: c[0] for v, c in tr.generated.items()} == plain


def test_model_defaults_to_the_card_and_reports_its_limits():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerCaptioning(vocab_size=V)
    tm = TransformerCaptioning(vocab_size=V, config=TransformerConfig(**SMALL), device="cpu")
    assert tm.max_frames(None, 64, "beam", 5) == 64 and tm.max_beam_width() == V
    _, _, params = _models()
    visual, audio, _, _ = _inputs(np.random.default_rng(5), t=65, masked=False)
    with pytest.raises(ValueError, match="longer than the positional"):
        tm.predict_tokens(from_numpy_tree(params), _t(audio), _t(visual))


def test_regather_walks_dicts_and_passes_scalars_through():
    """The beam's regather over a state tree of tuples, lists and dicts:
    [B, W, ...] leaves follow their beams; a 0-dim step counter, a Python
    int and a leaf without the [B, W] axes pass through unchanged."""
    B, W = 2, 3
    x = torch.arange(B * W * 4, dtype=torch.float32).reshape(B, W, 4)
    idx = torch.tensor([[2, 2, 0], [1, 0, 1]])
    t0, other = torch.tensor(5), torch.ones(W, B)
    state = ([{"k": x, "v": x + 100}], ({"k": x[:, :, :1]},), t0, 7, other)
    out = tbeam._regather(state, idx)
    want = torch.stack([x[b, idx[b]] for b in range(B)])
    assert torch.equal(out[0][0]["k"], want) and torch.equal(out[0][0]["v"], want + 100)
    assert torch.equal(out[1][0]["k"], want[:, :, :1])
    assert out[2] is t0 and out[3] == 7 and out[4] is other
    assert isinstance(out[0], list) and isinstance(out[1], tuple)
