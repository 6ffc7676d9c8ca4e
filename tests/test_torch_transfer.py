"""The port's feature transfer and optimizer state against the JAX package
on the CPU: int8 quantization, the device feature cache and its index
path, the int8 ``_put_batch``, and bf16 Adam moments.

Arrays that the two packages make from the same host data (quantized
payloads, caches, gathered batches, dequantized batches) are compared bit
for bit; cached and uncached fits of the port within rtol 1e-5; bf16 Adam
moments equal in bf16 and parameters within rtol 1e-6.
"""

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.config import DecoderConfig
from mvc_tpu.config import TrainerConfig as JaxTrainerConfig
from mvc_tpu.data import feature_cache as jfc
from mvc_tpu.data import get_loader as jax_get_loader
from mvc_tpu.models.captioning import AVCaptioningDual as JaxDual
from mvc_tpu.training import optimizer as jopt
from mvc_tpu_torch.config import DecoderConfig as TDecoderConfig
from mvc_tpu_torch.config import TrainerConfig
from mvc_tpu_torch.data import feature_cache as tfc
from mvc_tpu_torch.data import get_loader
from mvc_tpu_torch.models import AVCaptioningDual
from mvc_tpu_torch.training import optimizer as topt
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree


def _same(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _loaders(root, pkg_get_loader, frame_buckets=(8,), batch_size=6):
    kw = dict(batch_size=batch_size, vocab_path=str(root / "metadata" / "vocab.json"),
              verbose=False, frame_buckets=frame_buckets, caption_buckets=(12,))
    train, ds = pkg_get_loader(str(root), "MSVD", "train", **kw)
    val, _ = pkg_get_loader(str(root), "MSVD", "val", **kw)
    train.shuffle = val.shuffle = False
    return train, val, ds


def test_quantize_int8_is_bit_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 33)).astype(np.float32) * np.float32(4.0)
    x[1, 3] = 0.0                                        # all-zero frame: scale 1.0
    x[2, 0, :2] = [127.0, 0.5]                           # half-way value: round half to even
    x[2, 0, 2:] = 0.0
    q, s = tfc.quantize_int8(x)
    jq, js = jfc.quantize_int8(x)
    assert q.dtype == np.int8 and s.dtype == np.float32 and s.shape == (5, 7, 1)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    assert s[1, 3, 0] == 1.0 and q[2, 0, 1] == 0
    back = tfc.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s))
    _same(back, jax.jit(lambda a, b: a.astype(jnp.float32) * b)(q, s))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_device_feature_cache_arrays_match_jax(synthetic_msvd, dtype):
    """The same clips, rows, frame capacity (the bucket over T_top), stored
    values, caption encodings and byte count."""
    _, _, jds = _loaders(synthetic_msvd, jax_get_loader)
    _, _, tds = _loaders(synthetic_msvd, get_loader)
    want = jfc.DeviceFeatureCache(jds, dtype=dtype, frame_buckets=(12,))
    got = tfc.DeviceFeatureCache(tds, dtype=dtype, device="cpu", frame_buckets=(12,))
    assert got.row_of == want.row_of
    assert (got.t_top, got.t_store) == (want.t_top, want.t_store) == (8, 12)
    np.testing.assert_array_equal(got.lengths_np, want.lengths_np)
    assert set(got.arrays()) == set(want.arrays())
    for k, v in want.arrays().items():
        assert str(got.arrays()[k].dtype).split(".")[-1] == str(v.dtype)
        _same(got.arrays()[k], v)
    assert got.nbytes() == want.nbytes()
    np.testing.assert_array_equal(got.caption_rows, want.caption_rows)
    assert len(got.caption_ids) == len(want.caption_ids)
    for a, b in zip(got.caption_ids, want.caption_ids):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tfc.DeviceFeatureCache(tds, dtype="float16", device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_index_batches_and_gather_match_jax(synthetic_msvd, dtype):
    """The loaders' index path (``collate_index_batch`` with the t_store
    clamp, a padded last batch) and ``gather_features`` (dequantize, frame
    mask from lengths, padding rows zeroed) give the JAX package's arrays."""
    jtrain, _, jds = _loaders(synthetic_msvd, jax_get_loader, (4, 8), batch_size=5)
    ttrain, _, tds = _loaders(synthetic_msvd, get_loader, (4, 8), batch_size=5)
    jcache = jfc.DeviceFeatureCache(jds, dtype=dtype, frame_buckets=(4, 8))
    tcache = tfc.DeviceFeatureCache(tds, dtype=dtype, device="cpu", frame_buckets=(4, 8))
    jtrain.attach_feature_cache(jcache)
    ttrain.attach_feature_cache(tcache)
    jbatches, tbatches = list(jtrain), list(ttrain)
    assert len(tbatches) == len(jbatches) == 5
    assert not tbatches[-1]["sample_mask"].all()          # the padded last batch
    for tb, jb in zip(tbatches, jbatches):
        assert set(tb) == set(jb) == {"captions", "video_rows", "sample_mask", "t_pad"}
        assert tb["t_pad"] == jb["t_pad"] and isinstance(tb["t_pad"], int)
        for k in ("captions", "video_rows", "sample_mask"):
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
        got = tfc.gather_features(tcache.arrays(), torch.from_numpy(tb["video_rows"]),
                                  tb["t_pad"], sample_mask=torch.from_numpy(tb["sample_mask"]))
        want = jfc.gather_features(jcache.arrays(), jnp.asarray(jb["video_rows"]), jb["t_pad"],
                                   sample_mask=jnp.asarray(jb["sample_mask"]))
        for g, w in zip(got, want):
            _same(g, w)
    # the clamp: a ladder above the cache's frame capacity
    tb = tfc.collate_index_batch(np.array([0, 1]), tcache.caption_ids[:2], tcache.lengths_np,
                                 (12,), (16,), t_store=tcache.t_store)
    jb = jfc.collate_index_batch(np.array([0, 1]), jcache.caption_ids[:2], jcache.lengths_np,
                                 (12,), (16,), t_store=jcache.t_store)
    assert tb["t_pad"] == jb["t_pad"] == 8


def _small_dual(vocab_size):
    small = dict(rnn_hidden_size=32, embedding_size=16, attn_size=8)
    jm = JaxDual(vocab_size=vocab_size, teacher_forcing_ratio=1.0, reconstructor_type="global",
                 visual_decoder_config=DecoderConfig(in_feature_size=2048, **small),
                 audio_decoder_config=DecoderConfig(in_feature_size=128, **small))
    tm = AVCaptioningDual(vocab_size=vocab_size, teacher_forcing_ratio=1.0,
                          reconstructor_type="global",
                          visual_decoder_config=TDecoderConfig(in_feature_size=2048, **small),
                          audio_decoder_config=TDecoderConfig(in_feature_size=128, **small),
                          device="cpu")
    return tm, jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("buckets,epochs,masked", [((8,), 2, True), ((12,), 1, False)],
                         ids=["masked", "unmasked_oversize_bucket"])
def test_cached_fit_matches_uncached(synthetic_msvd, tmp_path, buckets, epochs, masked):
    """``device_feature_cache=True`` against the same fit uncached
    (``tests/test_trainer.py:158`` and ``:204``): the same per-epoch train
    and val losses within rtol 1e-5.  With ``mask_padded_features=False``
    and a bucket above the longest clip the zero frames are attended, so
    the cache must pad to the same bucket."""
    from mvc_tpu_torch.training.trainer import Trainer

    histories, caches = {}, {}
    for cached in (False, True):
        train, val, ds = _loaders(synthetic_msvd, get_loader, frame_buckets=buckets)
        tm, params = _small_dual(len(ds.vocab))
        cfg = TrainerConfig(epochs=epochs, batch_size=6, lr=5e-3, frame_buckets=buckets,
                            caption_buckets=(12,), eval_max_caption_len=12, transfer_dtype=None,
                            mask_padded_features=masked, device_feature_cache=cached)
        trainer = Trainer(str(tmp_path / f"c{cached}.ckpt"), log_dir=None, eval_freq=epochs)
        _, _, histories[cached] = trainer.fit(tm, from_numpy_tree(params), train, val, val, cfg)
        caches[cached] = train.feature_cache
    assert caches[False] is None and caches[True] is not None
    assert caches[True].t_store == buckets[0]
    for e in range(epochs):
        for phase in ("train_loss", "val_loss"):
            for k in ("total", "ce", "a_recon", "v_recon"):
                np.testing.assert_allclose(histories[True][phase][e][k],
                                           histories[False][phase][e][k], rtol=1e-5, atol=1e-6)


def test_int8_put_batch_matches_jax():
    """``transfer_dtype="int8"``: the host quantize, the copy of payload and
    scales, and the dequantize on the device give the JAX trainer's batch
    bit for bit; the scales leave the batch."""
    from mvc_tpu.training.trainer import Trainer as JaxTrainer
    from mvc_tpu_torch.training.trainer import Trainer

    rng = np.random.default_rng(3)
    batch = {"audio": rng.normal(size=(3, 4, 128)).astype(np.float32) * 5,
             "visual": rng.normal(size=(3, 4, 2048)).astype(np.float32),
             "captions": np.ones((6, 3), np.int32), "feat_mask": np.ones((3, 4), bool),
             "sample_mask": np.array([True, True, False]), "video_ids": ["a", "b", ""]}
    batch["visual"][2] = 0.0                            # a padding row: scale 1.0
    jt = JaxTrainer("unused.ckpt", log_dir=None)
    jt._transfer_int8 = True
    want = jt._put_batch(batch)
    tt = Trainer("unused.ckpt", log_dir=None)
    tt._transfer_int8 = True
    got = tt._put_batch(batch, torch.device("cpu"))
    assert set(got) == set(want)
    for k in ("audio", "visual", "captions", "feat_mask", "sample_mask"):
        assert got[k].dtype == {"audio": torch.float32, "visual": torch.float32,
                                "captions": torch.int32, "feat_mask": torch.bool,
                                "sample_mask": torch.bool}[k]
        _same(got[k], want[k])
    assert got["_n_real"] == want["_n_real"] == 2 and got["video_ids"] == batch["video_ids"]


def test_bf16_adam_state_matches_jax_over_steps_with_an_lr_change():
    """``adam_state_dtype="bfloat16"``: the moments are stored in bf16 and
    equal the JAX chain's bit for bit after every step; the parameters stay
    within rtol 1e-6.  The learning rate changes midway."""
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = [rng.normal(size=s).astype(np.float32) for s in shapes.values()]
    grads = [[rng.normal(size=s).astype(np.float32) * 3 for s in shapes.values()]
             for _ in range(6)]
    kw = dict(lr=1e-2, weight_decay=1e-5, gradient_clip_value=5.0, adam_state_dtype="bfloat16")
    jtx = jopt.make_optimizer(JaxTrainerConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    js = jtx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = topt.make_optimizer(TrainerConfig(**kw), dict(zip(shapes, tp)))
    for i, g in enumerate(grads):
        if i == 3:
            js = jopt.set_learning_rate(js, 3e-3)
            topt.set_learning_rate(opt, 3e-3)
        updates, js = jtx.update([jnp.asarray(x) for x in g], js, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        amsgrad = js.inner_state[-2]
        for k in ("mu", "nu", "nu_max"):
            for got, want in zip([opt.inner.state[p][k] for p in tp], getattr(amsgrad, k)):
                assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
                _same(got, want)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert opt.inner.moment_bytes() == 3 * 2 * n
    # the state survives the port's checkpoint format in bf16
    again = topt.make_optimizer(TrainerConfig(**kw), {k: p.detach().clone() for k, p in zip(shapes, tp)})
    again.load_state_dict(pickle.loads(pickle.dumps(opt.state_dict())))
    for p, q in zip(tp, again.leaves):
        for k in ("mu", "nu", "nu_max"):
            assert again.inner.state[q][k].dtype == torch.bfloat16
            assert torch.equal(again.inner.state[q][k], opt.inner.state[p][k])


def test_profiler_hook_traces_the_first_epoch(synthetic_msvd, tmp_path, monkeypatch):
    """With ``MVC_PROFILE_DIR`` set, the first epoch's train loop is written
    there as a Chrome trace; a later epoch is not traced."""
    from mvc_tpu_torch.training.trainer import Trainer

    train, _, ds = _loaders(synthetic_msvd, get_loader)
    tm, params = _small_dual(len(ds.vocab))
    cfg = TrainerConfig(batch_size=6, transfer_dtype="int8")
    out = tmp_path / "prof"
    monkeypatch.setenv("MVC_PROFILE_DIR", str(out))
    tt = Trainer("unused.ckpt", log_dir=None)
    tt._transfer_int8 = True
    tp = from_numpy_tree(params)
    opt = topt.make_optimizer(cfg, tp)
    tt._train_step, _ = tt._build_train_step(tm, cfg)
    for epoch in (1, 2):
        tp, opt, avg = tt.train(tm, tp, opt, train, epoch, torch.Generator())
        assert np.isfinite(avg["total"])
    assert sorted(os.listdir(out)) == ["train_epoch1.trace.json"]
    with open(out / "train_epoch1.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trainer_config_copies_name_the_same_transfer_and_state_knobs():
    jcfg, tcfg = JaxTrainerConfig(), TrainerConfig()
    for k in ("transfer_dtype", "device_feature_cache", "adam_state_dtype",
              "mask_padded_features", "device_prefetch"):
        assert getattr(tcfg, k) == getattr(jcfg, k)
    with pytest.raises(ValueError):
        topt.make_optimizer(dataclasses.replace(tcfg, adam_state_dtype="float16"),
                            {"w": torch.zeros(2)})
