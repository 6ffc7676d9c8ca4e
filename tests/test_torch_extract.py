"""The port's extraction stage against the JAX package's, on the CPU, on
numpy-seeded inputs: the log-mel frontend (filterbank exact, examples
within 1e-5), the resize (1e-2 on 0..255 frames), VGGish (1e-5 relative
in norm; after PCA within one 8-bit quantum), the cv2 decode (bit for
bit), the wav/silence audio path, the synthetic clip writer, the
encoders, and ``FeatureExtractor.extract_dataset`` over tiny synthetic
clips (features within 1e-4, the same counts).  Also: every entry point
runs on the card unless asked for the CPU, and ``mesh=`` is refused."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvc_tpu.extract import encoders as jenc
from mvc_tpu.extract import synthetic as jsyn
from mvc_tpu.extract import video_io as jio
from mvc_tpu.extract.features import FeatureExtractor as JFeatureExtractor
from mvc_tpu.models import vggish as jvg
from mvc_tpu.ops import logmel as jlm
from mvc_tpu.ops import resize as jrs
from mvc_tpu_torch.extract import encoders as tenc
from mvc_tpu_torch.extract import synthetic as tsyn
from mvc_tpu_torch.extract import video_io as tio
from mvc_tpu_torch.extract.features import FeatureExtractor
from mvc_tpu_torch.models import inception_v3 as tiv3
from mvc_tpu_torch.models import vggish as tvg
from mvc_tpu_torch.ops import logmel as tlm
from mvc_tpu_torch.ops import resize as trs
from mvc_tpu_torch.utils.jax_weights import encoder_to_jax


def _rel_err_in_norm(got, want):
    return float((np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)).max())


# ----------------------------------------------------------------- log-mel
def test_mel_filterbank_is_exact():
    got, want = tlm.mel_filterbank(), jlm.mel_filterbank()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_examples,n_samples", [(1, 8000), (2, 2 * 16000 + 517), (4, 70000)],
                         ids=["padded", "ragged", "truncated"])
def test_log_mel_examples_batch_equals_the_jax_package(n_examples, n_samples):
    wavs = (0.3 * np.random.default_rng(n_samples).standard_normal((3, n_samples))
            ).astype(np.float32)
    want = np.asarray(jlm.log_mel_examples_batch(jnp.asarray(wavs), n_examples))
    got = tlm.log_mel_examples_batch(torch.from_numpy(wavs), n_examples)
    assert got.shape == want.shape == (3, n_examples, 96, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    one = tlm.log_mel_examples(torch.from_numpy(wavs[1]), n_examples)
    np.testing.assert_array_equal(one.numpy(), got[1].numpy())


def test_sample_and_example_counts_equal_the_jax_package():
    for n in range(0, 80_000, 97):
        assert tlm.num_examples_for(n) == jlm.num_examples_for(n), n
    for k in range(0, 40):
        assert tlm.samples_for(k) == jlm.samples_for(k), k


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("src,dst", [((240, 320), (299, 299)), ((480, 640), (299, 299)),
                                     ((100, 100), (37, 53)), ((40, 50), (224, 224))],
                         ids=["down_240p", "down_480p", "down_odd", "up"])
def test_resize_frames_equals_the_jax_package(src, dst):
    frames = np.random.default_rng(sum(src)).integers(0, 256, (2, *src, 3)).astype(np.uint8)
    want = np.asarray(jrs.resize_frames(jnp.asarray(frames), *dst))
    got = trs.resize_frames(torch.from_numpy(frames), *dst)
    assert got.shape == want.shape == (2, *dst, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)


# ------------------------------------------------------------------ VGGish
def _vggish_trees(pca: bool):
    """(port tree, JAX tree) of the same seeded weights; the PCA matrix is
    a scaled rotation, as AudioSet's whitening is."""
    port = tvg.init_vggish(torch.Generator().manual_seed(7))
    if pca:
        rng = np.random.default_rng(8)
        q, _ = np.linalg.qr(rng.standard_normal((128, 128)))
        port["pca"] = {"matrix": torch.from_numpy((40.0 * q).astype(np.float32)),
                       "means": torch.from_numpy(
                           (0.02 * rng.standard_normal((128, 1))).astype(np.float32))}
    return port, encoder_to_jax(port)


@pytest.mark.parametrize("pca", [False, True], ids=["embeddings", "pca_quantized"])
def test_vggish_equals_the_jax_package(pca):
    port, jtree = _vggish_trees(pca)
    examples = np.random.default_rng(9).standard_normal((6, 96, 64)).astype(np.float32) - 2.0
    raw_want = np.asarray(jvg.vggish_embeddings(jtree, jnp.asarray(examples), postprocess=False))
    with torch.no_grad():
        raw = tvg.vggish_embeddings(port, torch.from_numpy(examples), postprocess=False).numpy()
        got = tvg.vggish_embeddings(port, torch.from_numpy(examples)).numpy()
    assert raw.shape == (6, 128)
    assert _rel_err_in_norm(raw, raw_want) < 1e-5
    want = np.asarray(jvg.vggish_embeddings(jtree, jnp.asarray(examples)))
    if not pca:
        np.testing.assert_array_equal(got, raw)
        return
    assert np.array_equal(got, np.round(got)) and got.min() >= 0 and got.max() <= 255
    assert np.unique(got).size > 32             # spread over the 8-bit range, not clipped
    diff = np.abs(got - want)
    assert diff.max() <= 1.0                    # one quantum at most ...
    assert (diff > 0).mean() <= 0.01            # ... on at most 1 % of the values


# ------------------------------------------------------------------ decode
def _write_clip(path, codec="MJPG", n_frames=25, fps=8, size=(64, 48)):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*codec), fps, size)
    if not w.isOpened():
        pytest.skip(f"cv2 VideoWriter cannot encode {codec} here")
    gen = np.random.default_rng(0)
    for _ in range(n_frames):
        w.write(gen.integers(0, 255, size=(size[1], size[0], 3), dtype=np.uint8))
    w.release()
    return str(path)


@pytest.mark.parametrize("fps", [1, None], ids=["fps1", "every_frame"])
def test_load_frames_equals_the_jax_package_bit_for_bit(tmp_path, fps):
    path = _write_clip(tmp_path / "clip_0_3.avi")
    got, dur = tio.load_frames(path, frame_size=(75, 75), fps=fps)
    want, want_dur = jio.load_frames(path, frame_size=(75, 75), fps=fps)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[0] == (4 if fps == 1 else 25)   # stride 25 // 3: frames 0, 8, 16, 24
    np.testing.assert_array_equal(got, want)
    assert dur == want_dur


@pytest.mark.parametrize("sidecar", [True, False], ids=["wav_sidecar", "silence"])
def test_load_audio_equals_the_jax_package(tmp_path, monkeypatch, sidecar):
    monkeypatch.delenv("MVC_FFMPEG", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))              # no ffmpeg to demux with
    (tmp_path / "videos").mkdir()
    (tmp_path / "audios").mkdir()
    video = str(tmp_path / "videos" / "clip_0_2.avi")
    if sidecar:
        wav = (0.4 * np.sin(np.arange(44100 * 2) / 7.0)).astype(np.float32)
        tsyn.write_wav(str(tmp_path / "audios" / "clip_0_2.wav"), wav, sr=44100)
    got = tio.load_audio(video, duration_hint=2.5)
    want = jio.load_audio(video, duration_hint=2.5)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.shape == ((32000,) if sidecar else (40000,))
    assert sidecar == bool(np.abs(got).max() > 0)


def test_synthetic_clip_set_equals_the_jax_package(tmp_path):
    pytest.importorskip("cv2")
    try:
        names = tsyn.make_clip_set(str(tmp_path / "port"), 2, seconds=2.0, fps=5, size=(64, 48))
    except RuntimeError as e:
        pytest.skip(str(e))
    assert names == jsyn.make_clip_set(str(tmp_path / "jax"), 2, seconds=2.0, fps=5,
                                       size=(64, 48))
    for name in names:
        stem = os.path.splitext(name)[0]
        for rel in (f"videos/{name}", f"audios/{stem}.wav"):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


# ---------------------------------------------------------------- encoders
SMALL_FRAME = (75, 75)       # Inception's smallest input: keeps the CPU run short


@pytest.fixture(scope="module")
def weights():
    """The port's seeded Inception-v3 and VGGish trees and their JAX twins."""
    iv3 = tiv3.init_inception_v3(torch.Generator().manual_seed(0))
    vg = tvg.init_vggish(torch.Generator().manual_seed(1))
    return {"port": (iv3, vg), "jax": (encoder_to_jax(iv3), encoder_to_jax(vg))}


def test_visual_encoder_on_stacked_frames_equals_the_jax_package(weights):
    frames = np.random.default_rng(10).integers(0, 256, (2, 3, *SMALL_FRAME, 3)).astype(np.uint8)
    got = tenc.VisualEncoder(params=weights["port"][0], device="cpu")(frames)
    want = jenc.VisualEncoder(params=weights["jax"][0])(frames)
    assert got.shape == want.shape == (2, 3, 2048) and got.dtype == np.float32
    assert _rel_err_in_norm(got, want) < 1e-4


def test_audio_encoder_resamples_channels_first_audio_like_the_jax_package(weights):
    stereo = (0.2 * np.random.default_rng(11).standard_normal((2, 44100 * 2))).astype(np.float32)
    got = tenc.AudioEncoder(params=weights["port"][1], device="cpu").from_tensor(stereo, 44100)
    want = jenc.AudioEncoder(params=weights["jax"][1]).from_tensor(stereo, 44100)
    assert got.shape == want.shape == (2, 128)
    assert _rel_err_in_norm(got, want) < 1e-5


# ---------------------------------------------------------------- extractor
def _clip_set(root, n):
    pytest.importorskip("cv2")
    try:
        return tsyn.make_clip_set(str(root), n, seconds=3.0, fps=4, size=(64, 48), seed=3)
    except RuntimeError as e:
        pytest.skip(str(e))


def _small(fe):
    fe.frame_size = SMALL_FRAME
    return fe


def test_extract_dataset_equals_the_jax_package(tmp_path, weights):
    _clip_set(tmp_path, 3)
    os.remove(tmp_path / "audios" / "clip002_0_3.wav")        # a mute clip: silence
    kw = dict(frame_buckets=(8, 16), audio_buckets=(4, 8), decode_workers=2)
    port = _small(FeatureExtractor(*weights["port"], device="cpu", **kw))
    stats = port.extract_dataset(str(tmp_path / "videos"), str(tmp_path / "port"), batch_size=2,
                                 verbose=False)
    jfe = _small(JFeatureExtractor(*weights["jax"], **kw))
    want = jfe.extract_dataset(str(tmp_path / "videos"), str(tmp_path / "jax"), batch_size=2,
                               verbose=False)
    assert set(stats) == set(want) == {"done", "skipped", "failures", "decode_s", "encode_s"}
    assert {k: stats[k] for k in ("done", "skipped", "failures")} == \
        {k: want[k] for k in ("done", "skipped", "failures")} == \
        {"done": 3, "skipped": 0, "failures": 0}
    assert stats["decode_s"] > 0 and stats["encode_s"] > 0
    for kind, width in (("video", 2048), ("audio", 128)):
        for i in range(3):
            got = np.load(tmp_path / "port" / kind / f"clip{i:03d}_0_3.npy")
            exp = np.load(tmp_path / "jax" / kind / f"clip{i:03d}_0_3.npy")
            assert got.dtype == np.float32 and got.shape == exp.shape == (3, width)
            assert _rel_err_in_norm(got, exp) < 1e-4, (kind, i)
    silent = np.load(tmp_path / "port" / "audio" / "clip002_0_3.npy")
    np.testing.assert_allclose(silent, silent[:1].repeat(3, 0), rtol=0, atol=1e-6)


def test_extract_dataset_skips_existing_and_isolates_a_bad_clip(tmp_path, weights):
    _clip_set(tmp_path, 2)
    kw = dict(frame_buckets=(8,), audio_buckets=(4,), decode_workers=1, device="cpu")
    fe = _small(FeatureExtractor(*weights["port"], **kw))
    first = fe.extract_dataset(str(tmp_path / "videos"), str(tmp_path / "f"), batch_size=1,
                               verbose=False)
    assert (first["done"], first["skipped"], first["failures"]) == (2, 0, 0)
    (tmp_path / "videos" / "broken_0_3.avi").write_bytes(b"not a video")
    _write_clip(tmp_path / "videos" / "late_0_3.avi", n_frames=12, fps=4)
    again = fe.extract_dataset(str(tmp_path / "videos"), str(tmp_path / "f"), batch_size=2,
                               verbose=False)
    assert (again["done"], again["skipped"], again["failures"]) == (1, 2, 1)
    assert np.load(tmp_path / "f" / "video" / "late_0_3.npy").shape == (3, 2048)
    assert not (tmp_path / "f" / "video" / "broken_0_3.npy").exists()
    one, one_audio = fe.extract(str(tmp_path / "videos" / "late_0_3.avi"), fps=2)
    assert one.shape == (6, 2048) and one_audio.shape == (3, 128)


def test_frame_buckets_round_up_above_the_top_bucket():
    from mvc_tpu.extract.features import _bucket as jbucket
    from mvc_tpu_torch.extract.features import _bucket

    for n in (1, 64, 65, 128, 129, 256, 257, 512, 513, 700):
        assert _bucket(n, (64, 128, 256)) == jbucket(n, (64, 128, 256))
    assert [_bucket(n, (64, 128, 256)) for n in (80, 160, 320)] == [128, 256, 512]


def test_extractor_refuses_a_mesh(tmp_path, weights):
    """Since the mesh is ported the extractor takes one: over two CPU shards
    the features equal the meshless extractor's (within 1e-5 relative in
    norm), and a mesh that does not start at the extractor's device is
    refused."""
    from mvc_tpu_torch.parallel import make_mesh

    _clip_set(tmp_path, 2)
    kw = dict(frame_buckets=(8,), audio_buckets=(3,), decode_workers=1, device="cpu")
    clips = [str(tmp_path / "videos" / f"clip{i:03d}_0_3.avi") for i in range(2)]
    plain = _small(FeatureExtractor(*weights["port"], **kw)).extract_batch(clips)
    fe = _small(FeatureExtractor(*weights["port"], mesh=make_mesh(dp=2, devices=["cpu"] * 2),
                                 **kw))
    assert fe._shard_devices == [torch.device("cpu")] * 2
    for (gv, ga), (wv, wa) in zip(fe.extract_batch(clips), plain):
        assert gv.shape == wv.shape and ga.shape == wa.shape
        assert _rel_err_in_norm(gv, wv) < 1e-5 and _rel_err_in_norm(ga, wa) < 1e-5
    with pytest.raises(ValueError, match="first device"):
        FeatureExtractor(*weights["port"], mesh=make_mesh(dp=1, devices=["meta"]), **kw)


@pytest.mark.parametrize("make", [lambda: FeatureExtractor(), lambda: tenc.VisualEncoder(),
                                  lambda: tenc.AudioEncoder()],
                         ids=["FeatureExtractor", "VisualEncoder", "AudioEncoder"])
def test_entry_points_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


# --------------------------------------------------------------------- CLI
def test_cli_writes_the_files_of_the_root_script(tmp_path, monkeypatch):
    """``python -m mvc_tpu_torch.cli.extract_features --device cpu`` against
    the root ``extract_features.py`` on the same clips and the same weight
    files: the same ``.npy`` files, float32, features within 1e-4.  Both
    extractors get one small frame bucket (8) so the CPU encodes 8 frames at
    299x299, not the default 64; padding frames are dropped either way."""
    import functools
    import importlib.util
    import pickle
    from pathlib import Path

    import mvc_tpu.extract
    import mvc_tpu_torch.extract
    from mvc_tpu.utils import torch_oracles
    from mvc_tpu_torch.cli import extract_features as cli

    data = tmp_path / "MSVD"
    pytest.importorskip("cv2")
    try:
        tsyn.make_clip_set(str(data), 2, seconds=3.0, fps=4, size=(64, 48), seed=4)
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.manual_seed(0)
    with open(tmp_path / "inception.pkl", "wb") as f:
        pickle.dump(torch_oracles.build_torch_inception_v3().state_dict(), f)
    vgg = torch_oracles.build_torch_vggish()
    rng = np.random.default_rng(12)
    payload = {"state_dict": {**{f"features.{k}": v for k, v in vgg.features.state_dict().items()},
                              **{f"embeddings.{k}": v
                                 for k, v in vgg.embeddings.state_dict().items()}},
               "pca": {"matrix": (40.0 * np.linalg.qr(rng.standard_normal((128, 128)))[0]
                                  ).astype(np.float32),
                       "means": np.zeros(128, np.float32)}}
    with open(tmp_path / "vggish.pkl", "wb") as f:
        pickle.dump(payload, f)
    argv = ["--dataset", str(data), "--inception_weights", str(tmp_path / "inception.pkl"),
            "--vggish_weights", str(tmp_path / "vggish.pkl"), "--batch_size", "2"]

    monkeypatch.setattr(mvc_tpu_torch.extract, "FeatureExtractor",
                        functools.partial(FeatureExtractor, frame_buckets=(8,)))
    stats = cli.main(argv + ["--device", "cpu", "--gpu", "0"])
    assert (stats["done"], stats["skipped"], stats["failures"]) == (2, 0, 0)
    port = {p.relative_to(data / "features"): np.load(p)
            for p in sorted((data / "features").rglob("*.npy"))}
    os.rename(data / "features", tmp_path / "port_features")

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("root_extract_features",
                                                  root / "extract_features.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(mvc_tpu.extract, "FeatureExtractor",
                        functools.partial(JFeatureExtractor, frame_buckets=(8,)))
    monkeypatch.setattr("sys.argv", ["extract_features.py", *argv])
    script.main()
    want = {p.relative_to(data / "features"): np.load(p)
            for p in sorted((data / "features").rglob("*.npy"))}
    assert sorted(port) == sorted(want) and len(port) == 4
    for rel, got in port.items():
        assert got.dtype == np.float32 and got.shape == want[rel].shape, rel
        assert got.shape == ((3, 2048) if rel.parts[0] == "video" else (3, 128)), rel
        if rel.parts[0] == "video":
            assert _rel_err_in_norm(got, want[rel]) < 1e-4, rel
        else:                                   # PCA-quantized: one quantum at most
            assert np.abs(got - want[rel]).max() <= 1.0, rel
    again = cli.main(argv + ["--device", "cpu"])      # everything exists now: all skipped
    assert (again["done"], again["skipped"]) == (0, 2)
