"""The port's data layer (no pandas) against the JAX package's on the
``synthetic_msvd`` fixture: metadata rows and their order, tokenizer,
vocabulary, clip features, collation and both loaders' batches, exactly."""

import json
from pathlib import Path

import numpy as np
import pytest

from mvc_tpu.data import dataset as jds
from mvc_tpu.data import get_loader as jax_get_loader
from mvc_tpu.data import metadata as jmeta
from mvc_tpu.data.tokenizer import _fallback_tokenize as jax_tokenize
from mvc_tpu.data.vocabulary import Vocabulary as JaxVocabulary
from mvc_tpu_torch.data import Vocabulary, get_loader
from mvc_tpu_torch.data import dataset as tds
from mvc_tpu_torch.data import metadata as tmeta
from mvc_tpu_torch.data.tokenizer import tokenize


def _rows(df):
    return list(zip(df["video_id"].tolist(), df["caption"].tolist()))


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("split", ["train", "tiny"])
def test_msvd_metadata_rows_and_order_match_jax(synthetic_msvd, split):
    got = tmeta.read_msvd_metadata(str(synthetic_msvd), split, verbose=False)
    want = _rows(jmeta.read_msvd_metadata(str(synthetic_msvd), split, verbose=False))
    assert got == want
    # the integrity filter drops the row without features, the source
    # filter the unverified one
    assert all(vid != "ghost_0_10" for vid, _ in got) and "bad row" not in [c for _, c in got]


def test_msr_vtt_metadata_matches_jax(tmp_path):
    (tmp_path / "metadata").mkdir()
    sentences = [{"video_id": f"video{i}", "caption": f"caption number {i} of {j}"}
                 for i in (0, 5, 6512, 6513, 7008, 7009, 7010, 9998) for j in range(2)]
    for name in ("train_val_videodatainfo.json", "test_videodatainfo.json"):
        (tmp_path / "metadata" / name).write_text(json.dumps({"sentences": sentences}))
    for split in ("train", "val", "test"):
        got = tmeta.read_msr_vtt_metadata(str(tmp_path), split, verbose=False)
        assert got == _rows(jmeta.read_msr_vtt_metadata(str(tmp_path), split, verbose=False))
        assert got


def test_tokenizer_and_vocabulary_match_jax(tmp_path):
    from conftest import CAPTIONS

    fixture = json.loads((Path(__file__).parent / "fixtures" / "spacy_tokens.json").read_text())
    fixture = fixture["cases"]
    texts = CAPTIONS + [c["text"] for c in fixture] + [
        "A man's dog can't run... well-known e.g. things!", "  (quoted) \"words\" , ok.  "]
    for text in texts:
        assert tokenize(text) == jax_tokenize(text), text
    for threshold in (1, 2, 3):
        jv, tv = JaxVocabulary(threshold), Vocabulary(threshold)
        jv.build_vocabulary(texts)
        tv.build_vocabulary(texts)
        assert tv.itos == jv.itos and tv.stoi == jv.stoi
        for text in texts[:8] + ["an unseen zebra word"]:
            assert tv.numericalize(text) == jv.numericalize(text)
            assert tv.encode_caption(text) == jv.encode_caption(text)
            assert tv.apply_vocab(text) == jv.apply_vocab(text)
    path = tmp_path / "vocab_port.json"
    Vocabulary.prebuild(CAPTIONS, str(path), freq_threshold=2)
    want = JaxVocabulary(2)
    want.build_vocabulary(CAPTIONS)
    assert JaxVocabulary.load(str(path)).itos == want.itos


def test_clip_features_and_collation_match_jax(synthetic_msvd):
    root = str(synthetic_msvd)
    for vid in ("vid000_0_10", "vid001_0_10"):                 # 1-frame audio; T+1 audio
        for kw in ({}, {"normalize": True}, {"video_only": True}):
            for g, w in zip(tds.load_clip_features(root, vid, **kw),
                            jds.load_clip_features(root, vid, **kw)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    kw = dict(dataset="MSVD", split="train", vocab_path=str(synthetic_msvd / "metadata" /
                                                             "vocab.json"), verbose=False)
    tset, jset = tds.VideoCaptioningDataset(root, **kw), jds.VideoCaptioningDataset(root, **kw)
    assert len(tset) == len(jset)
    items_t, items_j = [tset[i] for i in range(5)], [jset[i] for i in range(5)]
    for a, b in zip(items_t, items_j):
        _same_batch(a, b)
    for pad in (None, 8):
        _same_batch(tds.collate_av_batch(items_t, pad_batch_to=pad),
                    jds.collate_av_batch(items_j, pad_batch_to=pad))
    # a vocabulary built from the split when no path is given
    kw.pop("vocab_path")
    assert (tds.VideoCaptioningDataset(root, freq_threshold=1, **kw).vocab.itos
            == jds.VideoCaptioningDataset(root, freq_threshold=1, **kw).vocab.itos)


@pytest.mark.parametrize("bucket_by_length", [False, True])
def test_train_and_eval_loader_batches_match_jax(synthetic_msvd, bucket_by_length):
    root, vocab = str(synthetic_msvd), str(synthetic_msvd / "metadata" / "vocab.json")
    kw = dict(batch_size=5, vocab_path=vocab, verbose=False, seed=3,
              bucket_by_length=bucket_by_length)
    tl, tset = get_loader(root, "MSVD", "train", **kw)
    jl, jset = jax_get_loader(root, "MSVD", "train", **kw)
    assert len(tl) == len(jl) == 5
    for _ in range(2):                                          # two epochs, reshuffled
        got, want = list(tl), list(jl)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_batch(g, w)
    # the per-video eval loader: videos in first-seen order, OOV -> "<UNK>"
    tv = tds.video_dataset_to_video_captions_loader(tset, batch_size=4)
    jv = jds.video_dataset_to_video_captions_loader(jset, batch_size=4)
    assert tv.dataset.vid_cap_dict == jv.dataset.vid_cap_dict
    assert list(tv.dataset.vid_cap_dict) == list(jv.dataset.vid_cap_dict)
    for g, w in zip(list(tv), list(jv)):
        _same_batch(g, w)
    assert len(tv) == len(jv)
