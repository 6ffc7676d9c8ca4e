"""The port's caption scorers against the JAX package's: ``NLPScore`` and
each scorer's per-video scores, exactly equal on the fixture captions, with
and without METEOR's optional tables (read from files, as the trainer's
``meteor_*`` paths are)."""

import numpy as np
import pytest

import mvc_tpu.evalcap as jev
import mvc_tpu_torch.evalcap as tev
from mvc_tpu.data import dataset as jds
from mvc_tpu.data.dataset import VideoCaptioningDataset


def _gt_and_hypotheses(synthetic_msvd):
    ds = VideoCaptioningDataset(str(synthetic_msvd), "MSVD", "train", verbose=False,
                                vocab_path=str(synthetic_msvd / "metadata" / "vocab.json"))
    gt = jds.video_dataset_to_video_captions_loader(ds).dataset.vid_cap_dict
    rng = np.random.default_rng(0)
    words = sorted({w for caps in gt.values() for c in caps for w in c.split()})
    hypo = {}
    for i, (vid, caps) in enumerate(gt.items()):
        if i % 3 == 0:
            hypo[vid] = [caps[0]]                                   # an exact match
        elif i % 3 == 1:
            hypo[vid] = [" ".join(rng.choice(words, size=int(rng.integers(3, 9))))]
        else:
            hypo[vid] = [caps[-1].replace("a ", "the ", 1) + " playing"]
    return gt, hypo


@pytest.mark.parametrize("tables", [False, True], ids=["plain", "meteor_tables"])
def test_nlpscore_equals_the_jax_package(synthetic_msvd, tmp_path, tables):
    gt, hypo = _gt_and_hypotheses(synthetic_msvd)
    kw = {}
    if tables:
        (tmp_path / "syn.txt").write_text("guitar music\nman person someone\nruns running\n")
        (tmp_path / "para.txt").write_text("is playing ||| plays\na dog ||| the dog\n")
        (tmp_path / "fw.txt").write_text("a\nthe\nis\non\nin\n")
        kw = dict(meteor_synonyms=str(tmp_path / "syn.txt"),
                  meteor_paraphrases=str(tmp_path / "para.txt"),
                  meteor_function_words=str(tmp_path / "fw.txt"))
    got = tev.NLPScore(gt, hypo, **kw)
    want = jev.NLPScore(gt, hypo, **kw)
    assert set(got) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    assert got == want
    assert 0 < got["CIDEr"] and 0 < got["METEOR"] < 1


def test_each_scorer_per_video_equals_the_jax_package(synthetic_msvd):
    gt, hypo = _gt_and_hypotheses(synthetic_msvd)
    for tcls, jcls in ((tev.Bleu, jev.Bleu), (tev.Cider, jev.Cider), (tev.Rouge, jev.Rouge),
                       (tev.Meteor, jev.Meteor)):
        t_score, t_each = tcls().compute_score(gt, hypo)
        j_score, j_each = jcls().compute_score(gt, hypo)
        assert t_score == j_score, tcls.__name__
        np.testing.assert_array_equal(np.asarray(t_each), np.asarray(j_each))
