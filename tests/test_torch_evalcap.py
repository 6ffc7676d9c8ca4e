"""The port's caption scorers against the JAX package's: ``NLPScore`` and
each scorer's per-video scores, exactly equal on the fixture captions, with
and without METEOR's optional tables (read from files, as the trainer's
``meteor_*`` paths are); the PTB tokenizer, SPICE's scene graphs and tuple
scores, and the ``COCOEvalCap`` harness, exactly equal."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import mvc_tpu.evalcap as jev
import mvc_tpu_torch.evalcap as tev
from mvc_tpu.data import dataset as jds
from mvc_tpu.data.dataset import VideoCaptioningDataset
from mvc_tpu.evalcap import spice as jspice
from mvc_tpu.evalcap.eval import COCOEvalCap as JCOCOEvalCap
from mvc_tpu.evalcap.meteor import SynonymTable as JSynonymTable
from mvc_tpu.evalcap.tokenizer import PTBTokenizer as JPTBTokenizer
from mvc_tpu_torch.evalcap import spice as tspice
from mvc_tpu_torch.evalcap.meteor import SynonymTable as TSynonymTable


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


# ---------------------------------------------------------- PTB tokenizer

PTB_CORPUS = {
    "punctuation": ["A man, a plan; a canal: Panama!", "Is it? Yes -- it is.", "well - ok ."],
    "contractions": ["The dog's ball isn't red", "They're here, we've won, I'd go, I'm in",
                     "you'll see it can't be"],
    "brackets": ["a man (in a hat) {waves}", "[sic] (a) {b}"],
    "numbers": ["2 dogs and 3.5 cats cost 1,200 dollars", "route 66 at 10:30"],
    "ellipses": ["and then... nothing", "wait...what ... ok"],
    "mixed_case": ["A MAN Is Playing THE Guitar", "McDonald's OK'd it"],
}


@pytest.mark.parametrize("kind", sorted(PTB_CORPUS))
def test_ptb_tokenizer_equals_the_jax_package(kind):
    caps = {f"v{i}": [{"caption": c}] for i, c in enumerate(PTB_CORPUS[kind])}
    got = tev.PTBTokenizer().tokenize(caps)
    assert got == JPTBTokenizer().tokenize(caps)
    assert all(isinstance(v[0], str) for v in got.values())


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=126), max_size=60))
def test_ptb_tokenizer_property_equals_the_jax_package(text):
    caps = {"v": [{"caption": text}]}
    assert tev.PTBTokenizer().tokenize(caps) == JPTBTokenizer().tokenize(caps)


# ------------------------------------------------------------------ SPICE
LEXICON = """# word pos[,pos...] [lemma]
man noun
men noun man
woman noun
guitar noun
dog noun
ball noun
soccer noun
stage noun
park noun
playing verb play
plays verb play
riding verb ride
running verb run
kicking verb kick
sitting verb sit
red adj
big adj
large adj
happy adj
quickly adv
cooking verb,noun cook
young adj
girl noun
standing verb
tennis noun
court noun
giraffe noun
green adj
field noun
"""

SPICE_SENTENCES = [
    "a man is playing a guitar on stage",
    "two happy men riding a big red ball",
    "the dog is happy",
    "a man kicking a soccer ball",
    "a man plays a guitar",
    "men playing a guitar",
    "a dog running quickly in the park",
    "a man is cooking",
    "the cooking is happy",
    "a young girl standing on top of a tennis court",
    "a giraffe standing on top of a green field",
    "a woman sitting next to a dog in front of the stage",
]


@pytest.fixture
def lexicon_path(tmp_path):
    p = tmp_path / "lexicon.txt"
    p.write_text(LEXICON)
    return str(p)


@pytest.mark.parametrize("sentence", SPICE_SENTENCES)
def test_spice_scene_graph_equals_the_jax_package(lexicon_path, sentence):
    got = tspice.parse_scene_graph(sentence, tspice.PosLexicon.load(lexicon_path))
    assert got == jspice.parse_scene_graph(sentence, jspice.PosLexicon.load(lexicon_path))
    assert got


@pytest.mark.parametrize("synonyms", [None, [["girl", "giraffe"], ["court", "field"],
                                             ["man", "men", "woman"], ["big", "large"]]],
                         ids=["exact", "synonyms"])
def test_spice_score_tuples_equals_the_jax_package(lexicon_path, synonyms):
    tlex, jlex = tspice.PosLexicon.load(lexicon_path), jspice.PosLexicon.load(lexicon_path)
    tsyn = TSynonymTable(synonyms) if synonyms else None
    jsyn = JSynonymTable(synonyms) if synonyms else None
    for i, cand in enumerate(SPICE_SENTENCES):
        refs = [SPICE_SENTENCES[(i + k) % len(SPICE_SENTENCES)] for k in (1, 5, 9)]
        got = tspice.score_tuples(tspice.parse_scene_graph(cand, tlex),
                                  [tspice.parse_scene_graph(r, tlex) for r in refs], tsyn)
        want = jspice.score_tuples(jspice.parse_scene_graph(cand, jlex),
                                   [jspice.parse_scene_graph(r, jlex) for r in refs], jsyn)
        assert got == want


def test_spice_raises_without_a_lexicon(monkeypatch):
    monkeypatch.delenv("MVC_SPICE_LEXICON", raising=False)
    with pytest.raises(NotImplementedError):
        tev.Spice().compute_score({"v": ["a dog"]}, {"v": ["a dog"]})


COCO_GTS = {
    "v1": ["A man is playing a guitar on stage.", "A man plays the guitar!"],
    "v2": ["A dog running quickly in the park.", "The dog's running (fast)."],
    "v3": ["A young girl standing on top of a tennis court...", "A girl on a court"],
    "v4": ["Two happy men riding a big red ball", "men ride a ball"],
}
COCO_RES = {
    "v1": ["A man is playing a guitar."],
    "v2": ["A dog sitting in the park"],
    "v3": ["a giraffe standing on top of a green field"],
    "v4": ["two men riding a large ball"],
}


@pytest.mark.parametrize("spice,tables", [(False, False), (False, True), (True, False),
                                          (True, True)],
                         ids=["plain", "meteor_tables", "spice", "spice_and_tables"])
def test_cocoevalcap_equals_the_jax_package(tmp_path, monkeypatch, lexicon_path, spice, tables):
    monkeypatch.delenv("MVC_SPICE_LEXICON", raising=False)
    monkeypatch.delenv("MVC_SPICE_SYNONYMS", raising=False)
    kw = {}
    if tables:
        (tmp_path / "syn.txt").write_text("guitar music\nman person men\ngirl giraffe\n")
        (tmp_path / "para.txt").write_text("is playing ||| plays\na dog ||| the dog\n")
        (tmp_path / "fw.txt").write_text("a\nthe\nis\non\nin\n")
        kw = dict(meteor_synonyms=str(tmp_path / "syn.txt"),
                  meteor_paraphrases=str(tmp_path / "para.txt"),
                  meteor_function_words=str(tmp_path / "fw.txt"))
        if spice:
            kw["spice_synonyms"] = str(tmp_path / "syn.txt")
    if spice:
        kw["spice_lexicon"] = lexicon_path
    got, want = tev.COCOEvalCap(COCO_GTS, COCO_RES, **kw), JCOCOEvalCap(COCO_GTS, COCO_RES, **kw)
    assert got.evaluate() == want.evaluate()
    assert got.eval == want.eval and got.imgToEval == want.imgToEval
    assert ("SPICE" in got.eval) == spice
    assert set(got.imgToEval) == set(COCO_GTS)


def test_cocoevalcap_reads_the_spice_lexicon_from_the_environment(monkeypatch, lexicon_path):
    monkeypatch.setenv("MVC_SPICE_LEXICON", lexicon_path)
    monkeypatch.delenv("MVC_SPICE_SYNONYMS", raising=False)
    got = tev.COCOEvalCap(COCO_GTS, COCO_RES).evaluate()
    assert 0.0 < got["SPICE"] <= 1.0
    assert got["SPICE"] == tspice.Spice().compute_score(
        tev.PTBTokenizer().tokenize({k: [{"caption": c} for c in v] for k, v in COCO_GTS.items()}),
        tev.PTBTokenizer().tokenize({k: [{"caption": c} for c in v] for k, v in COCO_RES.items()}),
    )[0]
