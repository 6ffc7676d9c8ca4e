"""The port's native metrics runtime (``mvc_tpu_torch/csrc/native.cpp``
through ``evalcap/_native.py``) against the port's pure-Python paths and
the JAX package's, exactly: the PTB scanner, the METEOR word and span
alignment searches, the LCS, and the scorers built on them.  Random and
edge-case inputs from seeded ``random.Random``s, as ``tests/test_native.py``
does for the JAX extension.  The runtime is built with g++ at first use; a
build failure fails these tests, which skip only where no g++ is on PATH."""

import os
import random
import shutil

import pytest

from mvc_tpu.evalcap import meteor as jm
from mvc_tpu.evalcap import tokenizer as jtok
from mvc_tpu_torch.evalcap import COCOEvalCap, Meteor, Rouge, _native, native_status, use_native
from mvc_tpu_torch.evalcap import meteor as tm
from mvc_tpu_torch.evalcap import rouge as trouge
from mvc_tpu_torch.evalcap import tokenizer as ttok
from mvc_tpu_torch.evalcap.stemmer import porter_stem

WORDS = ["the", "dog", "dogs", "puppy", "canine", "runs", "running", "ran", "sprints", "a",
         "cat", "feline", "kitten", "plays", "played", "guitar", "axe", "man", "guy", "big",
         "large", "huge", "quickly"]
GROUPS = [["dog", "puppy", "canine"], ["cat", "feline", "kitten"], ["runs", "sprints"],
          ["guitar", "axe"], ["man", "guy"], ["big", "large", "huge"], ["large", "giant"]]
PARAPHRASES = [("big dog", "large puppy"), ("plays guitar", "plays the axe"),
               ("a man", "the guy"), ("runs quickly", "sprints"), ("the cat", "a kitten")]
FUNCTION_WORDS = ["the", "a", "quickly"]


@pytest.fixture(scope="module")
def native():
    if not (os.environ.get("CXX") or shutil.which("g++")):
        pytest.skip("no g++ on PATH")
    use_native(True)
    assert _native.library() is not None, native_status()
    return _native


def _sentences(rng, n, lo=0, hi=12):
    return [([rng.choice(WORDS) for _ in range(rng.randint(lo, hi))],
             [rng.choice(WORDS) for _ in range(rng.randint(1, hi))]) for _ in range(n)]


def _ids(table, words):
    return None if table is None else [sorted(table.ids(w)) for w in words]


def test_status_names_the_built_library(native):
    status = native_status()
    assert status["built"] and status["enabled"] and status["error"] is None
    path = status["path"]
    assert os.path.isfile(path) and os.path.basename(path).startswith("libnative-")
    assert os.path.dirname(path).endswith(os.path.join("build", "mvc_tpu_torch"))
    old = use_native(False)
    try:
        assert not _native.available() and not native_status()["enabled"]
    finally:
        use_native(old)
    assert _native.available()


EDGE_LINES = [
    "A man, playing (guitar)!", "don't stop...", "it's 3.5 meters", "n't alone", "rock'n'roll",
    "'Sup", "O'clock at 5 o'clock", "", "   ", "...--...", "a--b", "1,000.50,", "x'", "'s's",
    "can't won't shan't", "{curly} [square] (round)", "tab\there\x1cfs\x1fus\x0bvt", "\x00nul",
    "I'M YOU'RE WE'VE THEY'LL HE'D", "e.g. U.S.A.", "3..4", "''quoted'' ``tex``",
]


@pytest.mark.parametrize("alphabet", ["ascii", "caption"])
def test_ptb_tokenize_equals_both_python_paths(native, alphabet):
    """The scanner's tokens equal the port's Python path and the JAX
    package's, on every ASCII character (controls included) or on
    caption-like text, and on the edge cases."""
    rng = random.Random(0 if alphabet == "ascii" else 1)
    chars = ("".join(chr(c) for c in range(128)) if alphabet == "ascii"
             else "abcdefghijklmnoprstuwy ABC 0123456789 .,!?'()-{}[]:;\"`")
    lines = EDGE_LINES + ["".join(rng.choice(chars) for _ in range(rng.randint(0, 60)))
                          for _ in range(3000)]
    for line in lines:
        want = jtok._ptb_tokenize_line_py(line)
        assert ttok._ptb_tokenize_line_py(line) == want, repr(line)
        assert native.ptb_tokenize(line) == want, repr(line)
        assert ttok.ptb_tokenize_line(line) == want, repr(line)


def test_non_ascii_lines_take_the_python_path(native):
    for line in ("café au lait", "naïve coöperation", "a b", "٣ apples",
                 "İstanbul", "smart ’quotes’"):
        assert ttok.ptb_tokenize_line(line) == jtok._ptb_tokenize_line_py(line), repr(line)
    with pytest.raises(UnicodeEncodeError):
        native.ptb_tokenize("café")


@pytest.mark.parametrize("stage", ["exact_stem", "synonyms"])
def test_meteor_stats_equal_both_python_paths(native, stage):
    """(weighted, matches, chunks) of the alignment search equal the port's
    Python search and the JAX package's, weights bit for bit."""
    rng = random.Random(2 if stage == "exact_stem" else 3)
    ttable = tm.SynonymTable(GROUPS) if stage == "synonyms" else None
    jtable = jm.SynonymTable(GROUPS) if stage == "synonyms" else None
    for hyp, ref in _sentences(rng, 400):
        jmatch = jm._align(hyp, ref, jtable)
        want = (sum(jm._match_weight(hyp[i], ref[j]) for i, j in jmatch), len(jmatch),
                jm._count_chunks(jmatch))
        tmatch = tm._align(hyp, ref, ttable)
        port_py = (sum(tm._match_weight(hyp[i], ref[j]) for i, j in tmatch), len(tmatch),
                   tm._count_chunks(tmatch))
        got = native.meteor_stats(hyp, ref, [porter_stem(w) for w in hyp],
                                  [porter_stem(w) for w in ref], tm.STAGE_WEIGHTS[0],
                                  tm.STAGE_WEIGHTS[1], _ids(ttable, hyp), _ids(ttable, ref),
                                  tm.STAGE_WEIGHTS[2])
        assert port_py == want and got == want, (hyp, ref, got, want)
        assert tm._segment_stats(hyp, ref, ttable) == (*want, len(hyp), len(ref))


@pytest.mark.parametrize("tables", ["paraphrases", "paraphrases_synonyms", "function_words"])
def test_meteor_span_alignment_equals_both_python_paths(native, tables):
    """The span search's matching (paraphrase spans, synonym stage,
    function-word weighting) equals the port's Python search and the JAX
    package's, and so do the extended stats built on it."""
    rng = random.Random({"paraphrases": 4, "paraphrases_synonyms": 5, "function_words": 6}[tables])
    tsyn = tm.SynonymTable(GROUPS) if tables == "paraphrases_synonyms" else None
    jsyn = jm.SynonymTable(GROUPS) if tables == "paraphrases_synonyms" else None
    tpara = tm.ParaphraseTable(PARAPHRASES) if tables != "function_words" else None
    jpara = jm.ParaphraseTable(PARAPHRASES) if tables != "function_words" else None
    tfw = tm.FunctionWords(FUNCTION_WORDS) if tables == "function_words" else None
    jfw = jm.FunctionWords(FUNCTION_WORDS) if tables == "function_words" else None
    for hyp, ref in _sentences(rng, 250):
        want = [tuple(x) for x in jm._align_spans(hyp, ref, jsyn, jpara)]
        assert [tuple(x) for x in tm._align_spans(hyp, ref, tsyn, tpara)] == want
        spans = (tm._paraphrase_candidates(hyp, ref, tpara, tm._candidate_pairs(hyp, ref, tsyn))
                 if tpara is not None else None)
        got = native.meteor_align_spans(
            hyp, ref, [porter_stem(w) for w in hyp], [porter_stem(w) for w in ref],
            tm.STAGE_WEIGHTS[0], tm.STAGE_WEIGHTS[1], _ids(tsyn, hyp), _ids(tsyn, ref),
            tm.STAGE_WEIGHTS[2], spans)
        assert got == want, (hyp, ref, got, want)
        stats = tm._segment_stats_ex(hyp, ref, tsyn, tpara, tfw)
        old = use_native(False)
        try:
            assert tm._segment_stats_ex(hyp, ref, tsyn, tpara, tfw) == stats
        finally:
            use_native(old)


def test_lcs_equals_both_python_paths(native):
    from mvc_tpu.evalcap import rouge as jrouge

    rng = random.Random(7)
    old = jrouge._native_mod
    jrouge._native_mod = None            # the JAX package's Python DP
    try:
        for _ in range(400):
            a = [rng.choice("abcdefg") for _ in range(rng.randint(0, 18))]
            b = [rng.choice("abcdefg") for _ in range(rng.randint(0, 18))]
            want = jrouge.lcs_length(a, b)
            assert trouge._lcs_length_py(a, b) == want
            assert native.lcs(a, b) == want and trouge.lcs_length(a, b) == want
    finally:
        jrouge._native_mod = old


def test_long_references_take_the_python_path(native):
    """The search's mask holds 64 reference words: the runtime refuses a
    longer one and the scorer takes the Python path, with the JAX package's
    result."""
    rng = random.Random(8)
    hyp = [rng.choice(WORDS) for _ in range(20)]
    ref = [rng.choice(WORDS) for _ in range(70)]
    with pytest.raises(ValueError):
        native.meteor_stats(hyp, ref, hyp, ref)
    jmatch = jm._align(hyp, ref)
    assert tm._segment_stats(hyp, ref) == (
        sum(jm._match_weight(hyp[i], ref[j]) for i, j in jmatch), len(jmatch),
        jm._count_chunks(jmatch), 20, 70)


def test_scorers_are_the_same_with_and_without_the_runtime(native, tmp_path):
    """``COCOEvalCap`` (PTB tokenizer, BLEU, METEOR with all three tables,
    ROUGE-L, CIDEr, SPICE) and the METEOR / ROUGE-L scorers alone give the
    same numbers through the runtime and through the Python paths."""
    rng = random.Random(9)
    gts, res = {}, {}
    for v in range(40):
        gts[f"v{v}"] = [" ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 12))).capitalize()
                        + rng.choice([".", "!", ""]) for _ in range(3)]
        res[f"v{v}"] = [" ".join(rng.choice(WORDS) for _ in range(rng.randint(2, 12)))]
    lexicon = tmp_path / "lexicon.txt"
    lexicon.write_text("".join(f"{w} {('noun', 'verb', 'adj')[i % 3]}\n"
                               for i, w in enumerate(WORDS)))
    tok = {k: [c.lower().rstrip(".!") for c in v] for k, v in gts.items()}

    def scores():
        coco = COCOEvalCap(gts, res, meteor_synonyms=GROUPS, spice_lexicon=str(lexicon))
        meteor = Meteor(synonyms=GROUPS, paraphrases=PARAPHRASES, function_words=FUNCTION_WORDS)
        m, per = meteor.compute_score(tok, res)
        r, _ = Rouge().compute_score(tok, res)
        return coco.evaluate(), m, list(per), r

    with_runtime = scores()
    old = use_native(False)
    try:
        without = scores()
    finally:
        use_native(old)
    assert with_runtime == without
