"""SPICE — Semantic Propositional Image Caption Evaluation: the copy of
``mvc_tpu/evalcap/spice.py``.

The reference vendors a SPICE *wrapper* but never runs it: the scorer is
commented out of its eval harness (reference pycocoevalcap/eval.py:44),
absent from NLPScore (src/losses.py:146-151), and its spice-1.0.jar is a
missing LFS blob.  The wrapper's contract (pycocoevalcap/spice/spice.py:
27-94) is: ``compute_score(gts, res) -> (mean F over images, per-image
{category: {"f", "pr", "re"}} dicts)`` with category "All" carrying the
headline score.

This module implements that metric for real, clean-room, in two parts:

1. **Scoring engine** (`score_tuples`) — exact SPICE semantics (Anderson et
   al. 2016, §3.2): candidate and reference captions become scene graphs,
   i.e. sets of tuples — objects ``(o,)``, attributes ``(o, a)``, relations
   ``(s, r, o)``.  The reference set is the UNION over all reference
   captions' graphs.  A candidate tuple is matched when some reference tuple
   is element-wise equivalent, where two words are equivalent when equal or
   sharing a synonym group (WordNet synsets in the original; here the same
   user-supplied one-group-per-line table the METEOR stage-3 matcher uses).
   F1 over the deduplicated tuple sets is the score; per-category scores
   restrict both sides to that tuple kind.

2. **Caption parser** (`parse_scene_graph`) — the original drives a Java
   dependency parser (inside the missing jar).  No pretrained parser exists
   in this environment, so scene graphs are extracted by a deterministic
   lexicon-driven chunker tuned to caption English ("a man is playing a
   guitar on stage"): NP chunks ``det? num? (adj|noun)* noun`` yield objects
   and attributes, verb groups ``aux* verb adv*`` yield relations between
   the clause subject and the following NP, prepositions attach the next NP
   head to the clause subject (or to the copula subject).  Two SPICE-paper
   behaviors are replicated exactly (validated against the paper's Figure-1
   worked example in tests/test_spice.py): an intransitive verb becomes an
   ATTRIBUTE of its subject (SPICE folds unary relations into attributes —
   "a giraffe standing ..." -> ``(giraffe, standing)``), and compound
   prepositions ("on top of", "in front of", ...) are merged into a single
   relation label (``(girl, on top of, court)``).  POS comes from a
   user-supplied lexicon file — one ``word pos[,pos...] [lemma]`` per line —
   with noun as the unknown-word default (captions are noun-heavy).

Like the METEOR synonym stage, the linguistic DATA (POS lexicon, synonym
groups) is user-supplied: WordNet is not redistributable from this build
environment.  Without a lexicon, ``compute_score`` raises with a clear
message (the behavior the reference exhibits for every SPICE call, since
its jar is absent) — set ``TrainerConfig``-level wiring or the
``MVC_SPICE_LEXICON`` / ``MVC_SPICE_SYNONYMS`` env vars to enable it.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from mvc_tpu_torch.evalcap.meteor import SynonymTable, _resolve_synonyms

POS_TAGS = ("noun", "verb", "adj", "adv", "prep", "det", "aux", "pron",
            "conj", "num", "part")

# Closed-class words every English caption corpus shares; a user lexicon
# only needs the open classes (nouns/verbs/adjectives/adverbs).
_BUILTIN = {
    "a": ("det",), "an": ("det",), "the": ("det",),
    "this": ("det",), "that": ("det",), "these": ("det",), "those": ("det",),
    "some": ("det",), "his": ("det",), "her": ("det",), "its": ("det",),
    "their": ("det",), "my": ("det",), "your": ("det",), "our": ("det",),
    "is": ("aux",), "are": ("aux",), "was": ("aux",), "were": ("aux",),
    "be": ("aux",), "been": ("aux",), "being": ("aux",), "am": ("aux",),
    "has": ("aux",), "have": ("aux",), "had": ("aux",), "do": ("aux",),
    "does": ("aux",), "did": ("aux",), "will": ("aux",), "would": ("aux",),
    "can": ("aux",), "could": ("aux",),
    "in": ("prep",), "on": ("prep",), "at": ("prep",), "with": ("prep",),
    "of": ("prep",), "into": ("prep",), "onto": ("prep",), "over": ("prep",),
    "under": ("prep",), "near": ("prep",), "by": ("prep",), "from": ("prep",),
    "to": ("prep",), "through": ("prep",), "across": ("prep",),
    "behind": ("prep",), "beside": ("prep",), "against": ("prep",),
    "around": ("prep",), "inside": ("prep",), "outside": ("prep",),
    "down": ("prep",), "up": ("prep",), "off": ("prep",), "out": ("prep",),
    "and": ("conj",), "or": ("conj",), "while": ("conj",), "as": ("conj",),
    "he": ("pron",), "she": ("pron",), "it": ("pron",), "they": ("pron",),
    "someone": ("pron",), "somebody": ("pron",),
    "one": ("num",), "two": ("num",), "three": ("num",), "four": ("num",),
    "five": ("num",), "six": ("num",), "seven": ("num",), "eight": ("num",),
    "nine": ("num",), "ten": ("num",), "not": ("part",),
}


class PosLexicon:
    """word -> (poses, lemma). File format: ``word pos[,pos...] [lemma]``
    per line, '#' comments.  Unknown words default to noun."""

    def __init__(self, entries: Optional[Dict[str, Tuple[Tuple[str, ...], str]]] = None):
        self.entries: Dict[str, Tuple[Tuple[str, ...], str]] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "PosLexicon":
        entries: Dict[str, Tuple[Tuple[str, ...], str]] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                fields = line.split()
                if len(fields) < 2:
                    raise ValueError(
                        f"lexicon line needs 'word pos[,pos...]': {line!r}"
                    )
                word = fields[0].lower()
                poses = tuple(p for p in fields[1].lower().split(",") if p)
                for p in poses:
                    if p not in POS_TAGS:
                        raise ValueError(f"unknown POS tag {p!r} for {word!r}")
                lemma = fields[2].lower() if len(fields) > 2 else word
                entries[word] = (poses, lemma)
        return cls(entries)

    def lookup(self, word: str) -> Tuple[Tuple[str, ...], str]:
        w = word.lower()
        if w in self.entries:
            return self.entries[w]
        if w in _BUILTIN:
            return _BUILTIN[w], w
        if w.isdigit():
            return ("num",), w
        hit = self._morphy(w)
        if hit is not None:
            return hit
        return ("noun",), w                      # open-class default

    # WordNet's documented Morphy detachment rules: strip an inflectional
    # suffix, accept the candidate only if the resulting lemma is a known
    # entry with the matching POS.  Irregular forms ("men", "ran") come from
    # the *.exc files as explicit entries (scripts/build_wordnet_tables.py).
    _DETACH = (
        ("ies", "y", "noun"), ("ses", "s", "noun"), ("xes", "x", "noun"),
        ("zes", "z", "noun"), ("ches", "ch", "noun"), ("shes", "sh", "noun"),
        ("s", "", "noun"),
        ("ies", "y", "verb"), ("es", "e", "verb"), ("es", "", "verb"),
        ("ed", "e", "verb"), ("ed", "", "verb"),
        ("ing", "e", "verb"), ("ing", "", "verb"), ("s", "", "verb"),
        ("er", "", "adj"), ("er", "e", "adj"),
        ("est", "", "adj"), ("est", "e", "adj"),
    )

    def _morphy(self, w: str) -> Optional[Tuple[Tuple[str, ...], str]]:
        for suf, rep, pos in self._DETACH:
            if not w.endswith(suf) or len(w) - len(suf) + len(rep) < 2:
                continue
            cand = w[: len(w) - len(suf)] + rep
            hit = self.entries.get(cand)
            if hit is None and cand[-1:] == cand[-2:-1]:      # doubled final
                hit = self.entries.get(cand[:-1])             # ("running")
                cand = cand[:-1] if hit is not None else cand
            if hit is not None and pos in hit[0]:
                return (pos,), hit[1]
        return None


def _tag(tokens: Sequence[str], lex: PosLexicon) -> List[Tuple[str, str, str]]:
    """Greedy local disambiguation -> [(word, pos, lemma)].  Rules, in
    order: after det/num/adj prefer the nominal reading; after aux prefer
    verb; after a pron/noun head prefer verb; sentence-initial or after
    prep/conj prefer noun."""
    out: List[Tuple[str, str, str]] = []
    prev_pos = None
    for tok in tokens:
        if " " in tok:                   # merged compound preposition
            out.append((tok, "prep", tok))
            prev_pos = "prep"
            continue
        poses, lemma = lex.lookup(tok)
        pos = poses[0]
        if len(poses) > 1:
            if prev_pos in ("det", "num", "adj") and "noun" in poses:
                pos = "adj" if ("adj" in poses and "noun" in poses
                                and poses.index("adj") < poses.index("noun")) else "noun"
            elif prev_pos == "aux" and "verb" in poses:
                pos = "verb"
            elif prev_pos in ("noun", "pron") and "verb" in poses:
                pos = "verb"
            elif prev_pos in ("prep", "conj", None) and "noun" in poses:
                pos = "noun"
        out.append((tok.lower(), pos, lemma))
        prev_pos = pos
    return out


# Compound prepositions merged into one relation label, the way SPICE's
# collapsed dependencies label e.g. "on top of" as a single edge.
_COMPOUND_PREPS = (
    ("on", "top", "of"), ("in", "front", "of"), ("in", "the", "middle", "of"),
    ("next", "to"), ("out", "of"), ("inside", "of"), ("close", "to"),
    ("on", "the", "side", "of"),
)


def _merge_compound_preps(tokens: List[str]) -> List[str]:
    out: List[str] = []
    i = 0
    while i < len(tokens):
        for comp in _COMPOUND_PREPS:
            if tuple(tokens[i : i + len(comp)]) == comp:
                out.append(" ".join(comp))
                i += len(comp)
                break
        else:
            out.append(tokens[i])
            i += 1
    return out


def parse_scene_graph(
    caption: str,
    lexicon: PosLexicon,
) -> Set[Tuple[str, ...]]:
    """Caption -> set of SPICE tuples: ``(obj,)``, ``(obj, attr)``,
    ``(subj, rel, obj)``.  Deterministic chunker over the POS stream; see
    module docstring for the grammar."""
    tokens = _merge_compound_preps(
        [t for t in caption.strip().lower().split() if t]
    )
    tagged = _tag(tokens, lexicon)

    tuples: Set[Tuple[str, ...]] = set()
    # NP chunking pass: collect (start, head_lemma, attrs) per NP.
    nps: List[Tuple[int, str, List[str]]] = []
    i = 0
    while i < len(tagged):
        _, pos, _ = tagged[i]
        if pos in ("det", "num", "adj", "noun", "pron"):
            start = i
            attrs: List[str] = []
            mods: List[str] = []        # candidate pre-head noun modifiers
            head: Optional[str] = None
            while i < len(tagged) and tagged[i][1] in ("det", "num", "adj", "noun", "pron"):
                w, p, lem = tagged[i]
                if p == "num":
                    attrs.append(lem)
                elif p == "adj":
                    attrs.append(lem)
                elif p in ("noun", "pron"):
                    if head is not None:
                        mods.append(head)
                    head = lem
                i += 1
            if head is not None:
                attrs = attrs + mods     # non-head nouns act as modifiers
                nps.append((start, head, attrs))
        else:
            i += 1

    for _, head, attrs in nps:
        tuples.add((head,))
        for a in attrs:
            tuples.add((head, a))

    def np_at_or_after(pos_idx: int) -> Optional[str]:
        for s, head, _ in nps:
            if s >= pos_idx:
                return head
        return None

    def np_before(pos_idx: int) -> Optional[str]:
        prev = None
        for s, head, _ in nps:
            if s >= pos_idx:
                break
            prev = head
        return prev

    # Clause pass: subject = nearest NP before the verb group; object =
    # first NP after it.  Copula+adj -> attribute; prep -> relation from
    # the clause subject (caption PPs overwhelmingly modify the subject).
    i = 0
    subject: Optional[str] = None
    while i < len(tagged):
        w, pos, lem = tagged[i]
        if pos == "verb":
            subject = np_before(i)
            j = i + 1
            while j < len(tagged) and tagged[j][1] in ("adv", "part"):
                j += 1
            if j < len(tagged) and tagged[j][1] in ("det", "num", "adj", "noun", "pron"):
                obj = np_at_or_after(j)
                if subject and obj:
                    tuples.add((subject, lem, obj))
                    i = j
            elif subject:
                # No object NP: SPICE folds the unary relation into an
                # attribute of its subject ("a giraffe standing" ->
                # (giraffe, standing), Anderson et al. 2016 Fig. 1).
                tuples.add((subject, lem))
            i += 1
        elif pos == "aux":
            subject = subject or np_before(i)
            # copula + adjective -> attribute of the subject
            j = i + 1
            if j < len(tagged) and tagged[j][1] == "adj" and (
                j + 1 == len(tagged) or tagged[j + 1][1] not in ("noun", "pron")
            ):
                if subject:
                    tuples.add((subject, tagged[j][2]))
                i = j + 1
            else:
                i += 1
        elif pos == "prep":
            anchor = subject or np_before(i)
            obj = np_at_or_after(i + 1)
            if anchor and obj and anchor != obj:
                tuples.add((anchor, lem, obj))    # bare-prep relation label
            i += 1
        elif pos == "conj":
            subject = None               # new clause
            i += 1
        else:
            i += 1
    return tuples


def _tuple_kind(t: Tuple[str, ...]) -> str:
    return {1: "Object", 2: "Attribute", 3: "Relation"}[len(t)]


def _words_match(a: str, b: str, syn: Optional[SynonymTable]) -> bool:
    if a == b:
        return True
    if syn is None:
        return False
    ga = syn.ids(a)
    return bool(ga and ga & syn.ids(b))


def _tuples_match(a: Tuple[str, ...], b: Tuple[str, ...],
                  syn: Optional[SynonymTable]) -> bool:
    return len(a) == len(b) and all(_words_match(x, y, syn) for x, y in zip(a, b))


def _prf(cand: Set[Tuple[str, ...]], ref: Set[Tuple[str, ...]],
         syn: Optional[SynonymTable]) -> Dict[str, float]:
    """Original SPICE semantics: ONE one-to-one binary matching between the
    deduplicated tuple sets, its size used as both numerators (each reference
    tuple matches at most one candidate tuple, so a candidate matching N
    synonym-equivalent reference tuples still counts once in P *and* R).
    With exact equality this equals |cand & ref| on both sides; it only
    differs under many-to-many synonym matches."""
    unmatched = list(ref)
    matched = 0
    for t in cand:
        for i, r in enumerate(unmatched):
            if _tuples_match(t, r, syn):
                del unmatched[i]
                matched += 1
                break
    p = matched / len(cand) if cand else 0.0
    r = matched / len(ref) if ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"f": f, "pr": p, "re": r}


def score_tuples(
    cand: Set[Tuple[str, ...]],
    refs: Iterable[Set[Tuple[str, ...]]],
    synonyms: Optional[SynonymTable] = None,
) -> Dict[str, Dict[str, float]]:
    """SPICE scores for one image: candidate tuple set vs the UNION of the
    reference captions' tuple sets, overall and per category."""
    ref_union: Set[Tuple[str, ...]] = set()
    for r in refs:
        ref_union |= r
    out = {"All": _prf(cand, ref_union, synonyms)}
    for kind in ("Object", "Attribute", "Relation"):
        ck = {t for t in cand if _tuple_kind(t) == kind}
        rk = {t for t in ref_union if _tuple_kind(t) == kind}
        out[kind] = _prf(ck, rk, synonyms)
    return out


class Spice:
    """Drop-in scorer with the reference wrapper's contract
    (pycocoevalcap/spice/spice.py:27-94): ``compute_score(gts, res)`` ->
    ``(mean 'All' F over images, [per-image {category: {f, pr, re}}])``.

    ``lexicon``/``synonyms`` may be objects, file paths, or None; None falls
    back to the ``MVC_SPICE_LEXICON`` / ``MVC_SPICE_SYNONYMS`` env vars.
    With no lexicon available at all, scoring raises — the same observable
    behavior as the reference, whose SPICE jar is a missing blob."""

    def __init__(
        self,
        lexicon: Union[None, str, PosLexicon] = None,
        synonyms: Union[None, str, SynonymTable, Sequence[Sequence[str]]] = None,
    ):
        if lexicon is None:
            lexicon = os.environ.get("MVC_SPICE_LEXICON") or None
        if isinstance(lexicon, (str, os.PathLike)):
            lexicon = PosLexicon.load(str(lexicon))
        self.lexicon: Optional[PosLexicon] = lexicon
        if synonyms is None:
            synonyms = os.environ.get("MVC_SPICE_SYNONYMS") or None
        self.synonyms = _resolve_synonyms(synonyms)

    def compute_score(self, gts: Dict[str, List[str]], res: Dict[str, List[str]]):
        if self.lexicon is None:
            raise NotImplementedError(
                "SPICE needs a POS lexicon (the linguistic data the original "
                "ships inside its Stanford-parser jar, a missing blob even in "
                "the reference repo). Provide Spice(lexicon=...) or set "
                "MVC_SPICE_LEXICON; see mvc_tpu_torch/evalcap/spice.py for the "
                "one-'word pos[,pos...] [lemma]'-per-line format."
            )
        assert sorted(gts.keys()) == sorted(res.keys())
        img_ids = sorted(gts.keys())
        scores: List[Dict[str, Dict[str, float]]] = []
        fs: List[float] = []
        for img in img_ids:
            hypo, refs = res[img], gts[img]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) >= 1
            cand_g = parse_scene_graph(hypo[0], self.lexicon)
            ref_gs = [parse_scene_graph(r, self.lexicon) for r in refs]
            s = score_tuples(cand_g, ref_gs, self.synonyms)
            scores.append(s)
            fs.append(s["All"]["f"])
        return float(np.mean(np.asarray(fs))), scores

    def method(self) -> str:
        return "SPICE"
