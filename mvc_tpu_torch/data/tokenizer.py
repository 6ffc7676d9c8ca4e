"""English word tokenizer: the rule-based fallback of
``mvc_tpu/data/tokenizer.py`` (the JAX package takes it whenever spaCy's
``en_core_web_sm`` is not installed).

Per whitespace chunk it runs the relevant subset of spaCy's tokenizer
algorithm: special-case lookup, prefix peel, suffix peel (special cases
re-checked after every peel), then infix splitting, with the English
exception classes the caption domain hits (verb contractions, pronoun
contractions, fixed abbreviations); tokens are lowercased.
"""

from __future__ import annotations

import re
from typing import List

# --------------------------------------------------------------- rule tables
# Prefix/suffix single characters (spacy LIST_PUNCT + LIST_QUOTES +
# LIST_CURRENCY subset).  "." and "-" are deliberately absent: spacy peels
# a final period only via contextual rules (below) and never peels hyphens.
_PREFIX_CHARS = set("()[]{}<>\"'`“”‘’«»,:;!?_#*&¡¿$£€¥")
_SUFFIX_CHARS = set("()[]{}<>\"'`“”‘’«»,:;!?_#*&%")

_ELLIPSIS_SUFFIX = re.compile(r"(?:\.\.+|…)$")
_ELLIPSIS_PREFIX = re.compile(r"^(?:\.\.+|…)")

# Contraction stems spacy's English exceptions cover (it does NOT split
# arbitrary *n't words — only listed ones).
_NT_STEMS = {
    "ai", "are", "ca", "could", "dare", "did", "does", "do", "had", "has",
    "have", "is", "might", "must", "need", "ought", "sha", "should", "was",
    "were", "wo", "would",
}
# Stems spacy pairs with 'm / 're / 've / 'll / 'd exceptions.
_PRON_STEMS = {
    "i", "you", "he", "she", "it", "we", "they", "who", "that", "there",
    "what", "where", "when", "why", "how", "this", "let", "could", "should",
    "would", "might", "must",
}
# Which suffixes each stem class accepts ('s is a general spacy suffix and
# handled separately).
_PRON_SUFFIXES = ("'m", "'re", "'ve", "'ll", "'d")

# Fixed multi-token exceptions: lowered chunk -> split points.
_FIXED_SPLITS = {
    "cannot": 3,   # can | not
    "gonna": 3,    # gon | na
    "wanna": 3,    # wan | na
    "gotta": 3,    # got | ta
    "lemme": 3,    # lem | me
    "gimme": 3,    # gim | me
    "outta": 3,    # out | ta
}
# Fixed single-token exceptions (kept intact even though the final-period
# rule would otherwise peel): spacy English + base exception subset.
_FIXED_KEEP = {
    "e.g.", "i.e.", "a.m.", "p.m.", "vs.", "mr.", "mrs.", "ms.", "dr.",
    "prof.", "st.", "jr.", "inc.", "ltd.", "co.", "corp.", "ph.d.",
    "o'clock", "o’clock", ":)", ":(", ":d", ":p", ";)", "<3",
}

_UPPER = set("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_LOWER = set("abcdefghijklmnopqrstuvwxyz")
_DIGIT = set("0123456789")
# Characters before a final "." that trigger the peel (spacy suffix rule
# `(?<=[0-9 a-z % ² - + … quotes punct])\.`), plus the two-uppercase rule.
_PERIOD_PREV = _LOWER | _DIGIT | set("%²-+…'\"”’)]}")

# Infixes, applied to the peeled core in one pass each (spacy English
# infixes the caption domain can hit).
_INFIXES = [
    re.compile(r"(?<=[0-9])([+\-*^])(?=[0-9-])"),          # 1-2, 3+4
    re.compile(r"(?<=[A-Za-z0-9])(--?|—|–)(?=[A-Za-z])"),  # well-known
    re.compile(r"(?<=[A-Za-z])(,)(?=[A-Za-z])"),           # one,two
    re.compile(r"(?<=[A-Za-z0-9])([:<>=/])(?=[A-Za-z])"),  # and/or
    re.compile(r"(\.\.+|…)"),                              # wait...what
]


def _exception_split(tok: str) -> List[str] | None:
    """spacy special-case lookup for one whole (peeled) chunk."""
    low = tok.lower()
    if low in _FIXED_KEEP:
        return [tok]
    if low in _FIXED_SPLITS:
        cut = _FIXED_SPLITS[low]
        return [tok[:cut], tok[cut:]]
    for apo in ("'", "’"):
        nt = "n" + apo + "t"
        if low.endswith(nt) and low[: -len(nt)] in _NT_STEMS:
            return [tok[: -len(nt)], tok[-len(nt):]]
        for suf in _PRON_SUFFIXES:
            s = suf.replace("'", apo)
            if low.endswith(s) and low[: -len(s)] in _PRON_STEMS:
                return [tok[: -len(s)], tok[-len(s):]]
    return None


def _peel_suffix(tok: str) -> tuple[str, str] | None:
    """One suffix peel: (rest, suffix_token) or None."""
    m = _ELLIPSIS_SUFFIX.search(tok)
    if m and m.start() > 0:
        return tok[: m.start()], tok[m.start():]
    for apo in ("'", "’"):
        for s in (apo + "s", apo + "S"):
            if tok.endswith(s) and len(tok) > 2:
                return tok[:-2], tok[-2:]
    last = tok[-1]
    if last in _SUFFIX_CHARS and len(tok) > 1:
        return tok[:-1], last
    if last == "." and len(tok) > 1:
        prev = tok[-2]
        if prev in _PERIOD_PREV or (
            len(tok) > 2 and prev in _UPPER and tok[-3] in _UPPER
        ):
            return tok[:-1], last
    return None


def _split_infixes(tok: str) -> List[str]:
    parts = [tok]
    for rx in _INFIXES:
        nxt: List[str] = []
        for p in parts:
            pieces = rx.split(p)
            nxt.extend(x for x in pieces if x)
        parts = nxt
    return parts


def _tokenize_chunk(chunk: str) -> List[str]:
    """One whitespace-delimited substring through the spacy algorithm:
    specials -> prefix -> suffix (specials re-checked each peel) -> infix."""
    tokens: List[str] = []
    suffixes: List[str] = []
    while chunk:
        exc = _exception_split(chunk)
        if exc is not None:
            tokens.extend(exc)
            chunk = ""
            break
        m = _ELLIPSIS_PREFIX.match(chunk)
        if m and m.end() < len(chunk):
            tokens.append(chunk[: m.end()])
            chunk = chunk[m.end():]
            continue
        if chunk[0] in _PREFIX_CHARS and len(chunk) > 1:
            tokens.append(chunk[0])
            chunk = chunk[1:]
            continue
        peeled = _peel_suffix(chunk)
        if peeled is not None:
            chunk, suf = peeled
            suffixes.append(suf)
            continue
        tokens.extend(_split_infixes(chunk))
        chunk = ""
    tokens.extend(reversed(suffixes))
    return tokens


def _fallback_tokenize(text: str) -> List[str]:
    out: List[str] = []
    for chunk in text.split():
        out.extend(_tokenize_chunk(chunk))
    return [t.lower() for t in out if t]


def tokenize(text: str) -> List[str]:
    """Lowercased word tokens of ``text``."""
    return _fallback_tokenize(text)
