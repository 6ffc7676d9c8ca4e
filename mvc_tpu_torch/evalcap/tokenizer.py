"""PTB-style tokenizer for COCO-style evaluation: the pure-Python copy of
``mvc_tpu/evalcap/tokenizer.py`` (the JAX package's optional C++ scanner
gives the same tokens).

The reference shells out to Stanford CoreNLP's PTBTokenizer
(``-preserveLines -lowerCase``) and then strips a fixed punctuation list
(reference pycocoevalcap/tokenizer/ptbtokenizer.py:18-56; the jar is a missing
blob).  This is a native implementation of the same contract: Penn-Treebank
word splitting, lowercasing, and removal of the identical punctuation set.
"""

from __future__ import annotations

import re
from typing import Dict, List

# The punctuation the reference removes after tokenization
# (pycocoevalcap/tokenizer/ptbtokenizer.py:21-22).
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]
_PUNCT_SET = set(PUNCTUATIONS)

_BRACKETS = {"(": "-LRB-", ")": "-RRB-", "{": "-LCB-", "}": "-RCB-"}

_CONTRACTIONS = ("n't", "'s", "'re", "'ve", "'ll", "'d", "'m")

_TOKEN_RE = re.compile(
    r"""\.\.\.            # ellipsis
      | --                # dash
      | n't | 's | 're | 've | 'll | 'd | 'm   # contractions (post-split)
      | [a-zA-Z]+(?:['][a-zA-Z]+)?             # words (internal apostrophe)
      | \d+(?:[.,]\d+)*                        # numbers
      | [^\sa-zA-Z\d]                          # single punctuation
    """,
    re.VERBOSE,
)


def _split_word(tok: str) -> List[str]:
    low = tok.lower()
    for c in _CONTRACTIONS:
        if low.endswith(c) and len(tok) > len(c):
            head = tok[: -len(c)]
            if head:
                return [head, tok[-len(c):]]
    return [tok]


def ptb_tokenize_line(line: str) -> List[str]:
    """PTB word tokens of one caption, lowercased, punctuation stripped."""
    # lowercase first so contraction handling is case-uniform
    line = line.lower()
    out: List[str] = []
    for m in _TOKEN_RE.finditer(line):
        tok = m.group(0)
        tok = _BRACKETS.get(tok, tok)
        for part in _split_word(tok):
            part = part.lower()
            if part not in _PUNCT_SET and part.upper() not in _PUNCT_SET:
                out.append(part)
    return out


class PTBTokenizer:
    """COCO-eval tokenizer facade
    (reference pycocoevalcap/tokenizer/ptbtokenizer.py:24-68)."""

    def tokenize(self, captions_for_image: Dict[str, List[dict]]) -> Dict[str, List[str]]:
        """{image_id: [{"caption": str}, ...]} -> {image_id: [tokenized str]}"""
        return {
            k: [" ".join(ptb_tokenize_line(c["caption"])) for c in v]
            for k, v in captions_for_image.items()
        }
