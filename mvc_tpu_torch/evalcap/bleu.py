"""Corpus BLEU-1..4 (Papineni et al. 2002), computed the COCO-caption way so
scores are directly comparable with the reference's vendored scorer
(reference pycocoevalcap/bleu/bleu_scorer.py):

- modified n-gram precision with per-reference max-clipping
- effective reference length: "closest" to the hypothesis length (default
  when scoring >1 image)
- corpus-level brevity penalty exp(1 - 1/ratio) applied when ratio < 1
- the same tiny/small smoothing constants, so values agree to float precision
- per-image running-product scores returned alongside the corpus score
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence

_TINY = 1e-15
_SMALL = 1e-9


def ngram_counts(words: Sequence[str], max_n: int) -> Counter:
    counts: Counter = Counter()
    for n in range(1, max_n + 1):
        for i in range(len(words) - n + 1):
            counts[tuple(words[i : i + n])] += 1
    return counts


class Bleu:
    def __init__(self, n: int = 4):
        self._n = n

    def compute_score(self, gts: Dict[str, List[str]], res: Dict[str, List[str]]):
        """gts/res: image id -> list of sentences (res lists have length 1).
        Returns (corpus scores [n], per-image scores [n][images])."""
        assert sorted(gts.keys()) == sorted(res.keys())
        n = self._n
        ids = sorted(gts.keys())

        total_guess = [0] * n
        total_correct = [0] * n
        total_testlen = 0
        total_reflen = 0.0
        per_image: List[List[float]] = [[] for _ in range(n)]

        for img in ids:
            hypo = res[img][0].split()
            refs = [r.split() for r in gts[img]]
            testlen = len(hypo)

            # max-clipped reference counts
            max_ref: Dict[tuple, int] = {}
            for ref in refs:
                for ng, c in ngram_counts(ref, n).items():
                    if c > max_ref.get(ng, 0):
                        max_ref[ng] = c

            guess = [max(0, testlen - k) for k in range(n)]
            correct = [0] * n
            for ng, c in ngram_counts(hypo, n).items():
                correct[len(ng) - 1] += min(c, max_ref.get(ng, 0))

            # closest effective reference length (ties -> shorter, via min on
            # (distance, length) pairs like the reference scorer)
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]

            total_testlen += testlen
            total_reflen += reflen
            for k in range(n):
                total_guess[k] += guess[k]
                total_correct[k] += correct[k]

            # per-image running-product BLEU with its own brevity penalty
            prod = 1.0
            ratio = (testlen + _TINY) / (reflen + _SMALL)
            bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
            for k in range(n):
                prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
                per_image[k].append(prod ** (1.0 / (k + 1)) * bp)

        scores = []
        prod = 1.0
        ratio = (total_testlen + _TINY) / (total_reflen + _SMALL)
        bp = math.exp(1 - 1 / ratio) if ratio < 1 else 1.0
        for k in range(n):
            prod *= (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            scores.append(prod ** (1.0 / (k + 1)) * bp)

        return scores, per_image

    def method(self) -> str:
        return "Bleu"
