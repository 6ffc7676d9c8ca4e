"""CIDEr (Vedantam et al. 2015), COCO-caption conventions
(reference pycocoevalcap/cider/cider_scorer.py):

- document frequency over the *reference* corpus (one count per image whose
  refs contain the n-gram)
- idf = log(#images) - log(max(1, df));  tf is the raw n-gram count
- per-n clipped-cosine similarity, hypothesis clipped against each reference
- length gaussian exp(-(len_h - len_r)^2 / (2*sigma^2)) with sigma = 6, where
  the "length" is the bigram-token count (a reference quirk: word count - 1)
- mean over n in 1..4, mean over references, x 10
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List

from mvc_tpu_torch.evalcap.bleu import ngram_counts


def _vectorize(counts: Counter, doc_freq, log_ref_len: float, n: int):
    """tf-idf vectors per n, their norms, and the quirk 'length' (bigrams)."""
    vec = [defaultdict(float) for _ in range(n)]
    norm = [0.0] * n
    length = 0
    for ng, tf in counts.items():
        df = math.log(max(1.0, doc_freq[ng]))
        k = len(ng) - 1
        vec[k][ng] = float(tf) * (log_ref_len - df)
        norm[k] += vec[k][ng] ** 2
        if k == 1:
            length += tf
    return vec, [math.sqrt(x) for x in norm], length


def _sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r, n: int, sigma: float):
    delta = float(len_h - len_r)
    out = [0.0] * n
    for k in range(n):
        acc = 0.0
        for ng, wh in vec_h[k].items():
            acc += min(wh, vec_r[k][ng]) * vec_r[k][ng]
        if norm_h[k] != 0 and norm_r[k] != 0:
            acc /= norm_h[k] * norm_r[k]
        out[k] = acc * math.exp(-(delta ** 2) / (2 * sigma ** 2))
    return out


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def compute_score(self, gts: Dict[str, List[str]], res: Dict[str, List[str]]):
        assert sorted(gts.keys()) == sorted(res.keys())
        import numpy as np

        ids = sorted(gts.keys())
        cooked_refs = [[ngram_counts(r.split(), self._n) for r in gts[i]] for i in ids]
        cooked_test = [ngram_counts(res[i][0].split(), self._n) for i in ids]

        doc_freq: defaultdict = defaultdict(float)
        for refs in cooked_refs:
            for ng in set(ng for ref in refs for ng in ref):
                doc_freq[ng] += 1

        log_ref_len = math.log(float(len(ids)))
        scores = []
        for test, refs in zip(cooked_test, cooked_refs):
            vec_h, norm_h, len_h = _vectorize(test, doc_freq, log_ref_len, self._n)
            acc = [0.0] * self._n
            for ref in refs:
                vec_r, norm_r, len_r = _vectorize(ref, doc_freq, log_ref_len, self._n)
                s = _sim(vec_h, vec_r, norm_h, norm_r, len_h, len_r, self._n, self._sigma)
                acc = [a + b for a, b in zip(acc, s)]
            score = sum(acc) / self._n / len(refs) * 10.0
            scores.append(score)
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "CIDEr"
