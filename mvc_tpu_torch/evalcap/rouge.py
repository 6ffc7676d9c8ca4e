"""ROUGE-L (Lin 2004) F-score with beta = 1.2, COCO-caption conventions
(reference pycocoevalcap/rouge/rouge.py): per image, precision and recall are
*independently* maxed over the references before combining into F-beta; the
corpus score is the mean over images."""

from __future__ import annotations

from typing import Dict, List

from mvc_tpu_torch.evalcap import _native


def lcs_length(a: List[str], b: List[str]) -> int:
    """Length of the longest common subsequence: the native runtime's DP, or
    the identical Python one."""
    if _native.available():
        return _native.lcs(a, b)
    return _lcs_length_py(a, b)


def _lcs_length_py(a: List[str], b: List[str]) -> int:
    """O(len(a)*len(b)) DP with a rolling row."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, start=1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[len(b)]


class Rouge:
    def __init__(self):
        self.beta = 1.2

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1
        assert len(refs) > 0
        hyp_words = candidate[0].split(" ")
        best_p = best_r = 0.0
        for ref_sentence in refs:
            ref_words = ref_sentence.split(" ")
            common = lcs_length(ref_words, hyp_words)
            best_p = max(best_p, common / float(len(hyp_words)))
            best_r = max(best_r, common / float(len(ref_words)))
        if best_p == 0.0 or best_r == 0.0:
            return 0.0
        b2 = self.beta ** 2
        return (1 + b2) * best_p * best_r / float(best_r + b2 * best_p)

    def compute_score(self, gts: Dict[str, List[str]], res: Dict[str, List[str]]):
        assert sorted(gts.keys()) == sorted(res.keys())
        import numpy as np

        scores = [self.calc_score(res[i], gts[i]) for i in sorted(gts.keys())]
        return float(np.mean(scores)), np.array(scores)

    def method(self) -> str:
        return "Rouge"
