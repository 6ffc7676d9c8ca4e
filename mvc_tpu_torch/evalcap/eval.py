"""Score facades (``mvc_tpu/evalcap/eval.py``): ``NLPScore``, the training
loop's scorer, and ``COCOEvalCap``, the standalone COCO-style harness."""

from __future__ import annotations

import os
from typing import Dict, List

from mvc_tpu_torch.evalcap.bleu import Bleu
from mvc_tpu_torch.evalcap.cider import Cider
from mvc_tpu_torch.evalcap.meteor import Meteor
from mvc_tpu_torch.evalcap.rouge import Rouge
from mvc_tpu_torch.evalcap.spice import Spice
from mvc_tpu_torch.evalcap.tokenizer import PTBTokenizer


def NLPScore(ref: Dict[str, List[str]], hypo: Dict[str, List[str]], meteor_synonyms=None,
             meteor_paraphrases=None, meteor_function_words=None) -> Dict[str, float]:
    """ref: {video_id: [ground-truth captions]}, hypo: {video_id: [generated
    caption]}, both already tokenized.  Returns {Bleu_1..4, METEOR, ROUGE_L,
    CIDEr}.  The optional METEOR tables enable its synonym and paraphrase
    stages and the function-word weighting (``evalcap/meteor.py``)."""
    scorers = [
        (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
        (Meteor(synonyms=meteor_synonyms, paraphrases=meteor_paraphrases,
                function_words=meteor_function_words), "METEOR"),
        (Rouge(), "ROUGE_L"),
        (Cider(), "CIDEr"),
    ]
    final_scores: Dict[str, float] = {}
    for scorer, method in scorers:
        score, _ = scorer.compute_score(ref, hypo)
        if isinstance(score, list):
            for m, s in zip(method, score):
                final_scores[m] = s
        else:
            final_scores[method] = score
    return final_scores


class COCOEvalCap:
    """COCO-style eval harness over (gts, res) dicts of raw caption strings
    (reference pycocoevalcap/eval.py): PTB-tokenizes both sides, runs every
    scorer, and fills ``eval`` (corpus scores) and ``imgToEval`` (per-video
    scores).  SPICE runs only when a POS lexicon is given, by argument or
    by ``MVC_SPICE_LEXICON`` (``evalcap/spice.py``)."""

    def __init__(self, gts: Dict[str, List[str]], res: Dict[str, List[str]],
                 meteor_synonyms=None, spice_lexicon=None, spice_synonyms=None,
                 meteor_paraphrases=None, meteor_function_words=None):
        self._gts_raw = gts
        self._res_raw = res
        self._meteor_synonyms = meteor_synonyms
        self._meteor_paraphrases = meteor_paraphrases
        self._meteor_function_words = meteor_function_words
        self._spice_lexicon = (spice_lexicon if spice_lexicon is not None
                               else os.environ.get("MVC_SPICE_LEXICON") or None)
        self._spice_synonyms = (spice_synonyms if spice_synonyms is not None
                                else os.environ.get("MVC_SPICE_SYNONYMS") or None)
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict[str, Dict[str, float]] = {}

    def evaluate(self) -> Dict[str, float]:
        tokenizer = PTBTokenizer()
        gts = tokenizer.tokenize({k: [{"caption": c} for c in v] for k, v in self._gts_raw.items()})
        res = tokenizer.tokenize({k: [{"caption": c} for c in v] for k, v in self._res_raw.items()})

        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(synonyms=self._meteor_synonyms, paraphrases=self._meteor_paraphrases,
                    function_words=self._meteor_function_words), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        if self._spice_lexicon is not None:
            scorers.append((Spice(lexicon=self._spice_lexicon, synonyms=self._spice_synonyms),
                            "SPICE"))
        ids = sorted(gts.keys())
        for scorer, method in scorers:
            score, scores = scorer.compute_score(gts, res)
            if isinstance(score, list):
                for m, s, per_img in zip(method, score, scores):
                    self.eval[m] = s
                    for img, v in zip(ids, per_img):
                        self.imgToEval.setdefault(img, {})[m] = float(v)
            else:
                self.eval[method] = score
                for img, v in zip(ids, scores):
                    if isinstance(v, dict):      # SPICE: per-video category dict
                        v = v["All"]["f"]
                    self.imgToEval.setdefault(img, {})[method] = float(v)
        return self.eval
