"""``NLPScore``, the training loop's scorer (``mvc_tpu/evalcap/eval.py:22``)."""

from __future__ import annotations

from typing import Dict, List

from mvc_tpu_torch.evalcap.bleu import Bleu
from mvc_tpu_torch.evalcap.cider import Cider
from mvc_tpu_torch.evalcap.meteor import Meteor
from mvc_tpu_torch.evalcap.rouge import Rouge


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
