"""Caption scorers: own copies of ``mvc_tpu/evalcap``'s BLEU, METEOR,
ROUGE-L, CIDEr and Porter stemmer (pure Python, without the JAX package's
optional C++ extension, which gives the same scores) and ``NLPScore``."""

from mvc_tpu_torch.evalcap.bleu import Bleu
from mvc_tpu_torch.evalcap.cider import Cider
from mvc_tpu_torch.evalcap.eval import NLPScore
from mvc_tpu_torch.evalcap.meteor import Meteor
from mvc_tpu_torch.evalcap.rouge import Rouge

__all__ = ["Bleu", "Cider", "Meteor", "NLPScore", "Rouge"]
