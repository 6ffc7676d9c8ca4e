"""Caption scorers: own copies of ``mvc_tpu/evalcap``'s BLEU, METEOR,
ROUGE-L, CIDEr, SPICE, PTB tokenizer and Porter stemmer (pure Python,
without the JAX package's optional C++ extension, which gives the same
scores), ``NLPScore`` and the ``COCOEvalCap`` harness."""

from mvc_tpu_torch.evalcap.bleu import Bleu
from mvc_tpu_torch.evalcap.cider import Cider
from mvc_tpu_torch.evalcap.eval import COCOEvalCap, NLPScore
from mvc_tpu_torch.evalcap.meteor import Meteor
from mvc_tpu_torch.evalcap.rouge import Rouge
from mvc_tpu_torch.evalcap.spice import Spice
from mvc_tpu_torch.evalcap.tokenizer import PTBTokenizer

__all__ = ["Bleu", "COCOEvalCap", "Cider", "Meteor", "NLPScore", "PTBTokenizer", "Rouge",
           "Spice"]
