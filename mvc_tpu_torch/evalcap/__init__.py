"""Caption scorers: own copies of ``mvc_tpu/evalcap``'s BLEU, METEOR,
ROUGE-L, CIDEr, SPICE, PTB tokenizer and Porter stemmer, ``NLPScore`` and
the ``COCOEvalCap`` harness.  METEOR's aligner, ROUGE-L's LCS and the PTB
scanner run in the native runtime (``csrc/native.cpp``, built with g++ by
``prepare_native()`` when a scorer is set up; ``native_status()``) where it
builds, else in the identical pure-Python paths."""

from mvc_tpu_torch.evalcap._native import native_status, use_native
from mvc_tpu_torch.evalcap._native import prepare as prepare_native
from mvc_tpu_torch.evalcap.bleu import Bleu
from mvc_tpu_torch.evalcap.cider import Cider
from mvc_tpu_torch.evalcap.eval import COCOEvalCap, NLPScore
from mvc_tpu_torch.evalcap.meteor import Meteor
from mvc_tpu_torch.evalcap.rouge import Rouge
from mvc_tpu_torch.evalcap.spice import Spice
from mvc_tpu_torch.evalcap.tokenizer import PTBTokenizer

__all__ = ["Bleu", "COCOEvalCap", "Cider", "Meteor", "NLPScore", "PTBTokenizer", "Rouge",
           "Spice", "native_status", "prepare_native", "use_native"]
