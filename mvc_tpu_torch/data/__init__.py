from mvc_tpu_torch.data.loader import get_loader
from mvc_tpu_torch.data.vocabulary import Vocabulary, build_msr_vtt_vocab, build_msvd_vocab

__all__ = ["Vocabulary", "build_msr_vtt_vocab", "build_msvd_vocab", "get_loader"]
