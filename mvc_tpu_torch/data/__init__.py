from mvc_tpu_torch.data.loader import get_loader
from mvc_tpu_torch.data.vocabulary import Vocabulary

__all__ = ["Vocabulary", "get_loader"]
