from mvc_tpu_torch.data.vocabulary import Vocabulary

__all__ = ["Vocabulary"]
