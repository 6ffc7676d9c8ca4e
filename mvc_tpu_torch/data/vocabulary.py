"""Word <-> index vocabulary, the serving subset of ``mvc_tpu/data/vocabulary.py``:
load (our JSON or the reference's pickle), save, ``decode_indexes`` (stops at
the first ``<EOS>``) and ``__len__``.  Building a vocabulary and its tokenizer
belong to the training slice."""

from __future__ import annotations

import json
import pickle
from typing import Dict, Sequence

from mvc_tpu_torch.config import EOS_ID, PAD_ID, SOS_ID, UNK_ID

_SPECIALS = {PAD_ID: "<PAD>", SOS_ID: "<SOS>", EOS_ID: "<EOS>", UNK_ID: "<UNK>"}


class Vocabulary:
    def __init__(self, freq_threshold: int = 5):
        self.itos: Dict[int, str] = dict(_SPECIALS)
        self.stoi: Dict[str, int] = {w: i for i, w in _SPECIALS.items()}
        self.freq_threshold = freq_threshold

    def __len__(self) -> int:
        return len(self.itos)

    def decode_indexes(self, indexes: Sequence[int]) -> str:
        words = []
        for idx in indexes:
            idx = int(idx)
            if idx == EOS_ID:
                break
            words.append(self.itos[idx])
        return " ".join(words)

    def save(self, path: str) -> None:
        payload = {
            "freq_threshold": self.freq_threshold,
            "itos": {str(k): v for k, v in self.itos.items()},
        }
        with open(path, "w") as f:
            json.dump(payload, f)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        """Our JSON format, or the reference's pickled Vocabulary."""
        with open(path, "rb") as f:
            head = f.read(1)
        if head == b"{":
            with open(path, "r") as f:
                payload = json.load(f)
            vocab = Vocabulary(payload.get("freq_threshold", 5))
            vocab.itos = {int(k): v for k, v in payload["itos"].items()}
        else:
            with open(path, "rb") as f:
                obj = _ReferencePickleLoader(f).load()
            vocab = Vocabulary(getattr(obj, "freq_threshold", 5))
            vocab.itos = {int(k): v for k, v in obj.itos.items()}
        vocab.stoi = {v: k for k, v in vocab.itos.items()}
        return vocab


class _Shim:
    """Attribute bag standing in for the reference's Vocabulary class during
    unpickling (only ``itos`` / ``freq_threshold`` are read)."""

    def __init__(self, *a, **k):
        pass


class _ReferencePickleLoader(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "Vocabulary":
            return _Shim
        return super().find_class(module, name)
