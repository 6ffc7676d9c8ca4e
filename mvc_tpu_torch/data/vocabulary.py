"""Word <-> index vocabulary (``mvc_tpu/data/vocabulary.py``):

- specials ``<PAD>=0, <SOS>=1, <EOS>=2, <UNK>=3``
- a word enters the vocabulary the moment its running count reaches
  ``freq_threshold``, so the id order follows the sentences' order
- ``numericalize`` maps OOV words to ``<UNK>``; ``apply_vocab`` rewrites
  them to the literal ``"<UNK>"`` for ground-truth captions
- ``decode_indexes`` stops at the first ``<EOS>``
- load reads our JSON or the reference's pickle; save writes JSON
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, Iterable, List, Sequence

from mvc_tpu_torch.config import EOS_ID, PAD_ID, SOS_ID, UNK_ID
from mvc_tpu_torch.data.tokenizer import tokenize

_SPECIALS = {PAD_ID: "<PAD>", SOS_ID: "<SOS>", EOS_ID: "<EOS>", UNK_ID: "<UNK>"}


class Vocabulary:
    def __init__(self, freq_threshold: int = 5):
        self.itos: Dict[int, str] = dict(_SPECIALS)
        self.stoi: Dict[str, int] = {w: i for i, w in _SPECIALS.items()}
        self.freq_threshold = freq_threshold

    def __len__(self) -> int:
        return len(self.itos)

    @staticmethod
    def tokenizer_eng(text: str) -> List[str]:
        return tokenize(text)

    def build_vocabulary(self, sentence_list: Iterable[str]) -> None:
        """Streaming frequency-threshold build: a word takes the next id the
        moment its count reaches the threshold."""
        frequencies: Dict[str, int] = {}
        idx = len(_SPECIALS)
        for sentence in sentence_list:
            for word in self.tokenizer_eng(sentence):
                frequencies[word] = frequencies.get(word, 0) + 1
                if frequencies[word] == self.freq_threshold:
                    self.stoi[word] = idx
                    self.itos[idx] = word
                    idx += 1

    def numericalize(self, text: str) -> List[int]:
        return [self.stoi.get(tok, UNK_ID) for tok in self.tokenizer_eng(text)]

    def encode_caption(self, text: str) -> List[int]:
        """<SOS> + tokens + <EOS>."""
        return [SOS_ID, *self.numericalize(text), EOS_ID]

    def apply_vocab(self, sentence: str) -> str:
        toks = [t if t in self.stoi else "<UNK>" for t in self.tokenizer_eng(sentence)]
        return " ".join(toks)

    @staticmethod
    def prebuild(sentence_list: Iterable[str], outpath: str,
                 freq_threshold: int = 5) -> "Vocabulary":
        vocab = Vocabulary(freq_threshold)
        vocab.build_vocabulary(sentence_list)
        vocab.save(outpath)
        return vocab

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
