"""What every kind of cell shares: the outcome of a run, the vocabulary,
the model the configuration names, clip features made on the device,
and the wrapper that marks and counts the window's calls into the
program."""

from __future__ import annotations

import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.harness import counts, traffic


@dataclass
class Outcome:
    """One run: end-to-end values, the numbers compared with their limits,
    and what the per-layer readers read."""

    setup_s: float
    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: List[Tuple[str, float, Optional[float]]]     # (name, value, limit)
    layer: Dict[str, object] = field(default_factory=dict)
    summary: object = None                                # trace.Summary of the traced run
    memory_peak_bytes: int = 0
    notes: List[str] = field(default_factory=list)       # printed on stderr

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(limit is not None and value <= limit
                                        for _, value, limit in self.checks)


def word(i: int) -> str:
    return f"w{i:04d}"


def vocab(config: dict):
    """The program's vocabulary over ``vocab_size`` words w0004, w0005, ...
    after the four specials."""
    from mvc_tpu_torch.data.vocabulary import Vocabulary

    v = Vocabulary(freq_threshold=1)
    for i in range(4, config["vocab_size"]):
        v.itos[i] = word(i)
        v.stoi[word(i)] = i
    return v


SPECIALS = {"<PAD>": 0, "<SOS>": 1, "<EOS>": 2, "<UNK>": 3}


def text_to_ids(text: str) -> List[int]:
    """A served caption's word ids, read back from its text alone."""
    return [SPECIALS[w] if w in SPECIALS else int(w[1:]) for w in text.split()]


def decs(config: dict) -> List[counts.Dec]:
    """The counting widths of each decoder of ``config``."""
    return [counts.Dec(F, config["embedding_size"], config["hidden_size"], config["attn_size"],
                       config["vocab_size"]) for F in config["decoders"].values()]


def feature_dim(config: dict) -> int:
    return sum(config["features"].values())


def model(config: dict, device, reconstructor: str = "none"):
    """The program's captioner that ``config["model"]`` names, in float32,
    each decoder at the configuration's widths (``decoder_args``: the
    constructor's argument for each decoder)."""
    from mvc_tpu_torch import models
    from mvc_tpu_torch.config import DecoderConfig

    kw = {arg: DecoderConfig(rnn_type=config["rnn_type"], rnn_num_layers=config["num_layers"],
                             rnn_hidden_size=config["hidden_size"],
                             in_feature_size=config["decoders"][name],
                             embedding_size=config["embedding_size"],
                             attn_size=config["attn_size"], output_size=config["vocab_size"])
          for arg, name in config["decoder_args"].items()}
    cls = getattr(models, config["model"])
    return cls(vocab_size=config["vocab_size"], reconstructor_type=reconstructor,
               dtype=torch.float32, device=device, **kw)


def decoder_params(config: dict, params: Dict[str, dict]) -> List[dict]:
    return [params[name] for name in config["decoders"]]


def reference_feats(config: dict, audio: torch.Tensor, visual: torch.Tensor) -> List[torch.Tensor]:
    """Each decoder's features as the configuration composes them: the dual
    model's visual and audio decoders their own stream, the single model's
    one decoder ``[audio | visual]``."""
    streams = {"audio": audio, "visual": visual}
    out = []
    for inputs in config["decoder_inputs"].values():
        out.append(torch.cat([streams[s] for s in inputs], dim=-1))
    return out


def clip_features(config: dict, n: int, T: int, lengths: Sequence[int], seed: int, stream: int,
                  device) -> Tuple[np.ndarray, np.ndarray]:
    """Host (audio [n, T, A], visual [n, T, V]) float32 features drawn on the
    device from the seed, zero past each clip's length."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + stream) % (2 ** 63))
    dims = config["features"]
    x = torch.randn((n, T, dims["audio"] + dims["visual"]), generator=gen, device=device)
    keep = torch.arange(T, device=device)[None, :] < torch.as_tensor(
        np.asarray(lengths), device=device)[:, None]
    x = (x * keep[:, :, None]).cpu().numpy()
    return (np.ascontiguousarray(x[:, :, :dims["audio"]]),
            np.ascontiguousarray(x[:, :, dims["audio"]:]))


class Calls:
    """Stands in for the model where the program calls ``predict_tokens``:
    logs each call's batch shape, in launch order, and passes everything
    else through.  ``fault`` (tests only) alters what the call returns:
    ``fault(tokens, feat_mask)``."""

    def __init__(self, model, fault: Optional[Callable] = None):
        self._model = model
        self._fault = fault
        self._lock = threading.Lock()
        self.log: List[Tuple[int, int]] = []       # (rows, frames) of each call

        @functools.wraps(model.predict_tokens)
        def predict_tokens(params, audio, visual, *a, **kw):
            with self._lock:
                self.log.append((int(visual.shape[0]), int(visual.shape[1])))
            out = self._model.predict_tokens(params, audio, visual, *a, **kw)
            return self._fault(out, kw.get("feat_mask")) if self._fault is not None else out

        self.predict_tokens = predict_tokens

    def __getattr__(self, name):
        return getattr(self._model, name)

    def reset(self):
        with self._lock:
            self.log.clear()


def sample(ids, lengths, n: int, seed: int) -> List[int]:
    """n of ``ids`` checked after a window: the first with the largest
    ``lengths[id]`` and the rest drawn from the seed, in order."""
    ids = list(ids)
    longest = max(ids, key=lambda i: (int(lengths[i]), -i))
    rest = [i for i in ids if i != longest]
    drawn = traffic.rng(seed, 5).choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(int(i) for i in drawn)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def weights_for(config: dict, seed: int, device) -> Dict[str, dict]:
    """The configuration's decoder parameters from the seed."""
    from benchmark.harness import weights

    return weights.make(config, seed, device)


class Phases:
    """Seconds of each phase of set-up, for the run's notes."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str):
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now

    def __str__(self):
        return "set-up phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in self.seconds.items())

