"""Encoder facades with the reference's VisualEncoder / AudioEncoder API
(``mvc_tpu/extract/encoders.py``; reference src/models/visual_encoder.py,
src/models/audio_encoder.py), on the card unless the caller passes
``device="cpu"``.  Both run in full float32 (no TF32)."""

from __future__ import annotations

import numpy as np
import torch

from mvc_tpu_torch.extract.video_io import _resample
from mvc_tpu_torch.models import inception_v3 as iv3
from mvc_tpu_torch.models import resnet as rn
from mvc_tpu_torch.models import vggish as vg
from mvc_tpu_torch.ops.logmel import log_mel_examples, num_examples_for
from mvc_tpu_torch.utils.device import resolve_device
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree


def visual_backbone(model: str, params, device, seed: int = 0):
    """(params on ``device``, frame size, features function) of a visual
    model: "inception_v3" (299px -> 2048-d pooled) or "resnet" (ResNet-101
    at 224px whose fc is kept: 1000-d logits, PARITY.md).  ``params=None``
    draws random weights from ``torch.Generator().manual_seed(seed)``."""
    if model == "resnet":
        init, size, features = rn.init_resnet101, (224, 224), rn.resnet101_features
    elif model == "inception_v3":
        init, size, features = iv3.init_inception_v3, (299, 299), iv3.inception_v3_features
    else:
        raise ValueError(f"unknown visual_model {model!r}")
    if params is None:
        params = init(torch.Generator().manual_seed(seed))
    return from_numpy_tree(params, device, torch.float32), size, features


class VisualEncoder:
    """Per-frame CNN embedding: frames -> [N, D] (or [B, T, D] for stacked
    5-D input).  ``model`` is the reference's switch: "inception_v3" ->
    2048-d pooled features at 299px, "resnet" -> 1000-d logits at 224px."""

    def __init__(self, model: str = "inception_v3", normalize: bool = True,
                 trainable: bool = False, params=None, scale_to_unit: bool = False,
                 device="cuda"):
        del trainable  # inference-only, like the reference with trainable=False
        self.device = resolve_device(device)
        self.normalize = normalize
        self.scale_to_unit = scale_to_unit
        self.params, self.input_size, self._features = visual_backbone(model, params,
                                                                       self.device, seed=0)

    def __call__(self, frames: np.ndarray) -> np.ndarray:
        """frames: [N, H, W, 3] or [B, T, H, W, 3] (NHWC)."""
        frames = np.asarray(frames, np.float32)
        shape = frames.shape
        if frames.ndim == 5:
            frames = frames.reshape(-1, *shape[2:])
        x = torch.from_numpy(frames).to(self.device)
        with torch.inference_mode(), iv3.full_float32():
            if self.normalize:
                x = iv3.imagenet_normalize(x, scale_to_unit=self.scale_to_unit)
            else:
                x = x.permute(0, 3, 1, 2)
            feats = self._features(self.params, x).cpu().numpy()
        if len(shape) == 5:
            feats = feats.reshape(shape[0], shape[1], -1)
        return feats


class AudioEncoder:
    """VGGish embedding: waveform -> [N, 128] (one row per 0.96 s)."""

    def __init__(self, model: str = "vggish", trainable: bool = False, params=None,
                 device="cuda"):
        if model != "vggish":
            raise ValueError(f"unsupported audio encoder {model}")
        del trainable
        self.device = resolve_device(device)
        if params is None:
            params = vg.init_vggish(torch.Generator().manual_seed(1))
        self.params = from_numpy_tree(params, self.device, torch.float32)

    def from_tensor(self, audio: np.ndarray, sr: int) -> np.ndarray:
        """audio: [C, N] channels-first (the reference's from_tensor
        contract) or [N]; resampled to 16 kHz."""
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 2:
            audio = audio.mean(axis=0)
        audio = _resample(audio, sr)
        n = max(num_examples_for(audio.shape[0]), 1)
        with torch.inference_mode(), iv3.full_float32():
            examples = log_mel_examples(torch.from_numpy(audio).to(self.device), n)
            return vg.vggish_embeddings(self.params, examples).cpu().numpy()

    def __call__(self, audio: np.ndarray, sr: int = 16000) -> np.ndarray:
        return self.from_tensor(np.atleast_2d(audio), sr)
