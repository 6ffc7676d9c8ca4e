"""Feature extraction (``mvc_tpu/extract``): videos -> per-frame visual
features and per-0.96 s audio embeddings, encoded on the card."""

from mvc_tpu_torch.extract.encoders import AudioEncoder, VisualEncoder
from mvc_tpu_torch.extract.features import FeatureExtractor

__all__ = ["AudioEncoder", "FeatureExtractor", "VisualEncoder"]
