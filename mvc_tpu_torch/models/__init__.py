"""Model parts of the port: attention, RNN cells, decoder, the captioners."""

from mvc_tpu_torch.models.captioning import AVCaptioning, AVCaptioningDual
from mvc_tpu_torch.models.transformer import TransformerCaptioning

__all__ = ["AVCaptioning", "AVCaptioningDual", "TransformerCaptioning"]
