"""Hand-written CUDA kernels, their wrappers and plain PyTorch versions."""
from mvc_tpu_torch.ops.logmel import log_mel_examples, log_mel_spectrogram
from mvc_tpu_torch.ops.resize import resize_frames

__all__ = ["log_mel_examples", "log_mel_spectrogram", "resize_frames"]
