"""VGGish log-mel frontend (``mvc_tpu/ops/logmel.py``) in PyTorch.

The AudioSet VGGish input spec, as the JAX package computes it:

- mono waveform at 16 kHz
- STFT: 25 ms (400-sample) periodic-Hann windows, 10 ms (160) hop,
  ``rfft`` of length 512, magnitude
- 64 mel bands spanning 125–7500 Hz (HTK mel scale), one matmul
- log(mel + 0.01)
- framed into 0.96 s examples: 96 frames x 64 bands, example hop 0.96 s

The waveform is padded or truncated to a whole number of examples, and a
batch of padded waveforms goes through in one pass on whatever device it
lies on.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16000
STFT_WINDOW = 400          # 25 ms
STFT_HOP = 160             # 10 ms
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_FRAMES = 96        # 0.96 s of 10 ms frames
FFT_LENGTH = 512           # next pow2 >= window


def _hz_to_mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_filterbank(
    num_mel: int = NUM_MEL_BINS,
    num_spectrogram_bins: int = FFT_LENGTH // 2 + 1,
    sample_rate: int = SAMPLE_RATE,
    lower_hz: float = MEL_MIN_HZ,
    upper_hz: float = MEL_MAX_HZ,
) -> np.ndarray:
    """[num_spectrogram_bins, num_mel] triangular HTK-mel weight matrix (the
    AudioSet/VGGish construction: triangles linear in mel space, bin 0 zeroed)."""
    nyquist = sample_rate / 2.0
    spec_hz = np.linspace(0.0, nyquist, num_spectrogram_bins)
    spec_mel = _hz_to_mel(spec_hz)
    band_edges = np.linspace(_hz_to_mel(lower_hz), _hz_to_mel(upper_hz), num_mel + 2)
    weights = np.zeros((num_spectrogram_bins, num_mel))
    for i in range(num_mel):
        lower, center, upper = band_edges[i : i + 3]
        lower_slope = (spec_mel - lower) / (center - lower)
        upper_slope = (upper - spec_mel) / (upper - center)
        weights[:, i] = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    weights[0, :] = 0.0   # DC bin excluded
    return weights.astype(np.float32)


def _hann(window: int) -> np.ndarray:
    """Periodic Hann window, computed in float64 as the JAX package does."""
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(window) / window)


def stft_magnitude(x: torch.Tensor, window: int = STFT_WINDOW, hop: int = STFT_HOP,
                   fft_length: int = FFT_LENGTH) -> torch.Tensor:
    """[..., n_samples] -> [..., n_frames, fft_length // 2 + 1] magnitudes."""
    frames = x.unfold(-1, window, hop)
    win = torch.as_tensor(_hann(window), dtype=x.dtype, device=x.device)
    return torch.fft.rfft(frames * win, n=fft_length, dim=-1).abs()


def log_mel_spectrogram(waveform: torch.Tensor) -> torch.Tensor:
    """[..., n_samples] @16kHz -> [..., n_frames, 64] log-mel."""
    mag = stft_magnitude(waveform)
    mel = mag @ torch.as_tensor(mel_filterbank(), device=waveform.device)
    return torch.log(mel + LOG_OFFSET)


def log_mel_examples_batch(waveforms: torch.Tensor, num_examples: int) -> torch.Tensor:
    """[N, S] waveforms -> [N, num_examples, 96, 64] in one pass.  Each row
    is zero-padded or truncated to exactly ``samples_for(num_examples)``
    samples; callers drop the examples past a clip's own length."""
    needed = samples_for(num_examples)
    n, s = waveforms.shape
    if s >= needed:
        wav = waveforms[:, :needed]
    else:
        wav = torch.zeros((n, needed), dtype=waveforms.dtype, device=waveforms.device)
        wav[:, :s] = waveforms
    logmel = log_mel_spectrogram(wav)                       # [N, num_examples * 96, 64]
    return logmel.reshape(n, num_examples, EXAMPLE_FRAMES, NUM_MEL_BINS)


def log_mel_examples(waveform: torch.Tensor, num_examples: int) -> torch.Tensor:
    """[n_samples] -> [num_examples, 96, 64]: fixed-count 0.96 s examples."""
    return log_mel_examples_batch(waveform[None], num_examples)[0]


def samples_for(num_examples: int) -> int:
    """Waveform samples consumed by ``num_examples`` whole examples."""
    return (num_examples * EXAMPLE_FRAMES - 1) * STFT_HOP + STFT_WINDOW


def num_examples_for(n_samples: int) -> int:
    """How many whole 0.96 s examples a waveform yields (VGGish framing)."""
    window = EXAMPLE_FRAMES * STFT_HOP - STFT_HOP + STFT_WINDOW
    if n_samples < window:
        return 0
    n_frames = (n_samples - STFT_WINDOW) // STFT_HOP + 1
    return n_frames // EXAMPLE_FRAMES
