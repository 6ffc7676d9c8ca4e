"""Synthetic clip-set generator for extractor benchmarks and rehearsal runs:
the copy of ``mvc_tpu/extract/synthetic.py``.

Writes the reference's dataset layout (``videos/<name>.avi`` +
``audios/<name>.wav``, reference src/extract_features.py:127-128) with
cv2-encodable MJPG video and stdlib-wave PCM16 mono audio, so both our
batched extractor (mvc_tpu_torch/extract/features.py) and the reference's
one-clip-at-a-time loop can run on identical inputs without any media
dependencies beyond cv2.
"""

from __future__ import annotations

import os
import wave
from typing import List, Tuple

import numpy as np

from mvc_tpu_torch.ops.logmel import SAMPLE_RATE


def write_wav(path: str, wav: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    """float32 [-1,1] mono -> PCM16 WAV via the stdlib (no scipy needed)."""
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def make_clip_set(
    root: str,
    n_clips: int,
    seconds: float = 10.0,
    fps: int = 25,
    size: Tuple[int, int] = (320, 240),
    seed: int = 0,
) -> List[str]:
    """Write ``n_clips`` MJPG clips + WAV sidecars under ``root``; returns the
    clip basenames (``<name>.avi``).  Raises RuntimeError if cv2 cannot encode
    (headless containers without any codec)."""
    import cv2

    videos = os.path.join(root, "videos")
    audios = os.path.join(root, "audios")
    os.makedirs(videos, exist_ok=True)
    os.makedirs(audios, exist_ok=True)
    gen = np.random.default_rng(seed)
    names = []
    n_frames = int(round(seconds * fps))
    for i in range(n_clips):
        name = f"clip{i:03d}_0_{int(seconds)}"
        path = os.path.join(videos, f"{name}.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)
        if not w.isOpened():
            raise RuntimeError("cv2 VideoWriter cannot encode MJPG here")
        # low-frequency moving gradient: compresses small, decodes like video
        xx, yy = np.meshgrid(
            np.linspace(0, 2 * np.pi, size[0]), np.linspace(0, 2 * np.pi, size[1])
        )
        phase = gen.uniform(0, 2 * np.pi, size=3)
        for t in range(n_frames):
            frame = np.stack(
                [
                    127.5 * (1 + np.sin(xx + 0.1 * t + phase[c]) * np.cos(yy - 0.05 * t))
                    for c in range(3)
                ],
                axis=-1,
            ).astype(np.uint8)
            w.write(frame)
        w.release()
        if not (os.path.isfile(path) and os.path.getsize(path) > 0):
            raise RuntimeError(f"cv2 produced an empty clip at {path}")
        t_ax = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
        freq = gen.uniform(200, 2000)
        wav_data = 0.2 * np.sin(2 * np.pi * freq * t_ax).astype(np.float32)
        wav_data += 0.02 * gen.normal(size=t_ax.shape).astype(np.float32)
        write_wav(os.path.join(audios, f"{name}.wav"), wav_data)
        names.append(f"{name}.avi")
    return names
