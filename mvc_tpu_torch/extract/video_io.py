"""Host-side media decode: the copy of ``mvc_tpu/extract/video_io.py``.

Mirrors the reference's decode path (reference src/extract_features.py:32-106):
cv2 frame decode with BGR->RGB + INTER_AREA resize + fps stride sampling, and
a wav sidecar for audio (the reference exports ``videos/x.avi`` ->
``audios/x.wav`` via moviepy and silence-fills mute clips, :42-49).

Without moviepy, the audio resolution order is:
1. sibling ``audios/<name>.wav`` (the reference's own layout)
2. ``ffmpeg`` on PATH (or $MVC_FFMPEG) to demux on the fly
3. silence for the clip duration (the reference's mute-clip behavior)
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from mvc_tpu_torch.ops.logmel import SAMPLE_RATE


# fourcc codes of intra-only codecs where per-frame seeking is exact and
# cheap (every frame is a keyframe; the AVI index maps frame -> offset).
_INTRA_FOURCC = {"MJPG", "mjpg", "MJPA", "jpeg", "JPEG", "I420", "IYUV", "RGBA"}


def _convert(frame, frame_size):
    import cv2

    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    return cv2.resize(frame, frame_size, interpolation=cv2.INTER_AREA)


def _sample_indexes(total: int, frame_rate: float, fps: Optional[float]):
    """The reference's stride sampling (src/extract_features.py:93-101):
    take_n = total//rate*fps frames at stride total//take_n.  None means
    'keep everything'."""
    if not fps or fps >= frame_rate:
        return None
    take_n = int(total // frame_rate * fps)
    if take_n <= 0:
        return None
    return np.arange(0, total, total // take_n)


def _load_frames_full(cap, frame_size, fps, frame_rate):
    """Reference-shaped fallback: decode + convert + resize EVERY frame,
    then stride-sample.  Used when container metadata is absent or wrong."""
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(_convert(frame, frame_size))
    if not frames:
        raise ValueError("no frames decoded")
    frames = np.asarray(frames)
    total = frames.shape[0]
    idx = _sample_indexes(total, frame_rate, fps)
    if idx is not None:
        frames = frames[idx]
    return frames, total / frame_rate


def load_frames(
    filename: str,
    frame_size: Tuple[int, int] = (299, 299),
    fps: Optional[float] = 1,
) -> Tuple[np.ndarray, float]:
    """Decode a video into [N, H, W, 3] uint8 RGB frames downsampled to
    ``fps`` via stride indexing (reference src/extract_features.py:69-106).
    Returns (frames, duration_seconds).

    The reference decodes, BGR->RGB-converts, and INTER_AREA-resizes every
    frame and then keeps ~1 in ``frame_rate/fps`` — on a 25 fps clip at
    fps=1 that is 25x more convert/resize work than the output needs, and
    host decode is the measured extraction bottleneck (BENCH_NOTES).  This
    loader produces bitwise-identical output while skipping the waste:

    - sampled indexes are computed up front from the container's frame
      count; only those frames are converted/resized
    - intra-only codecs (MJPG et al.) seek straight to each sampled frame,
      skipping the decode of unsampled frames entirely
    - inter-coded streams ``grab()`` (decode, no retrieve/convert) past
      unsampled frames and stop after the last sampled index
    - if the container metadata is missing or lies (grab/seek fails before
      the last sampled frame), the clip is re-decoded with the full
      reference-shaped path, so output parity never depends on metadata
    """
    import cv2

    cap = cv2.VideoCapture(filename)
    frame_rate = float(np.round(cap.get(cv2.CAP_PROP_FPS))) or 25.0
    meta_total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    if meta_total > 0:
        idx = _sample_indexes(meta_total, frame_rate, fps)
        wanted = (
            list(range(meta_total)) if idx is None else [int(i) for i in idx]
        )
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little")
        intra = fourcc.decode("latin1") in _INTRA_FOURCC
        frames = []
        ok = True
        if intra and idx is not None:
            for i in wanted:
                cap.set(cv2.CAP_PROP_POS_FRAMES, i)
                ret, frame = cap.read()
                if not ret:
                    ok = False
                    break
                frames.append(_convert(frame, frame_size))
        else:
            want = set(wanted)
            last = wanted[-1]
            for i in range(last + 1):
                if i in want:
                    ret, frame = cap.read()
                    if ret:
                        frames.append(_convert(frame, frame_size))
                else:
                    ret = cap.grab()
                if not ret:
                    ok = False
                    break
        if ok:
            cap.release()
            return np.asarray(frames), meta_total / frame_rate
        # metadata overstated the stream -> full reference-shaped re-decode
        cap.release()
        cap = cv2.VideoCapture(filename)

    try:
        return _load_frames_full(cap, frame_size, fps, frame_rate)
    except ValueError:
        raise ValueError(f"no frames decoded from {filename}")
    finally:
        cap.release()


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    return data, sr


def _resample(wav: np.ndarray, sr: int, target: int = SAMPLE_RATE) -> np.ndarray:
    if sr == target:
        return wav
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target)
    return resample_poly(wav, target // g, sr // g).astype(np.float32)


def _ffmpeg_exe() -> Optional[str]:
    return os.environ.get("MVC_FFMPEG") or shutil.which("ffmpeg")


def _sidecar_wav(filename: str) -> str:
    """videos/<name>.<ext> -> audios/<name>.wav (the reference's layout,
    src/extract_features.py:38-39)."""
    _, ext = os.path.splitext(filename)
    return filename.replace(f"{os.sep}videos{os.sep}", f"{os.sep}audios{os.sep}").replace(ext, ".wav")


def load_audio(filename: str, duration_hint: Optional[float] = None) -> np.ndarray:
    """Mono float32 waveform at 16 kHz for a video file (resolution order in
    the module docstring)."""
    sidecar = _sidecar_wav(filename)
    if os.path.isfile(sidecar):
        wav, sr = _read_wav(sidecar)
        return _resample(wav, sr)

    ffmpeg = _ffmpeg_exe()
    if ffmpeg:
        with tempfile.TemporaryDirectory() as td:
            out = os.path.join(td, "audio.wav")
            proc = subprocess.run(
                [ffmpeg, "-v", "error", "-i", filename, "-ac", "1",
                 "-ar", str(SAMPLE_RATE), "-f", "wav", out],
                capture_output=True,
            )
            if proc.returncode == 0 and os.path.isfile(out):
                wav, sr = _read_wav(out)
                return _resample(wav, sr)

    # Mute clip -> silence for the clip duration (reference behavior).
    duration = duration_hint if duration_hint is not None else 1.0
    return np.zeros(int(SAMPLE_RATE * max(duration, 1.0)), dtype=np.float32)
