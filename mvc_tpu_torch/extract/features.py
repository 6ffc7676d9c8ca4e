"""Batched feature extraction (``mvc_tpu/extract/features.py``) on the card.

The reference extracts one clip at a time: decode, Inception on that
clip's frames, VGGish on that clip's audio, save, repeat (reference
src/extract_features.py:140-161).  Here:

- host decode (cv2, wav sidecar) runs in a thread pool, and
  ``extract_dataset`` decodes chunk i+1 on a host thread while chunk i
  encodes on the card
- the frames of MANY clips are flattened into one batch padded to a
  bucket (64, 128, 256, then multiples of 256) and go through the visual
  CNN at once; the padded waveforms go through one batched log-mel, and
  their examples through VGGish, padded to an audio bucket (8, 16, 32, 64)
- the results are split back per clip and saved with the reference's
  ``.npy`` contract (``features/video/<id>.npy`` [T, 2048] or [T, 1000]
  with ResNet, ``features/audio/<id>.npy`` [N, 128]), skipping clips whose
  features exist (:153-156)

The encoders run on ``device`` in full float32 (no TF32) and hand back
float32 numpy arrays.  With ``mesh`` (``parallel/mesh.py``) the padded
frame and example batches are rounded up to a multiple of the mesh's
devices and split over them in order, each shard's CNN and VGGish on its
own device (``ops/sharded.map_shards``; the weights copied to each device
once), as the JAX extractor shards over every mesh device.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mvc_tpu_torch.extract.encoders import visual_backbone
from mvc_tpu_torch.extract.video_io import load_audio, load_frames
from mvc_tpu_torch.models import inception_v3 as iv3
from mvc_tpu_torch.models import vggish as vg
from mvc_tpu_torch.ops import sharded
from mvc_tpu_torch.ops.logmel import log_mel_examples_batch, num_examples_for, samples_for
from mvc_tpu_torch.utils.device import resolve_device
from mvc_tpu_torch.utils.jax_weights import from_numpy_tree


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


def _round_to_shards(n: int, shards: int) -> int:
    """A padded batch rounded up to divide the mesh's shards."""
    return ((n + shards - 1) // shards) * shards


class FeatureExtractor:
    """Batched Inception-v3 (or ResNet-101) + VGGish extractor with the
    reference's ``extract(filename, fps, to_numpy)`` API and
    ``extract_batch`` / ``extract_dataset`` for cross-clip batching.
    ``inception_params`` / ``vggish_params`` are the port's trees
    (``convert_*`` of a torch state dict, or ``encoder_from_jax``); None
    draws random weights from ``torch.Generator().manual_seed(seed)``
    (``seed + 1`` for VGGish)."""

    def __init__(
        self,
        inception_params=None,
        vggish_params=None,
        fps: float = 1,
        frame_buckets: Sequence[int] = (64, 128, 256),
        audio_buckets: Sequence[int] = (8, 16, 32, 64),
        scale_to_unit: bool = False,
        decode_workers: Optional[int] = None,
        seed: int = 0,
        visual_model: str = "inception_v3",
        mesh=None,
        device="cuda",
    ):
        # cv2 decode scales with real cores; oversubscribing a core slows it
        if decode_workers is None:
            decode_workers = min(8, os.cpu_count() or 1)
        self.device = resolve_device(device)
        self.mesh = mesh
        self._shard_devices = mesh.local().devices if mesh is not None else [self.device]
        if self._shard_devices[0] != self.device:
            raise ValueError(f"the mesh's first device {self._shard_devices[0]} is not the "
                             f"extractor's {self.device}")
        self.visual_model = visual_model
        self.inception_params, self.frame_size, self._visual_features = visual_backbone(
            visual_model, inception_params, self.device, seed)
        if vggish_params is None:
            vggish_params = vg.init_vggish(torch.Generator().manual_seed(seed + 1))
        self.vggish_params = from_numpy_tree(vggish_params, self.device, torch.float32)
        self.fps = fps
        self.frame_buckets = tuple(frame_buckets)
        self.audio_buckets = tuple(audio_buckets)
        self.scale_to_unit = scale_to_unit
        self.decode_workers = decode_workers

    # ------------------------------------------------------------ decode
    def _decode_one(self, filename: str, fps: Optional[float] = None):
        frames, duration = load_frames(filename, frame_size=self.frame_size,
                                       fps=self.fps if fps is None else fps)
        wav = load_audio(filename, duration_hint=duration)
        return frames, wav

    # ------------------------------------------------------------ encode
    def _sharded(self, fn, params, x: torch.Tensor) -> torch.Tensor:
        """``fn(params, x)`` over the mesh's devices, one row block each (the
        whole batch on ``device`` without a mesh)."""
        if self.mesh is None:
            return fn(params, x)
        return sharded.map_shards(
            self._shard_devices, lambda i, d, blocks: fn(sharded.replica(params, d), blocks[0]),
            [x], self.device)

    def _encode_frame_stack(self, all_frames: np.ndarray) -> torch.Tensor:
        """[M, H, W, 3] uint8 -> [M, D] visual features on the device; the
        batch is padded with zero frames to its bucket (a multiple of the
        mesh's devices), whose rows are computed and dropped."""
        m = all_frames.shape[0]
        target = _round_to_shards(_bucket(m, self.frame_buckets), len(self._shard_devices))
        frames = torch.zeros((target, *all_frames.shape[1:]), dtype=torch.uint8,
                             device=self.device)
        frames[:m] = torch.from_numpy(all_frames).to(self.device)

        def encode(params, frames_u8):
            x = iv3.imagenet_normalize(frames_u8, scale_to_unit=self.scale_to_unit)
            return self._visual_features(params, x)

        return self._sharded(encode, self.inception_params, frames)[:m]

    def _encode_audio_stack(self, examples: torch.Tensor) -> torch.Tensor:
        """[M, 96, 64] -> [M, 128] on the device, padded to an audio bucket
        (a multiple of the mesh's devices)."""
        m = examples.shape[0]
        if m == 0:
            return torch.zeros((0, 128), device=self.device)
        target = _round_to_shards(_bucket(m, self.audio_buckets), len(self._shard_devices))
        padded = torch.zeros((target, *examples.shape[1:]), device=self.device)
        padded[:m] = examples
        return self._sharded(vg.vggish_embeddings, self.vggish_params, padded)[:m]

    # ------------------------------------------------------------ public
    def extract(self, filename: str, fps: Optional[float] = None, to_numpy: bool = True):
        """Single-clip extraction (reference API; the per-call ``fps``
        overrides the constructor's).  Returns (video_f [T, D], audio_f [N, 128])."""
        return self.extract_batch([filename], fps=fps)[0]

    def extract_batch(self, filenames: Sequence[str], fps: Optional[float] = None
                      ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Extract many clips in one encode.  Returns [(video_features,
        audio_features)] in input order."""
        if self.decode_workers > 1:
            with ThreadPoolExecutor(max_workers=self.decode_workers) as pool:
                decoded = list(pool.map(lambda f: self._decode_one(f, fps), filenames))
        else:
            decoded = [self._decode_one(f, fps) for f in filenames]
        return self._encode_decoded(decoded)

    def _encode_decoded(self, decoded) -> List[Tuple[np.ndarray, np.ndarray]]:
        """[(frames [T, H, W, 3] uint8, waveform [S] float32 at 16 kHz)] ->
        [(video_features, audio_features)] as float32 numpy."""
        frame_counts = [d[0].shape[0] for d in decoded]
        ex_counts = [max(num_examples_for(w.shape[0]), 1) for _, w in decoded]
        max_ex = max(ex_counts)
        wav_len = samples_for(max_ex)
        wavs = np.zeros((len(decoded), wav_len), np.float32)
        for i, (_, w) in enumerate(decoded):
            n = min(w.shape[0], wav_len)
            wavs[i, :n] = w[:n]
        with torch.inference_mode(), iv3.full_float32():
            # visual: the frames of every clip in one padded batch
            feats = self._encode_frame_stack(
                np.concatenate([d[0] for d in decoded], axis=0)).cpu().numpy()
            # audio: one batched log-mel over the padded waveforms
            examples = log_mel_examples_batch(torch.from_numpy(wavs).to(self.device), max_ex)
            embs = self._encode_audio_stack(
                torch.cat([examples[i, :c] for i, c in enumerate(ex_counts)])).cpu().numpy()
        video_out = np.split(feats, np.cumsum(frame_counts)[:-1])
        audio_out = np.split(embs, np.cumsum(ex_counts)[:-1])
        return list(zip(video_out, audio_out))

    def extract_dataset(
        self,
        videos_dir: str,
        features_dir: str,
        batch_size: int = 16,
        skip_existing: bool = True,
        verbose: bool = True,
    ) -> Dict[str, int]:
        """Directory sweep with the reference's skip-existing contract,
        batched across clips.  A clip that fails to decode is counted and
        skipped; the rest go on."""
        video_feat_dir = os.path.join(features_dir, "video")
        audio_feat_dir = os.path.join(features_dir, "audio")
        os.makedirs(video_feat_dir, exist_ok=True)
        os.makedirs(audio_feat_dir, exist_ok=True)

        todo = []
        skipped = 0
        for f in sorted(os.listdir(videos_dir)):
            name, _ = os.path.splitext(f)
            vpath = os.path.join(video_feat_dir, f"{name}.npy")
            apath = os.path.join(audio_feat_dir, f"{name}.npy")
            if skip_existing and os.path.isfile(vpath) and os.path.isfile(apath):
                skipped += 1
                continue
            todo.append((os.path.join(videos_dir, f), name))

        failures = []
        done = 0
        chunks = [todo[i : i + batch_size] for i in range(0, len(todo), batch_size)]

        # Busy time of host decode and of encode (+ save).  The two stages
        # overlap in the pipeline below, so the sums can exceed the wall
        # time; the larger one bounds it.
        times = {"decode_s": 0.0, "encode_s": 0.0}

        def decode_chunk(chunk):
            """Per-clip decode with failure isolation."""
            t0 = time.perf_counter()
            out = []
            for path, name in chunk:
                try:
                    out.append((name, self._decode_one(path)))
                except Exception as e:  # a bad clip must not stop the sweep
                    failures.append((path, str(e)))
            times["decode_s"] += time.perf_counter() - t0
            return out

        stager = ThreadPoolExecutor(max_workers=1)
        try:
            fut = stager.submit(decode_chunk, chunks[0]) if chunks else None
            for i in range(len(chunks)):
                decoded_named = fut.result()
                fut = stager.submit(decode_chunk, chunks[i + 1]) if i + 1 < len(chunks) else None
                if not decoded_named:
                    continue
                t0 = time.perf_counter()
                names = [n for n, _ in decoded_named]
                results = self._encode_decoded([d for _, d in decoded_named])
                for name, (video_f, audio_f) in zip(names, results):
                    np.save(os.path.join(video_feat_dir, name), video_f)
                    np.save(os.path.join(audio_feat_dir, name), audio_f)
                    done += 1
                times["encode_s"] += time.perf_counter() - t0
                if verbose:
                    print(f"extracted {done}/{len(todo)} (skipped {skipped}, "
                          f"failures {len(failures)})")
        finally:
            stager.shutdown(wait=True)
        if failures and verbose:
            print("failures:", failures)
        return {"done": done, "skipped": skipped, "failures": len(failures),
                "decode_s": round(times["decode_s"], 3),
                "encode_s": round(times["encode_s"], 3)}
