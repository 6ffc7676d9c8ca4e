"""Device-resident feature cache (``mvc_tpu/data/feature_cache.py``).

Every unique clip's features go to the device once; per step the host
sends only caption ids and per-sample cache rows, and the feature gather,
the int8 dequantize and the frame mask happen on the device.
``quantize_int8`` is the one int8 quantizer of the package: the trainer's
int8 transfer, the int8 cache and the service's int8 wire all use it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from mvc_tpu_torch.config import PAD_ID
from mvc_tpu_torch.data.dataset import _bucket, load_clip_features

_STORE_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}


def quantize_int8(x: np.ndarray):
    """Per-(sample/clip, frame) max-abs int8 quantization over the feature
    axis -> (int8 payload, f32 scales), on the host in numpy exactly as the
    JAX package does it.  All-zero frames get scale 1.0 (their values are
    exactly zero either way)."""
    scale = np.max(np.abs(x), axis=-1, keepdims=True) / 127.0
    scale = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 payload times its f32 scales, where the tensors lie."""
    return q.float() * scale


class DeviceFeatureCache:
    """All unique clips' (audio, visual) features stacked to
    ``[N, T_store, D]`` tensors on ``device``, with per-clip frame counts.

    ``T_store`` is the frame bucket (of ``frame_buckets``) that covers the
    longest clip, so a cached batch pads to the same bucket as the
    uncached collator.  Storage is ``dtype``: float32, bfloat16 (cast on
    the host, round to nearest even), or int8 plus f32 scales
    (``quantize_int8``).  ``row_of`` maps video_id -> row; ``caption_rows``
    and ``caption_ids`` encode every (video, caption) item once for the
    loader's index path."""

    def __init__(self, dataset, dtype: Optional[str] = "bfloat16", device="cpu",
                 frame_buckets=None):
        if dtype not in _STORE_DTYPES:
            raise ValueError(f"cache dtype must be float32, bfloat16 or int8, got {dtype!r}")
        device = torch.device(device)
        video_ids = list(dict.fromkeys(vid for vid, _ in dataset.metadata))
        self.row_of: Dict[str, int] = {v: i for i, v in enumerate(video_ids)}
        feats = [load_clip_features(dataset.root_dir, vid, normalize=dataset.normalize,
                                    video_only=dataset.video_only) for vid in video_ids]
        lengths = np.array([a.shape[0] for a, _ in feats], dtype=np.int32)
        t_top = int(lengths.max()) if len(lengths) else 1
        t_store = _bucket(t_top, frame_buckets) if frame_buckets else t_top
        audio = np.zeros((len(feats), t_store, feats[0][0].shape[1]), np.float32)
        visual = np.zeros((len(feats), t_store, feats[0][1].shape[1]), np.float32)
        for i, (a, v) in enumerate(feats):
            audio[i, :a.shape[0]] = a
            visual[i, :v.shape[0]] = v
        self.t_top, self.t_store, self.lengths_np = t_top, t_store, lengths

        self._arrays = {"lengths": torch.from_numpy(lengths).to(device)}
        store = _STORE_DTYPES[dtype]
        for name, x in (("audio", audio), ("visual", visual)):
            if store == torch.int8:
                q, scale = quantize_int8(x)
                self._arrays[name] = torch.from_numpy(q).to(device)
                self._arrays[name + "_scale"] = torch.from_numpy(scale).to(device)
            else:
                self._arrays[name] = torch.from_numpy(x).to(store).to(device)

        self.caption_rows = np.array([self.row_of[v] for v, _ in dataset.metadata],
                                     dtype=np.int32)
        self.caption_ids = [np.asarray(dataset.vocab.encode_caption(c), dtype=np.int32)
                            for _, c in dataset.metadata]

    def arrays(self) -> Dict[str, torch.Tensor]:
        return self._arrays

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self._arrays.values())


def gather_features(cache_arrays, video_rows: torch.Tensor, t_pad: int,
                    sample_mask: Optional[torch.Tensor] = None):
    """Where the cache lies: rows -> (audio [B, t_pad, Da] f32, visual
    [B, t_pad, Dv] f32, feat_mask [B, t_pad] bool).  ``t_pad`` is a host
    int (bucketed by ``collate_index_batch``).  ``sample_mask`` zeroes the
    batch-padding rows, so the cached and uncached paths see the same
    tensors."""
    rows = video_rows.long()
    audio = cache_arrays["audio"][rows, :t_pad].float()
    visual = cache_arrays["visual"][rows, :t_pad].float()
    if "audio_scale" in cache_arrays:
        audio = audio * cache_arrays["audio_scale"][rows, :t_pad]
        visual = visual * cache_arrays["visual_scale"][rows, :t_pad]
    lens = cache_arrays["lengths"][rows]
    feat_mask = torch.arange(t_pad, device=lens.device)[None, :] < lens[:, None]
    if sample_mask is not None:
        keep = sample_mask[:, None]
        feat_mask = feat_mask & keep
        audio = audio * keep[..., None]
        visual = visual * keep[..., None]
    return audio, visual, feat_mask


def collate_index_batch(rows: np.ndarray, caption_ids_list, lengths: np.ndarray,
                        caption_buckets, frame_buckets, pad_batch_to: Optional[int] = None,
                        t_store: Optional[int] = None) -> Dict[str, object]:
    """Host-side collation of the index path: captions [L, B] int32,
    video_rows [B] int32, sample_mask [B] bool and the batch's frame bucket
    ``t_pad`` (a host int), clamped to the cache's ``t_store`` so the gather
    stays in range.  No feature bytes leave the host."""
    n = len(rows)
    b = pad_batch_to or n
    l_pad = _bucket(max(c.shape[0] for c in caption_ids_list), caption_buckets)
    t_max = int(lengths[rows].max())
    t_pad = min(_bucket(t_max, frame_buckets), int(t_store) if t_store else int(lengths.max()))
    captions = np.full((l_pad, b), PAD_ID, dtype=np.int32)
    video_rows = np.zeros((b,), dtype=np.int32)
    sample_mask = np.zeros((b,), dtype=bool)
    for i, (row, cap) in enumerate(zip(rows, caption_ids_list)):
        captions[:cap.shape[0], i] = cap
        video_rows[i] = row
        sample_mask[i] = True
    return {"captions": captions, "video_rows": video_rows, "sample_mask": sample_mask,
            "t_pad": t_pad}
