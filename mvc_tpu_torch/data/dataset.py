"""Datasets over precomputed ``.npy`` feature pairs and their collation
(``mvc_tpu/data/dataset.py``), without pandas.

Per item, the reference's semantics: one training item per (video,
caption) pair; caption tokens ``<SOS> + numericalize + <EOS>``; a 1-frame
audio feature of shape ``(128,)`` reshaped to ``(-1, 128)``; both
modalities cut to the shorter one; optional frame-sum normalization;
``video_only`` zeroes the audio.  Batches are padded to the frame and
caption bucket ladders with explicit masks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mvc_tpu_torch.config import AUDIO_FEATURE_DIM, PAD_ID
from mvc_tpu_torch.data.metadata import read_msr_vtt_metadata, read_msvd_metadata
from mvc_tpu_torch.data.vocabulary import Vocabulary


def load_clip_features(root_dir: str, video_id: str, normalize: bool = False,
                       video_only: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """The (audio, visual) feature pair of one clip, float32."""
    video_features = np.load(os.path.join(root_dir, "features", "video", f"{video_id}.npy"))
    audio_features = np.load(os.path.join(root_dir, "features", "audio", f"{video_id}.npy"))
    if audio_features.ndim < 2:
        audio_features = audio_features.reshape((-1, AUDIO_FEATURE_DIM))
    n_frames = min(video_features.shape[0], audio_features.shape[0])
    video_features = np.asarray(video_features[:n_frames], dtype=np.float32)
    audio_features = np.asarray(audio_features[:n_frames], dtype=np.float32)
    if normalize:
        video_features = video_features / np.sum(video_features, axis=1, keepdims=True)
        audio_features = audio_features / np.sum(audio_features, axis=1, keepdims=True)
    if video_only:
        audio_features = audio_features * 0
    return audio_features, video_features


def _read_metadata(root_dir: str, dataset: str, split: str, verbose: bool = True):
    if dataset not in ("MSVD", "MSR-VTT"):
        raise ValueError("Dataset must be one of ['MSVD', 'MSR-VTT']")
    if split not in ("train", "val", "test", "tiny"):
        raise ValueError("Wrong split specified, must be one of ['train', 'val', 'test', 'tiny']")
    if dataset == "MSVD" or split == "tiny":
        return read_msvd_metadata(root_dir, split, verbose=verbose)
    return read_msr_vtt_metadata(root_dir, split, verbose=verbose)


class VideoCaptioningDataset:
    """One item per (video, caption) pair; ``metadata`` is the list of
    ``(video_id, caption)`` rows."""

    def __init__(self, root_dir: str, dataset: str = "MSVD", split: str = "train",
                 freq_threshold: int = 5, vocab_path: Optional[str] = None,
                 normalize: bool = False, video_only: bool = False, verbose: bool = True):
        for sub in ("", "metadata", "features"):
            if not os.path.isdir(os.path.join(root_dir, sub)):
                raise FileNotFoundError(f"dataset directory missing: {os.path.join(root_dir, sub)}")
        self.root_dir = root_dir
        self.normalize = normalize
        self.video_only = video_only
        self.metadata = _read_metadata(root_dir, dataset, split, verbose=verbose)
        if vocab_path is None:
            if verbose:
                print("Building Vocab")
            self.vocab = Vocabulary(freq_threshold)
            self.vocab.build_vocabulary([caption for _, caption in self.metadata])
        else:
            if verbose:
                print(f"Loading Vocab: {vocab_path}")
            self.vocab = Vocabulary.load(vocab_path)

    def __len__(self) -> int:
        return len(self.metadata)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        video_id, caption = self.metadata[index]
        caption_ids = np.asarray(self.vocab.encode_caption(caption), dtype=np.int32)
        audio, visual = load_clip_features(self.root_dir, video_id, normalize=self.normalize,
                                           video_only=self.video_only)
        return {"video_id": video_id, "audio": audio, "visual": visual, "caption": caption_ids}


class VideoCaptionsDataset:
    """One item per video with the list of all its ground-truth captions:
    the evaluation-side dataset."""

    def __init__(self, root_dir: str, vid_cap_dict: Dict[str, List[str]],
                 normalize: bool = False, video_only: bool = False):
        self.root_dir = root_dir
        self.normalize = normalize
        self.video_only = video_only
        self.vid_cap_dict = vid_cap_dict
        self.video_ids = list(vid_cap_dict.keys())

    def __len__(self) -> int:
        return len(self.video_ids)

    def __getitem__(self, index: int) -> Dict[str, object]:
        video_id = self.video_ids[index]
        audio, visual = load_clip_features(self.root_dir, video_id, normalize=self.normalize,
                                           video_only=self.video_only)
        return {"video_id": video_id, "audio": audio, "visual": visual,
                "captions": self.vid_cap_dict[video_id]}


def video_dataset_to_video_captions_loader(dataset: VideoCaptioningDataset,
                                           batch_size: int = 32, normalize: bool = False,
                                           video_only: bool = False,
                                           frame_buckets: Sequence[int] = (8, 16, 32, 48, 64)):
    """Group a (video, caption)-pair dataset by video, videos in first-seen
    order, and wrap it in an unshuffled eval loader; ground-truth captions
    pass through ``apply_vocab`` so OOV words become ``"<UNK>"``."""
    from mvc_tpu_torch.data.loader import EvalDataLoader

    vid_captions: Dict[str, List[str]] = {}
    for video_id, caption in dataset.metadata:
        vid_captions.setdefault(video_id, []).append(dataset.vocab.apply_vocab(caption))
    eval_dataset = VideoCaptionsDataset(dataset.root_dir, vid_captions, normalize=normalize,
                                        video_only=video_only)
    return EvalDataLoader(eval_dataset, batch_size=batch_size, frame_buckets=frame_buckets)


# ---------------------------------------------------------------- collation


def _bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value; above the ladder the bucket extends to the
    next multiple of the top rung, so no sample is ever truncated."""
    for b in buckets:
        if value <= b:
            return b
    top = buckets[-1]
    return ((value + top - 1) // top) * top


def collate_av_batch(items: List[Dict[str, np.ndarray]],
                     frame_buckets: Sequence[int] = (8, 16, 32, 48, 64),
                     caption_buckets: Sequence[int] = (12, 16, 20, 26, 34),
                     pad_batch_to: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Batch padded to the smallest fitting buckets: audio [B, T, 128] and
    visual [B, T, 2048] float32, captions [L, B] int32 (time-first, PAD
    padded), feat_mask [B, T] and sample_mask [B] bool."""
    n = len(items)
    b = pad_batch_to or n
    t_pad = _bucket(max(it["audio"].shape[0] for it in items), frame_buckets)
    l_pad = _bucket(max(it["caption"].shape[0] for it in items), caption_buckets)
    audio = np.zeros((b, t_pad, items[0]["audio"].shape[1]), dtype=np.float32)
    visual = np.zeros((b, t_pad, items[0]["visual"].shape[1]), dtype=np.float32)
    captions = np.full((l_pad, b), PAD_ID, dtype=np.int32)
    feat_mask = np.zeros((b, t_pad), dtype=bool)
    sample_mask = np.zeros((b,), dtype=bool)
    for i, it in enumerate(items):
        t = min(it["audio"].shape[0], t_pad)
        l = min(it["caption"].shape[0], l_pad)
        audio[i, :t] = it["audio"][:t]
        visual[i, :t] = it["visual"][:t]
        captions[:l, i] = it["caption"][:l]
        feat_mask[i, :t] = True
        sample_mask[i] = True
    return {"audio": audio, "visual": visual, "captions": captions,
            "feat_mask": feat_mask, "sample_mask": sample_mask}


def collate_eval_batch(items: List[Dict[str, object]],
                       frame_buckets: Sequence[int] = (8, 16, 32, 48, 64),
                       pad_batch_to: Optional[int] = None) -> Dict[str, object]:
    """Eval batch: features, masks and each video's ground-truth captions."""
    n = len(items)
    b = pad_batch_to or n
    t_pad = _bucket(max(it["audio"].shape[0] for it in items), frame_buckets)
    audio = np.zeros((b, t_pad, items[0]["audio"].shape[1]), dtype=np.float32)
    visual = np.zeros((b, t_pad, items[0]["visual"].shape[1]), dtype=np.float32)
    feat_mask = np.zeros((b, t_pad), dtype=bool)
    sample_mask = np.zeros((b,), dtype=bool)
    for i, it in enumerate(items):
        t = min(it["audio"].shape[0], t_pad)
        audio[i, :t] = it["audio"][:t]
        visual[i, :t] = it["visual"][:t]
        feat_mask[i, :t] = True
        sample_mask[i] = True
    return {"video_ids": [it["video_id"] for it in items], "audio": audio, "visual": visual,
            "feat_mask": feat_mask, "sample_mask": sample_mask,
            "captions": [it["captions"] for it in items]}
