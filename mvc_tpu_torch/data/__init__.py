from mvc_tpu_torch.data.dataset import (
    VideoCaptioningDataset,
    VideoCaptionsDataset,
    video_dataset_to_video_captions_loader,
)
from mvc_tpu_torch.data.loader import DataLoader, get_loader
from mvc_tpu_torch.data.metadata import read_msr_vtt_metadata, read_msvd_metadata
from mvc_tpu_torch.data.vocabulary import Vocabulary, build_msr_vtt_vocab, build_msvd_vocab

__all__ = [
    "Vocabulary",
    "build_msvd_vocab",
    "build_msr_vtt_vocab",
    "read_msvd_metadata",
    "read_msr_vtt_metadata",
    "VideoCaptioningDataset",
    "VideoCaptionsDataset",
    "video_dataset_to_video_captions_loader",
    "get_loader",
    "DataLoader",
]
