"""Dataset metadata readers (``mvc_tpu/data/metadata.py``), without pandas:
each returns the ``(video_id, caption)`` rows in file order."""

from __future__ import annotations

import csv
import json
import os
from typing import List, Tuple

Rows = List[Tuple[str, str]]


def _parse_msvd_filename(video_name: str) -> Tuple[str, int, int]:
    """``<VideoID>_<Start>_<End>[.ext]`` -> parts."""
    parts = video_name.split(".")[0].split("_")
    return "_".join(parts[:-2]), int(parts[-2]), int(parts[-1])


def read_msvd_metadata(root_dir: str, split: str, verbose: bool = True) -> Rows:
    """MSVD CSV metadata with the reference's integrity filter: drop the
    caption rows whose feature file is missing, then keep only rows with
    ``Source == "clean"``.  The clip id is ``f"{VideoID}_{Start}_{End}"``
    with Start and End read as ints."""
    captions_file = os.path.join(root_dir, "metadata", f"{split}.csv")
    if not os.path.isfile(captions_file):
        raise FileNotFoundError(f"The captions file cannot be found {captions_file}")
    feature_dir = os.path.join(root_dir, "features", "video")
    available = set()
    for f in os.listdir(feature_dir):
        vid, start, end = _parse_msvd_filename(f)
        if os.path.isfile(os.path.join(feature_dir, f)):
            available.add(f"{vid}_{start}_{end}")
    with open(captions_file, newline="") as f:
        records = list(csv.DictReader(f))
    if verbose:
        print("Before integrity check:", len(records))
    for r in records:
        r["video_id"] = f"{r['VideoID']}_{int(r['Start'])}_{int(r['End'])}"
    records = [r for r in records if r["video_id"] in available]
    if verbose:
        print("After integrity check:", len(records))
    records = [r for r in records if r["Source"] == "clean"]
    if verbose:
        print("After removing unverified:", len(records))
    return [(r["video_id"], r["Description"]) for r in records]


# MSR-VTT id-range splits.
MSR_VTT_SPLITS = {"train": (0, 6512), "val": (6513, 7009), "test": (7010, 9999)}


def read_msr_vtt_metadata(root_dir: str, split: str, verbose: bool = True) -> Rows:
    """MSR-VTT JSON metadata with the id-range splits."""
    name = "test_videodatainfo.json" if split == "test" else "train_val_videodatainfo.json"
    json_path = os.path.join(root_dir, "metadata", name)
    if not os.path.isfile(json_path):
        raise FileNotFoundError(f"The captions file cannot be found {json_path}")
    with open(json_path) as f:
        data = json.load(f)
    start, end = MSR_VTT_SPLITS[split]
    rows = [(s["video_id"], s["caption"]) for s in data["sentences"]
            if start <= int(s["video_id"].replace("video", "")) < end]
    if verbose:
        print(f"Total Data Count (MSR-VTT-{split}):", len(rows))
    return rows
