"""Host-side batch loaders (``mvc_tpu/data/loader.py``): numpy-seeded epoch
order, bucketed collation (or, with a device feature cache attached,
caption ids and cache rows only) and a prefetch thread that overlaps
feature loading with the step on the card.  ``process_index`` /
``process_count`` give each data-parallel rank a disjoint strided slice
of the dataset."""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mvc_tpu_torch.data.dataset import (
    VideoCaptioningDataset,
    VideoCaptionsDataset,
    collate_av_batch,
    collate_eval_batch,
)
from mvc_tpu_torch.data.feature_cache import collate_index_batch


class _Prefetcher:
    """Run an iterator on a daemon thread with a bounded queue."""

    _SENTINEL = object()

    def __init__(self, make_iter, depth: int = 2):
        self._make_iter = make_iter
        self._depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        err: List[BaseException] = []

        def worker():
            try:
                for item in self._make_iter():
                    q.put(item)
            except BaseException as e:  # re-raised in the consumer
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                if err:
                    raise err[0]
                return
            yield item


class DataLoader:
    """Shuffling, bucketing train loader over (video, caption) pairs.  The
    epoch order is ``np.random.default_rng(seed)``'s shuffle, as in the JAX
    loader; ``bucket_by_length`` sorts each window of 16 batches by frame
    count (stable).  Rank ``process_index`` of ``process_count`` reads the
    rows ``process_index::process_count`` and shuffles them."""

    def __init__(self, dataset: VideoCaptioningDataset, batch_size: int = 32,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 frame_buckets: Sequence[int] = (8, 16, 32, 48, 64),
                 caption_buckets: Sequence[int] = (12, 16, 20, 26, 34),
                 pad_partial_batches: bool = True, prefetch: int = 2,
                 bucket_by_length: bool = False, process_index: int = 0,
                 process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.frame_buckets = tuple(frame_buckets)
        self.caption_buckets = tuple(caption_buckets)
        self.pad_partial_batches = pad_partial_batches
        self.prefetch = prefetch
        self.bucket_by_length = bucket_by_length
        self.process_index = process_index
        self.process_count = process_count
        self._rng = np.random.default_rng(seed)
        self._lengths = None
        self.feature_cache = None

    def attach_feature_cache(self, cache) -> None:
        """Switch to the index path: batches carry caption ids and cache
        rows only; the features stay on the device
        (``data.feature_cache.DeviceFeatureCache``)."""
        self.feature_cache = cache

    def _my_indices(self) -> np.ndarray:
        """This process's disjoint strided slice of the dataset."""
        return np.arange(self.process_index, len(self.dataset), self.process_count)

    def __len__(self) -> int:
        n = len(self._my_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _frame_lengths(self) -> np.ndarray:
        """Per-row frame counts, read once from the .npy headers."""
        if self._lengths is None:
            per_video: Dict[str, int] = {}
            for vid, _ in self.dataset.metadata:
                if vid not in per_video:
                    path = os.path.join(self.dataset.root_dir, "features", "video", f"{vid}.npy")
                    try:
                        per_video[vid] = int(np.load(path, mmap_mode="r").shape[0])
                    except (OSError, ValueError):
                        per_video[vid] = 0
            self._lengths = np.asarray([per_video[vid] for vid, _ in self.dataset.metadata])
        return self._lengths

    def _epoch_order(self) -> np.ndarray:
        order = self._my_indices()
        if self.shuffle:
            self._rng.shuffle(order)
        if self.bucket_by_length:
            window = self.batch_size * 16
            lengths = self._frame_lengths()
            chunks = [order[s:s + window][np.argsort(lengths[order[s:s + window]], kind="stable")]
                      for s in range(0, len(order), window)]
            order = np.concatenate(chunks) if chunks else order
        return order

    def _iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._epoch_order()
        bs = self.batch_size
        ends = len(order) if not self.drop_last else (len(order) // bs) * bs
        cache = self.feature_cache
        for start in range(0, ends, bs):
            idx = order[start:start + bs]
            pad_to = bs if self.pad_partial_batches else None
            if cache is not None:
                yield collate_index_batch(cache.caption_rows[idx],
                                          [cache.caption_ids[int(i)] for i in idx],
                                          cache.lengths_np, caption_buckets=self.caption_buckets,
                                          frame_buckets=self.frame_buckets, pad_batch_to=pad_to,
                                          t_store=cache.t_store)
                continue
            items = [self.dataset[int(i)] for i in idx]
            yield collate_av_batch(items, frame_buckets=self.frame_buckets,
                                   caption_buckets=self.caption_buckets, pad_batch_to=pad_to)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch > 0:
            return iter(_Prefetcher(self._iter_batches, depth=self.prefetch))
        return self._iter_batches()


class EvalDataLoader:
    """Unshuffled per-video eval loader; rank ``process_index`` of
    ``process_count`` reads the videos ``process_index::process_count``
    (each rank decodes its own videos in the trainer's eval)."""

    def __init__(self, dataset: VideoCaptionsDataset, batch_size: int = 32,
                 frame_buckets: Sequence[int] = (8, 16, 32, 48, 64),
                 pad_partial_batches: bool = True, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.frame_buckets = tuple(frame_buckets)
        self.pad_partial_batches = pad_partial_batches
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count

    def _my_indices(self) -> np.ndarray:
        return np.arange(self.process_index, len(self.dataset), self.process_count)

    def __len__(self) -> int:
        return (len(self._my_indices()) + self.batch_size - 1) // self.batch_size

    def _iter_batches(self):
        bs = self.batch_size
        mine = self._my_indices()
        for start in range(0, len(mine), bs):
            items = [self.dataset[int(i)] for i in mine[start:start + bs]]
            yield collate_eval_batch(items, frame_buckets=self.frame_buckets,
                                     pad_batch_to=bs if self.pad_partial_batches else None)

    def __iter__(self):
        if self.prefetch > 0:
            return iter(_Prefetcher(self._iter_batches, depth=self.prefetch))
        return self._iter_batches()


def get_loader(root_dir: str, dataset: str = "MSVD", split: str = "train", batch_size: int = 32,
               shuffle: bool = True, vocab_path: Optional[str] = None, normalize: bool = False,
               video_only: bool = False, frame_buckets: Sequence[int] = (8, 16, 32, 48, 64),
               caption_buckets: Sequence[int] = (12, 16, 20, 26, 34), seed: int = 0,
               verbose: bool = True, bucket_by_length: bool = False, process_index: int = 0,
               process_count: int = 1):
    """The data entry point.  Returns ``(loader, dataset)``; the loader reads
    rank ``process_index``'s strided slice of ``process_count``."""
    if verbose:
        print("-" * 50)
        print("Initializing loader:")
        print("Dataset:", dataset)
        print("Split:", split)
        print("Video_only ?:", video_only)
        print("-" * 50)
    ds = VideoCaptioningDataset(root_dir, dataset=dataset, split=split, vocab_path=vocab_path,
                                normalize=normalize, video_only=video_only, verbose=verbose)
    loader = DataLoader(ds, batch_size=batch_size, shuffle=shuffle, seed=seed,
                        frame_buckets=frame_buckets, caption_buckets=caption_buckets,
                        bucket_by_length=bucket_by_length, process_index=process_index,
                        process_count=process_count)
    return loader, ds
