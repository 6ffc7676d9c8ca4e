"""Continuous-batching caption service (``mvc_tpu/serving/service.py``).

- **Bounded shapes.** Every device call is ``[max_batch, t_pad, D]``: ``t_pad``
  comes from the frame-bucket ladder (``data.dataset._bucket``) and the batch
  axis is always padded to ``max_batch``.  Padded rows carry
  ``feat_mask=False`` and zero features, so a request's caption is the same
  whether it shared a batch or rode alone.
- **Model limits.** On the card the service asks the model, at
  construction, for the largest ``t_pad`` it takes (``model.max_frames``:
  the RNN captioners' kernel by its shared memory, the transformer's
  positional encoding); ``submit`` raises ValueError for a longer clip, so
  it fails alone instead of failing the batch it would have joined.  A
  beam wider than the model takes (``model.max_beam_width``: 8 for the
  RNN captioners' beam kernel) fails construction.  The CPU path has
  neither limit.
- **One worker, one card.** A background thread collects a batch (it waits
  ``max_wait_ms`` after the first queued request, or until ``max_batch``
  are in hand, filling in priority then arrival order), copies it to the
  device and launches the decode; the launch is asynchronous on the current
  CUDA stream.  A completer thread owns the sync (``.cpu()`` of the tokens),
  so batch k+1 is collected and launched while batch k runs, bounded by
  ``pipeline_depth``.
- **Overload.** With ``max_queue`` an arrival evicts a strictly lower
  priority request or is shed with ``ServiceOverloaded``; a request whose
  ``deadline_ms`` passes before it reaches a batch fails with
  ``DeadlineExceeded``.

- **Wire formats.** ``transfer`` picks the features' host-to-device format:
  ``"f32"``; ``"bf16"`` (cast on the host, round to nearest even; the
  decode casts its inputs to the model dtype on entry, as the JAX service
  relies on); ``"int8"`` (``data.feature_cache.quantize_int8`` on the host,
  dequantized to float32 on the device before ``predict_tokens``).

Not ported yet: the mesh argument.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mvc_tpu_torch.data.dataset import _bucket
from mvc_tpu_torch.data.feature_cache import dequantize_int8, quantize_int8
from mvc_tpu_torch.models.captioning import captions_from_tokens
from mvc_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Batching/decode knobs for :class:`CaptionService`."""

    max_batch: int = 64
    max_wait_ms: float = 5.0
    frame_buckets: Sequence[int] = (8, 16, 32, 48, 64)
    max_caption_len: int = 30
    mode: str = "direct"  # "direct" | "beam"
    beam_width: int = 5
    beam_alpha: float = 0.0
    audio_dim: int = 128
    visual_dim: int = 2048
    # direct mode on the RNN captioners' CPU path stops once every row has
    # emitted EOS (caption text identical); their CUDA kernels run a fixed
    # schedule; beam mode and the transformer ignore it
    stop_at_all_eos: bool = True
    latency_window: int = 2048  # latencies kept for the percentile stats
    # device batches in flight: 1 = launch, sync, repeat; 2 overlaps host
    # batching and the D2H copy with device compute
    pipeline_depth: int = 2
    # feature H2D wire format: "f32", "bf16" (half the bytes) or "int8"
    # (a quarter, per-frame max-abs scales, dequantized on the device)
    transfer: str = "f32"
    # None = unbounded queue; else shed or evict past this many queued
    max_queue: Optional[int] = None


_SHUTDOWN = object()   # completion-queue sentinel


class ServiceOverloaded(RuntimeError):
    """Raised to the shed party when the bounded queue is full (HTTP 503)."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline_ms elapsed before it reached a device batch
    (HTTP 504); it is dropped at collection time, not launched."""


class _Request:
    __slots__ = ("audio", "visual", "future", "t_submit", "priority", "seq", "deadline")

    def __init__(self, audio: np.ndarray, visual: np.ndarray, priority: int = 0,
                 seq: int = 0, deadline_ms: Optional[float] = None):
        self.audio = audio
        self.visual = visual
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.priority = int(priority)
        self.seq = seq
        self.deadline = self.t_submit + deadline_ms / 1e3 if deadline_ms is not None else None


def _tree_to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


class CaptionService:
    """Thread-safe online captioner over the model's ``predict_tokens``.

    ``model`` is any captioner with the JAX models' ``predict_tokens(params,
    audio, visual, ...)`` contract, ``max_frames``, ``max_beam_width`` and
    a ``device``: ``AVCaptioningDual`` (two decoders) or ``AVCaptioning``
    (one decoder over ``[audio | visual]``; ``params`` = ``{"decoder",
    "reconstructor"}``), their trees int8-quantized or not
    (``ops/quant.py``), or ``TransformerCaptioning``.  ``device`` is
    where the decode runs: the card by default (RuntimeError when there is
    none), the plain PyTorch path with ``device="cpu"``.  The model must
    have been built for the same device."""

    def __init__(self, model, params, vocab, config: Optional[ServiceConfig] = None,
                 device="cuda"):
        self.config = config or ServiceConfig()
        if self.config.mode not in ("direct", "beam"):
            raise ValueError(f"unknown mode {self.config.mode!r}")
        if self.config.transfer not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown transfer {self.config.transfer!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, service on {self.device}")
        self.model = model
        self.params = _tree_to(params, self.device)
        self.vocab = vocab
        # the card's kernels bound the beam width and the clip length; an
        # over-limit clip fails alone at submit (the CPU path has no limit)
        if self.config.mode == "beam":
            w_max = self._kernel_width_limit()
            if w_max is not None and self.config.beam_width > w_max:
                raise ValueError(f"beam_width={self.config.beam_width}: this model's beam on "
                                 f"the card takes at most {w_max}")
        self.max_frames = self._kernel_frame_limit()
        # the all-EOS stop goes only to a predict_tokens that takes it (the
        # transformer's does not), as the JAX service detects it
        takes_stop = "stop_at_all_eos" in inspect.signature(model.predict_tokens).parameters
        self._predict_extra = ({"stop_at_all_eos": True} if self.config.mode == "direct"
                               and self.config.stop_at_all_eos and takes_stop else {})

        # priority queue: a plain list + condition (the bound keeps it small);
        # best = min (priority, seq), victim = max
        self._pending: List[_Request] = []
        self._qcond = threading.Condition()
        self._seq = 0
        self._shutdown = False
        self._n_shed = 0
        self._n_expired = 0
        self._t_pads = set()
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=self.config.latency_window)
        self._n_requests = 0
        self._n_batches = 0
        self._n_rows = 0  # real (non-padding) rows launched
        self._t_start = time.perf_counter()
        self._closed = False
        # bounded in-flight queue = backpressure on the batching worker
        self._completions: "queue.Queue" = queue.Queue(maxsize=max(1, self.config.pipeline_depth))
        self._worker = threading.Thread(target=self._run, name="caption-service-worker",
                                        daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="caption-service-completer", daemon=True)
        self._worker.start()
        self._completer.start()

    # ------------------------------------------------------------- client API

    def submit(self, visual: np.ndarray, audio: Optional[np.ndarray] = None,
               priority: int = 0, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one clip's features; resolves to the caption string.

        ``visual`` is ``[T, visual_dim]``; ``audio`` is ``[T, audio_dim]`` or
        None for video-only traffic (zero-filled).  ``priority``: smaller =
        more urgent.  ``deadline_ms``: fail with DeadlineExceeded if the
        request has not reached a device batch within this budget."""
        if self._closed:
            raise RuntimeError("service is closed")
        visual = np.asarray(visual, dtype=np.float32)
        if visual.ndim != 2 or visual.shape[1] != self.config.visual_dim:
            raise ValueError(f"visual must be [T, {self.config.visual_dim}], got {visual.shape}")
        t = visual.shape[0]
        if t < 1:
            raise ValueError("empty clip: T must be >= 1")
        t_pad = _bucket(t, self.config.frame_buckets)
        if self.max_frames is not None and t_pad > self.max_frames:
            raise ValueError(f"a clip of T={t} frames pads to {t_pad}, above the "
                             f"{self.max_frames} frames this model takes on the card")
        if audio is None:
            audio = np.zeros((t, self.config.audio_dim), dtype=np.float32)
        else:
            audio = np.asarray(audio, dtype=np.float32)
            if audio.shape != (t, self.config.audio_dim):
                raise ValueError(
                    f"audio must be [T={t}, {self.config.audio_dim}], got {audio.shape}")
        victim = None
        with self._qcond:
            self._seq += 1
            req = _Request(audio, visual, priority=priority, seq=self._seq,
                           deadline_ms=deadline_ms)
            bound = self.config.max_queue
            if bound is not None and len(self._pending) >= bound:
                # victim = lowest priority class (largest number), youngest
                # within it — LIFO shedding keeps FIFO fairness for the rest
                worst = (max(self._pending, key=lambda r: (r.priority, r.seq))
                         if self._pending else None)
                if worst is not None and worst.priority > req.priority:
                    self._pending.remove(worst)
                    victim = worst
                else:
                    with self._lock:
                        self._n_shed += 1
                    raise ServiceOverloaded(
                        f"queue full ({bound}) and no lower-priority victim "
                        f"(incoming priority {req.priority})")
            self._pending.append(req)
            self._qcond.notify()
        if victim is not None:
            with self._lock:
                self._n_shed += 1
            victim.future.set_exception(ServiceOverloaded(
                f"evicted by a priority-{req.priority} arrival (own priority {victim.priority})"))
        return req.future

    def _kernel_width_limit(self) -> Optional[int]:
        """The widest beam the model takes on the card; None on the CPU."""
        return self.model.max_beam_width() if self.device.type == "cuda" else None

    def _kernel_frame_limit(self) -> Optional[int]:
        """The largest padded clip the model takes on the card for this mode
        and batch (the RNN captioners' kernels: from their own
        shared-memory need); None on the CPU."""
        if self.device.type != "cuda":
            return None
        cfg = self.config
        return self.model.max_frames(self.params, cfg.max_batch, cfg.mode, cfg.beam_width)

    def caption(self, visual: np.ndarray, audio: Optional[np.ndarray] = None,
                timeout: Optional[float] = None) -> str:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(visual, audio).result(timeout=timeout)

    def warmup(self, t_lengths: Optional[Sequence[int]] = None) -> List[int]:
        """Run one dummy batch per distinct frame bucket implied by
        ``t_lengths`` (default: every rung of the ladder) ahead of traffic,
        so the kernel build and first-launch costs are paid up front.
        Returns the warmed ``t_pad`` values."""
        lengths = list(t_lengths) if t_lengths is not None else list(self.config.frame_buckets)
        warmed = []
        for t_pad in sorted({_bucket(t, self.config.frame_buckets) for t in lengths}):
            self.submit(np.zeros((t_pad, self.config.visual_dim), dtype=np.float32)).result()
            warmed.append(t_pad)
        return warmed

    def reset_stats(self) -> None:
        """Zero the counters/latency window (e.g. right after warmup)."""
        with self._lock:
            self._latencies.clear()
            self._n_requests = self._n_batches = self._n_rows = 0
            self._t_start = time.perf_counter()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            lat = sorted(self._latencies)
            n_requests, n_batches, n_rows = self._n_requests, self._n_batches, self._n_rows
            t_start = self._t_start
            t_pads = sorted(self._t_pads)

        def pct(p: float) -> Optional[float]:
            if not lat:
                return None
            return 1e3 * lat[min(len(lat) - 1, int(p * len(lat)))]

        elapsed = time.perf_counter() - t_start
        return {
            "requests": n_requests,
            "batches": n_batches,
            "mean_batch_occupancy": (n_rows / n_batches) if n_batches else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
            "requests_per_s": n_requests / elapsed if elapsed > 0 else None,
            # padded frame counts launched so far (the JAX service's key name)
            "compiled_t_pads": t_pads,
            "queue_depth": len(self._pending),
            "shed": self._n_shed,
            "deadline_expired": self._n_expired,
            "mode": self.config.mode,
            "max_batch": self.config.max_batch,
            "transfer": self.config.transfer,
            "device": str(self.device),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._qcond:
            self._shutdown = True
            self._qcond.notify_all()
        self._worker.join()
        self._completions.put(_SHUTDOWN)
        self._completer.join()

    def __enter__(self) -> "CaptionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- worker

    def _pop_best_locked(self) -> Optional[_Request]:
        """Highest-priority (then oldest) live request; expired ones fail
        with DeadlineExceeded and are skipped.  Caller holds _qcond."""
        now = time.perf_counter()
        while self._pending:
            best = min(self._pending, key=lambda r: (r.priority, r.seq))
            self._pending.remove(best)
            if best.deadline is not None and now > best.deadline:
                with self._lock:
                    self._n_expired += 1
                best.future.set_exception(DeadlineExceeded(
                    f"deadline elapsed after {1e3 * (now - best.t_submit):.1f} ms in queue"))
                continue
            return best
        return None

    def _collect(self) -> Optional[List[_Request]]:
        """Block for the first request, then window for more."""
        with self._qcond:
            while True:
                first = self._pop_best_locked()
                if first is not None:
                    break
                if self._shutdown:
                    return None
                self._qcond.wait()
        batch = [first]
        deadline = time.perf_counter() + self.config.max_wait_ms / 1e3
        while len(batch) < self.config.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            with self._qcond:
                nxt = self._pop_best_locked()
                if nxt is None:
                    if self._shutdown:
                        break
                    self._qcond.wait(timeout=remaining)
                    nxt = self._pop_best_locked()
            if nxt is None:
                continue
            batch.append(nxt)
        return batch

    def _launch(self, batch: List[_Request]) -> None:
        """Pad, copy to the device, launch (asynchronously on CUDA) and
        enqueue for completion."""
        cfg = self.config
        t_pad = _bucket(max(r.visual.shape[0] for r in batch), cfg.frame_buckets)
        audio = np.zeros((cfg.max_batch, t_pad, cfg.audio_dim), dtype=np.float32)
        visual = np.zeros((cfg.max_batch, t_pad, cfg.visual_dim), dtype=np.float32)
        feat_mask = np.zeros((cfg.max_batch, t_pad), dtype=bool)
        for i, r in enumerate(batch):
            t = r.visual.shape[0]
            audio[i, :t] = r.audio
            visual[i, :t] = r.visual
            feat_mask[i, :t] = True
        with self._lock:
            self._t_pads.add(t_pad)
        audio_d, visual_d = (self._to_device(x) for x in (audio, visual))
        dev = self.device
        tokens = self.model.predict_tokens(
            self.params, audio_d, visual_d,
            max_caption_len=cfg.max_caption_len, mode=cfg.mode,
            beam_alpha=cfg.beam_alpha, beam_width=cfg.beam_width,
            feat_mask=torch.from_numpy(feat_mask).to(dev), **self._predict_extra)
        self._completions.put((tokens, batch))

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """One padded feature batch through the configured wire format."""
        dev = self.device
        if self.config.transfer == "int8":
            q, scale = quantize_int8(x)
            return dequantize_int8(torch.from_numpy(q).to(dev), torch.from_numpy(scale).to(dev))
        t = torch.from_numpy(x)
        if self.config.transfer == "bf16":
            t = t.to(torch.bfloat16)
        return t.to(dev)

    def _complete(self, tokens_dev: torch.Tensor, batch: List[_Request]) -> None:
        n = len(batch)
        tokens = tokens_dev.cpu()          # the sync point for this batch
        captions = captions_from_tokens(self.vocab, tokens[:n])
        now = time.perf_counter()
        with self._lock:
            for r in batch:
                self._latencies.append(now - r.t_submit)
            self._n_requests += n
            self._n_batches += 1
            self._n_rows += n
        for r, cap in zip(batch, captions):
            r.future.set_result(cap)

    @staticmethod
    def _fail(batch: List[_Request], e: BaseException) -> None:
        for r in batch:
            if not r.future.done():
                r.future.set_exception(e)

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                self._launch(batch)
            except Exception as e:  # resolve the batch's futures; keep serving
                self._fail(batch, e)

    def _complete_loop(self) -> None:
        while True:
            item = self._completions.get()
            if item is _SHUTDOWN:
                return
            tokens_dev, batch = item
            try:
                self._complete(tokens_dev, batch)
            except Exception as e:
                self._fail(batch, e)
