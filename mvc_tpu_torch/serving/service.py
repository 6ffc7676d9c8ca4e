"""Continuous-batching caption service (``mvc_tpu/serving/service.py``).

- **Bounded shapes.** Every device call is ``[max_batch, t_pad, D]``: ``t_pad``
  comes from the frame-bucket ladder (``data.dataset._bucket``) and the batch
  axis is always padded to ``max_batch``.  Padded rows carry
  ``feat_mask=False`` and zero features, so a request's caption is the same
  whether it shared a batch or rode alone.  The padding is made on the
  device: the host stages only the clips' own frames and their flat
  positions in the padded batch, in one buffer of a ring of
  ``pipeline_depth + 1`` (page-locked on the card), sends it in one
  asynchronous copy, and the device scatters the frames into zeroed
  batches and sets ``feat_mask`` at the same positions.  A slot is
  refilled only after the event recorded behind its last copy has passed.
- **Model limits.** On the card the service asks the model, at
  construction, for the largest ``t_pad`` it takes (``model.max_frames``:
  None for the RNN captioners, whose kernels take any clip length; the
  transformer's positional encoding); ``submit`` raises ValueError for a
  longer clip, so it fails alone instead of failing the batch it would
  have joined.  A beam wider than the model takes
  (``model.max_beam_width``: 16 for the RNN captioners' beam kernel)
  fails construction.  The CPU path has neither limit.
- **One worker, one card.** A background thread collects a batch (it waits
  ``max_wait_ms`` after the first queued request, or until ``max_batch``
  are in hand, filling in priority then arrival order), copies it to the
  device and launches the decode; the launch is asynchronous on the current
  CUDA stream.  A completer thread owns the sync (``.cpu()`` of the tokens),
  so batch k+1 is collected and launched while batch k runs, bounded by
  ``pipeline_depth``.
- **Spans and counters.** While ``utils.tracing`` records, the worker
  records ``service.collect`` and ``service.launch`` (children
  ``service.pad``, ``service.h2d``, the model's ``model.predict_tokens``
  and ``service.backpressure``, the wait for room in the completion
  queue), the completer ``service.complete`` (child ``service.sync``, the
  wait for the device), each span with its batch id, and each request
  its ``service.queue`` wait with its request and batch ids.  ``service.pad``
  packs the real frames into the staging slot; ``service.h2d`` enqueues
  the copy and the device pad.  ``stats()`` always counts the queue waits
  (``queue_wait_ms_p50``/``_p95``), the frames launched and the real ones
  among them, the bytes sent (``h2d_bytes``) and the launches that waited
  for a staging slot (``staging_waits``).
- **Overload.** With ``max_queue`` an arrival evicts a strictly lower
  priority request or is shed with ``ServiceOverloaded``; a request whose
  ``deadline_ms`` passes before it reaches a batch fails with
  ``DeadlineExceeded``.

- **Wire formats.** ``transfer`` picks the features' host-to-device format:
  ``"f32"``; ``"bf16"`` (cast on the host, round to nearest even; the
  decode casts its inputs to the model dtype on entry, as the JAX service
  relies on); ``"int8"`` (``data.feature_cache.quantize_int8`` on the host,
  dequantized to float32 on the device before ``predict_tokens``).  Only
  the real frames are cast or quantized; the cast is elementwise and the
  int8 scales are per frame, and a padding frame is zero in every format,
  so the device batch equals that of casting the padded batch.
- **Mesh.** With ``mesh`` (``parallel/mesh.py``) every batch is split over
  the mesh's devices and each shard decodes through the model's kernel on
  its own device and stream (``ops/sharded.py``; the parameters are copied
  to each device once); ``max_batch`` must divide the ``dp`` axis, and the
  kernel limits are asked at the shard's batch.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mvc_tpu_torch.data.dataset import _bucket
from mvc_tpu_torch.data.feature_cache import dequantize_int8, quantize_int8
from mvc_tpu_torch.models.captioning import captions_from_tokens
from mvc_tpu_torch.ops import sharded
from mvc_tpu_torch.utils import tracing
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
    __slots__ = ("audio", "visual", "future", "t_submit", "t_submit_ns", "t_pop", "priority",
                 "seq", "deadline")

    def __init__(self, audio: np.ndarray, visual: np.ndarray, priority: int = 0,
                 seq: int = 0, deadline_ms: Optional[float] = None):
        self.audio = audio
        self.visual = visual
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # the queue span's start (the recorder's clock), while spans are recorded
        self.t_submit_ns = tracing.now() if tracing.enabled() else 0
        self.t_pop = self.t_submit
        self.priority = int(priority)
        self.seq = seq
        self.deadline = self.t_submit + deadline_ms / 1e3 if deadline_ms is not None else None


_WIRE = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
# the host's view of each staged dtype (numpy has no bfloat16: its bits)
_HOST = {torch.int64: np.int64, torch.float32: np.float32, torch.bfloat16: np.int16,
         torch.int8: np.int8}


def _nbytes(sections) -> int:
    return sum(math.prod(shape) * dtype.itemsize for _, dtype, shape in sections)


def _views(buf, sections) -> Dict[str, object]:
    """Typed views of a byte buffer laid out as ``sections`` (name, dtype,
    shape), back to back: numpy arrays of a numpy buffer, tensors of a
    tensor."""
    host = isinstance(buf, np.ndarray)
    out, off = {}, 0
    for name, dtype, shape in sections:
        n = math.prod(shape) * dtype.itemsize
        out[name] = (buf[off:off + n].view(_HOST[dtype]).reshape(shape) if host
                     else buf[off:off + n].view(dtype).view(shape))
        off += n
    return out


class _StagingRing:
    """Host byte buffers the worker packs batches into, one after another.

    On the card each is page-locked and its copy to the device is
    asynchronous; an event recorded after that copy guards the slot, so
    ``take`` hands a slot out again only once the copy that read it has
    finished.  On the CPU they are plain tensors and the "copy" is the
    slot itself, which the device pad reads before the next take."""

    def __init__(self, slots: int, nbytes: int, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.bufs = [self._alloc(nbytes) for _ in range(slots)]
        self.arrays = [b.numpy() for b in self.bufs]     # the same bytes, for the packing
        self.events = [torch.cuda.Event() if self.cuda else None for _ in range(slots)]
        self.turn = 0

    def _alloc(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=self.cuda)

    def take(self, nbytes: int) -> Tuple[int, bool]:
        """The next slot, at least ``nbytes`` long (grown geometrically),
        and whether the host had to wait for its previous copy."""
        i = self.turn
        self.turn = (i + 1) % len(self.bufs)
        event = self.events[i]
        waited = event is not None and not event.query()
        if waited:
            event.synchronize()
        if self.bufs[i].numel() < nbytes:
            self.bufs[i] = self._alloc(max(nbytes, 2 * self.bufs[i].numel()))
            self.arrays[i] = self.bufs[i].numpy()
        return i, waited

    def send(self, i: int, nbytes: int) -> torch.Tensor:
        """Slot ``i``'s first ``nbytes`` on the device: one asynchronous
        copy on the current stream, then the slot's event."""
        host = self.bufs[i][:nbytes]
        if not self.cuda:
            return host
        dev = host.to(self.device, non_blocking=True)
        self.events[i].record(torch.cuda.current_stream(self.device))
        return dev


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
    have been built for the same device.  ``mesh`` scales one replica over
    the mesh's devices (the first of which is ``device``)."""

    def __init__(self, model, params, vocab, config: Optional[ServiceConfig] = None,
                 device="cuda", mesh=None):
        self.config = config or ServiceConfig()
        if self.config.mode not in ("direct", "beam"):
            raise ValueError(f"unknown mode {self.config.mode!r}")
        if self.config.transfer not in ("f32", "bf16", "int8"):
            raise ValueError(f"unknown transfer {self.config.transfer!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, service on {self.device}")
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape.get("dp", 1)
            if self.config.max_batch % dp:
                raise ValueError(f"max_batch={self.config.max_batch} must divide the mesh dp "
                                 f"axis ({dp})")
            if mesh.local().devices[0] != self.device:
                raise ValueError(f"the mesh's first device {mesh.local().devices[0]} is not "
                                 f"the service's {self.device}")
        self.model = model
        self.params = _tree_to(params, self.device)
        self.vocab = vocab
        # the card's models may bound the beam width and the clip length;
        # an over-limit clip fails alone at submit (the CPU path has no limit)
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
        if mesh is not None:
            self._predict_extra["mesh"] = mesh

        # priority queue: a plain list + condition; best = min (priority, seq),
        # victim = max.  Each pop scans the list, so it costs the queue's
        # length: with max_queue=None (cli.serve_captions) a backlog past the
        # service's knee slows every pop, batches shrink and it collapses
        # (PERF.md, Open questions)
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
        self._queue_waits = collections.deque(maxlen=self.config.latency_window)
        self._frames_launched = 0  # max_batch * t_pad of each batch launched
        self._frames_real = 0      # the clips' own frames among them
        self._h2d_bytes = 0        # staged bytes sent to the device (features, index)
        self._staging_waits = 0    # launches that waited on their slot's previous copy
        # pipeline_depth + 1 slots, so a slot's last copy has mostly finished
        # when its turn comes again; each sized for a full batch at the
        # ladder's top rung, so only a clip above the ladder grows one
        self._staging = _StagingRing(
            max(1, self.config.pipeline_depth) + 1,
            _nbytes(self._sections(self.config.max_batch * max(self.config.frame_buckets))),
            self.device)
        self._batch_id = 0         # the worker's batch counter (span ids)
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
        and batch (None: any); None on the CPU."""
        if self.device.type != "cuda":
            return None
        cfg = self.config
        return self.model.max_frames(self.params, cfg.max_batch // self._shards(),
                                     cfg.mode, cfg.beam_width)

    def _shards(self) -> int:
        """How many shards a ``max_batch`` batch splits into over the mesh."""
        if self.mesh is None:
            return 1
        local = self.mesh.local()
        return sharded.axes_size(local, sharded.batch_axes(local, self.config.max_batch)
                                 or tuple(local.axis_names))

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
            self._queue_waits.clear()
            self._n_requests = self._n_batches = self._n_rows = 0
            self._frames_launched = self._frames_real = 0
            self._h2d_bytes = self._staging_waits = 0
            self._t_start = time.perf_counter()

    def stats(self) -> Dict[str, object]:
        with self._lock:
            lat = sorted(self._latencies)
            waits = sorted(self._queue_waits)
            n_requests, n_batches, n_rows = self._n_requests, self._n_batches, self._n_rows
            frames_launched, frames_real = self._frames_launched, self._frames_real
            h2d_bytes, staging_waits = self._h2d_bytes, self._staging_waits
            t_start = self._t_start
            t_pads = sorted(self._t_pads)
        with self._qcond:
            queue_depth = len(self._pending)

        def pct(p: float, xs=lat) -> Optional[float]:
            if not xs:
                return None
            return 1e3 * xs[min(len(xs) - 1, int(p * len(xs)))]

        elapsed = time.perf_counter() - t_start
        return {
            "requests": n_requests,
            "batches": n_batches,
            "mean_batch_occupancy": (n_rows / n_batches) if n_batches else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
            # submit to the batch that took the request, over the same window
            "queue_wait_ms_p50": pct(0.50, waits),
            "queue_wait_ms_p95": pct(0.95, waits),
            "requests_per_s": n_requests / elapsed if elapsed > 0 else None,
            # padded frame counts launched so far (the JAX service's key name)
            "compiled_t_pads": t_pads,
            # frames launched (max_batch rows of t_pad each batch) and the
            # clips' own frames among them; the rest is padding
            "frames_launched": frames_launched,
            "frames_real": frames_real,
            # bytes staged and sent to the device (the real frames in the
            # wire format, int8 scales, their positions) and the launches
            # that waited for a staging slot's previous copy
            "h2d_bytes": h2d_bytes,
            "staging_waits": staging_waits,
            "queue_depth": queue_depth,
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

    def _pop_best_locked(self, batch_id: int) -> Optional[_Request]:
        """Highest-priority (then oldest) live request, stamped as taken by
        batch ``batch_id``; expired ones fail with DeadlineExceeded and are
        skipped.  Caller holds _qcond."""
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
            best.t_pop = now
            if best.t_submit_ns and tracing.enabled():
                tracing.record("service.queue", best.t_submit_ns, tracing.now(),
                               batch=batch_id, request=best.seq)
            return best
        return None

    def _collect(self, batch_id: int) -> Optional[List[_Request]]:
        """Block for the first request, then window for more."""
        with self._qcond:
            while True:
                first = self._pop_best_locked(batch_id)
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
                nxt = self._pop_best_locked(batch_id)
                if nxt is None:
                    if self._shutdown:
                        break
                    self._qcond.wait(timeout=remaining)
                    nxt = self._pop_best_locked(batch_id)
            if nxt is None:
                continue
            batch.append(nxt)
        return batch

    def _launch(self, batch: List[_Request], batch_id: int) -> None:
        """Stage the batch's real frames, send them, pad them on the device,
        launch (asynchronously on CUDA) and enqueue for completion.

        ``service.pad`` packs each request's own frames, in the wire
        format, into the next slot of the staging ring, after the flat
        positions they take in the padded ``[max_batch * t_pad]`` frame
        axis; nothing is zero-filled on the host.  A slot is refilled only
        once the copy that last read it has finished (the wait is counted
        in ``staging_waits``).  ``service.h2d`` enqueues one copy of the
        slot and builds, on the device, zeroed ``[max_batch, t_pad, D]``
        audio and visual batches with the frames put at their positions,
        and ``feat_mask`` true at the same positions: the tensors the
        host-padded layout gave, element for element."""
        cfg = self.config
        lengths = [r.visual.shape[0] for r in batch]
        with tracing.span("service.pad", batch=batch_id):
            t_pad = _bucket(max(lengths), cfg.frame_buckets)
            sections = self._sections(sum(lengths))
            nbytes = _nbytes(sections)
            slot, waited = self._staging.take(nbytes)
            host = _views(self._staging.arrays[slot], sections)
            # frame k of row i sits at i * t_pad + k of the padded frame axis
            n = np.asarray(lengths)
            np.add(np.arange(n.sum()), np.repeat(np.arange(len(n)) * t_pad - np.cumsum(n) + n, n),
                   out=host["index"])
            self._pack(host, "audio", [r.audio for r in batch])
            self._pack(host, "visual", [r.visual for r in batch])
        with self._lock:
            self._t_pads.add(t_pad)
            self._queue_waits.extend(r.t_pop - r.t_submit for r in batch)
            self._frames_launched += cfg.max_batch * t_pad
            self._frames_real += sum(lengths)
            self._h2d_bytes += nbytes
            self._staging_waits += waited
        dev = self.device
        with tracing.span("service.h2d", batch=batch_id):
            packed = _views(self._staging.send(slot, nbytes), sections)
            pos, rows = packed["index"], cfg.max_batch * t_pad
            padded = []
            for name, dim in (("audio", cfg.audio_dim), ("visual", cfg.visual_dim)):
                x = packed[name]
                if cfg.transfer == "int8":
                    x = dequantize_int8(x, packed[name + "_scale"])
                padded.append(torch.zeros((rows, dim), dtype=x.dtype, device=dev)
                              .index_copy_(0, pos, x).view(cfg.max_batch, t_pad, dim))
            mask_d = (torch.zeros(rows, dtype=torch.bool, device=dev).index_fill_(0, pos, True)
                      .view(cfg.max_batch, t_pad))
        audio_d, visual_d = padded
        tokens = self.model.predict_tokens(
            self.params, audio_d, visual_d,
            max_caption_len=cfg.max_caption_len, mode=cfg.mode,
            beam_alpha=cfg.beam_alpha, beam_width=cfg.beam_width,
            feat_mask=mask_d, **self._predict_extra)
        with tracing.span("service.backpressure", batch=batch_id):
            self._completions.put((tokens, batch, batch_id))

    def _sections(self, n: int) -> List[Tuple[str, torch.dtype, Tuple[int, ...]]]:
        """The staging layout of ``n`` frames: their flat positions in the
        padded batch, int8 scales, then visual and audio frames in the wire
        format; each section's offset is a multiple of its item size."""
        cfg = self.config
        wire = _WIRE[cfg.transfer]
        scales = ([("visual_scale", torch.float32, (n, 1)), ("audio_scale", torch.float32, (n, 1))]
                  if cfg.transfer == "int8" else [])
        return ([("index", torch.int64, (n,))] + scales
                + [("visual", wire, (n, cfg.visual_dim)), ("audio", wire, (n, cfg.audio_dim))])

    def _pack(self, host: Dict[str, np.ndarray], name: str, frames: List[np.ndarray]) -> None:
        """One stream's frames, in request order, into its staging section
        through the configured wire format."""
        dst = host[name]
        if self.config.transfer == "f32":
            np.concatenate(frames, out=dst)
            return
        x = np.concatenate(frames)
        if self.config.transfer == "bf16":
            # round to nearest even, as .to(bfloat16)
            torch.from_numpy(dst).view(torch.bfloat16).copy_(torch.from_numpy(x))
        else:
            q, scale = quantize_int8(x)
            dst[:] = q
            host[name + "_scale"][:] = scale

    def _complete(self, tokens_dev: torch.Tensor, batch: List[_Request], batch_id: int) -> None:
        n = len(batch)
        with tracing.span("service.sync", batch=batch_id):
            tokens = tokens_dev.cpu()      # the sync point for this batch
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
            self._batch_id += 1
            batch_id = self._batch_id
            with tracing.span("service.collect", batch=batch_id):
                batch = self._collect(batch_id)
            if batch is None:
                return
            try:
                with tracing.span("service.launch", batch=batch_id):
                    self._launch(batch, batch_id)
            except Exception as e:  # resolve the batch's futures; keep serving
                self._fail(batch, e)

    def _complete_loop(self) -> None:
        while True:
            item = self._completions.get()
            if item is _SHUTDOWN:
                return
            tokens_dev, batch, batch_id = item
            try:
                with tracing.span("service.complete", batch=batch_id):
                    self._complete(tokens_dev, batch, batch_id)
            except Exception as e:
                self._fail(batch, e)
