"""The decode kernels over a device mesh (``mvc_tpu/ops/sharded.py``).

The kernels (``ops/dual_greedy.py``, ``ops/greedy.py``, ``ops/beam.py``)
decode a whole batch in one launch.  Decode is batch-parallel (rows are
independent in all three, and a beam cluster owns whole clips), so over a
mesh the batch is split in order and the kernel launches once per shard,
with no collective in the loop, as ``shard_map`` does in the JAX package:

- the batch is split over ``batch_axes(mesh, B)``: every axis when ``B``
  divides the mesh (``tp`` is extra batch parallelism at predict time),
  else ``dp``.  When neither divides, the JAX package falls back to its
  XLA scan; the port has no plain path on the card, so it pads the batch
  to the mesh size with zero rows (one valid frame) and drops their tokens;
- the parameters are copied to each distinct device once per parameter
  set (``replica``) and reused while their tensors are unchanged; a shard
  on the parameters' own device uses them as they are;
- on CUDA each shard runs on its own stream, so shards that share a card
  overlap as they would on separate cards; the tokens are gathered on the
  features' device in batch order.

``mesh_decode`` is the entry the models call; ``map_shards`` is the split,
launch and gather, which the extractor uses too.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

_REPLICAS: "collections.OrderedDict" = collections.OrderedDict()
_REPLICA_SLOTS = 8
_STREAMS = {}
_LOCK = threading.Lock()


def batch_axes(mesh, batch_size: int) -> Optional[Tuple[str, ...]]:
    """Mesh axes to shard a kernel batch over: ``()`` without a
    (multi-shard) mesh, the axis names when the batch divides them, else
    None (the caller pads, ``sharded_decode``)."""
    if mesh is None or mesh.size <= 1:
        return ()
    names = tuple(mesh.axis_names)
    if batch_size % mesh.size == 0:
        return names
    if "dp" in names:
        dp = mesh.shape["dp"]
        if dp > 1 and batch_size % dp == 0:
            return ("dp",)
    return None


def axes_size(mesh, axes: Optional[Tuple[str, ...]]) -> int:
    if mesh is None or not axes:
        return 1
    return math.prod(mesh.shape[a] for a in axes)


def _tree_to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def replica(params, device: torch.device):
    """``params`` on ``device``: the tree itself where its leaves already lie
    there, else a copy made once and kept while every leaf is the same
    tensor at the same version (an in-place update makes a new copy)."""
    leaves = _leaves(params)
    if all(x.device == device for x in leaves):
        return params
    key = (device, tuple((id(x), x._version) for x in leaves))
    with _LOCK:
        hit = _REPLICAS.get(key)
        if hit is not None:
            _REPLICAS.move_to_end(key)
            return hit[1]
    copy = _tree_to(params, device)
    with _LOCK:
        _REPLICAS[key] = (leaves, copy)     # the leaves pin their ids
        while len(_REPLICAS) > _REPLICA_SLOTS:
            _REPLICAS.popitem(last=False)
    return copy


def _stream(device: torch.device, i: int):
    with _LOCK:
        s = _STREAMS.get((device, i))
        if s is None:
            s = _STREAMS[(device, i)] = torch.cuda.Stream(device=device)
        return s


def map_shards(devices: Sequence[torch.device], fn: Callable, tensors: Sequence[torch.Tensor],
               out_device: torch.device) -> torch.Tensor:
    """Split each of ``tensors`` (or None) into ``len(devices)`` equal row
    blocks in order, run ``fn(i, device, blocks)`` for shard i with its
    blocks on its device, and concatenate the results on ``out_device``.
    On CUDA shard i runs on stream i of its device, ordered after the
    caller's stream; the caller's stream waits for every shard."""
    n = len(devices)
    rows = next(t for t in tensors if t is not None).shape[0] // n

    def blocks(i, device):
        return [None if t is None else t[i * rows:(i + 1) * rows].to(device, non_blocking=True)
                for t in tensors]

    if out_device.type != "cuda":
        return torch.cat([fn(i, d, blocks(i, d)).to(out_device) for i, d in enumerate(devices)])
    main = torch.cuda.current_stream(out_device)
    outs, streams = [], []
    for i, d in enumerate(devices):
        s = _stream(d, i)
        s.wait_stream(main)
        with torch.cuda.device(d), torch.cuda.stream(s):
            out = fn(i, d, blocks(i, d))
            outs.append(out.to(out_device, non_blocking=True))
        streams.append(s)
    for s in streams:
        main.wait_stream(s)
    for o in outs:        # made on a shard's stream, read on the caller's
        o.record_stream(main)
    return torch.cat(outs)


def sharded_decode(mesh, axes: Optional[Tuple[str, ...]], kernel: Callable, params,
                   feats_list: Sequence[torch.Tensor],
                   feat_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Run ``kernel(params, feats_list, feat_mask) -> [b, L] tokens`` once per
    batch shard over ``axes`` of ``mesh`` (None: every axis, the batch
    padded to the mesh size first); returns the [B, L] tokens in order."""
    B, T = feats_list[0].shape[:2]
    device = feats_list[0].device
    if axes is None:
        axes = tuple(mesh.axis_names)
        pad = -B % mesh.size
        feats_list = [torch.cat([f, f.new_zeros((pad, *f.shape[1:]))]) for f in feats_list]
        if feat_mask is not None:
            extra = torch.zeros((pad, T), dtype=feat_mask.dtype, device=feat_mask.device)
            extra[:, 0] = True
            feat_mask = torch.cat([feat_mask, extra])
    n = axes_size(mesh, axes)
    # shard i of an axis subset lives on the first device of its block
    stride = len(mesh.devices) // n
    devices = [mesh.devices[i * stride] for i in range(n)]

    def shard(i, d, blocks):
        return kernel(replica(params, d), blocks[:-1], blocks[-1])

    return map_shards(devices, shard, [*feats_list, feat_mask], device)[:B]


def mesh_decode(mesh, kernel: Callable, params, feats_list: Sequence[torch.Tensor],
                feat_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``kernel`` over the mesh: one direct call without a mesh (or with a
    one-shard one), else ``sharded_decode``.  A rank of a multi-process
    mesh shards over its own devices (``Mesh.local``)."""
    if mesh is not None:
        mesh = mesh.local()
    axes = batch_axes(mesh, feats_list[0].shape[0])
    if axes == ():
        return kernel(params, list(feats_list), feat_mask)
    return sharded_decode(mesh, axes, kernel, params, feats_list, feat_mask)
