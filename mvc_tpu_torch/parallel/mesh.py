"""The device mesh (``mvc_tpu/parallel/mesh.py``): data, tensor and
sequence parallelism.

The JAX package expresses parallelism as a ``jax.sharding.Mesh`` with
``dp`` and ``tp`` (and optionally ``sp``) axes and lets GSPMD insert the
collectives.  Here nothing inserts them, so the mesh is a small record of
who does what:

- ``shape``: the axis sizes, in the JAX package's order;
- ``devices``: the devices this process drives, one per local shard.  A
  device may repeat: several shards then share one card, each on its own
  CUDA stream (``ops/sharded.py``), or the CPU in the tests;
- ``group``, ``rank``, ``world_size``: the ``torch.distributed`` process
  group of every rank (``parallel/distributed.py``); None, 0 and 1 in a
  process without one;
- ``groups``: on a tp/sp mesh the sub-groups the collectives take, by
  axis: ``dp``, ``tp``, ``sp`` and ``dp_sp`` (None for an axis of one).

Rank r stands at JAX's grid position: ``devices.reshape(dp, tp, sp)``
with sp innermost, so ``coords()`` is r's index in that array.  Training
runs one process per shard: the ranks of one dp index read the same rows
(``data_shard``), each tp rank holds ``ceil(V / tp)`` contiguous vocab ids
of every leaf ``param_specs`` shards (the JAX rules of ``mesh.py:70-86``),
and each sp rank holds a block of the frames (``split_frames``).  The
collectives are ``parallel/collectives.py``'s; the gradients of each leaf
are summed over the ranks that hold the same slice of it
(``sum_gradients``).  Prediction, serving and extraction split one
process's batch over ``devices`` (``ops/sharded.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mvc_tpu_torch.config import MeshConfig
from mvc_tpu_torch.parallel.collectives import Shards

# sub-groups a tp/sp mesh makes, by the grid axes (dp=0, tp=1, sp=2) they span
_AXIS_GROUPS = (("dp", (0,)), ("tp", (1,)), ("sp", (2,)), ("dp_sp", (0, 2)))


class Mesh:
    def __init__(self, shape: Dict[str, int], devices: Sequence[torch.device], group=None,
                 rank: int = 0, world_size: int = 1, groups: Optional[Dict[str, object]] = None):
        self.shape = dict(shape)
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        self.rank = rank
        self.world_size = world_size
        self.groups = dict(groups or {})

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def sp(self) -> int:
        return self.shape.get("sp", 1)

    def coords(self) -> Tuple[int, int, int]:
        """This rank's (dp, tp, sp) index on a mesh of one shard a rank."""
        r, tp, sp = self.rank, self.tp, self.sp
        return r // (tp * sp), (r // sp) % tp, r % sp

    def data_shard(self) -> Tuple[int, int]:
        """(process_index, process_count) for the loaders: the rank's dp
        index and the number of dp indices among the ranks (the tp and sp
        ranks of one dp index read the same rows)."""
        n = self.tp * self.sp
        return self.rank // n, self.world_size // n

    def shards(self, vocab_size: int, frames_split: bool) -> Optional[Shards]:
        """The ``Shards`` of one step of a tp/sp mesh (None on any other):
        this rank's vocab slice of ``vocab_size`` ids, and its frame block
        when ``frames_split``."""
        if self.tp * self.sp == 1:
            return None
        _, t, s = self.coords()
        lo = t * _slice_width(vocab_size, self.tp)
        return Shards(tp_group=self.groups.get("tp"), vocab_lo=lo,
                      sp_group=self.groups.get("sp") if frames_split else None,
                      sp=self.sp, sp_index=s, tp=self.tp)

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """Shards over every process (the JAX mesh's device count)."""
        return math.prod(self.shape.values())

    @property
    def device(self) -> torch.device:
        """The device this rank trains on."""
        return self.devices[0]

    def local(self) -> "Mesh":
        """This process's part of the mesh: its own devices as a ``dp`` axis,
        with no process group (a rank's prediction shards its own rows)."""
        if self.world_size == 1:
            return self
        return Mesh({"dp": len(self.devices), "tp": 1}, self.devices)

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return (f"Mesh({self.shape}, devices=[{devs}], rank={self.rank}, "
                f"world_size={self.world_size})")


def _new_groups(dims: Tuple[int, int, int], rank: int) -> Dict[str, object]:
    """This rank's sub-group along each of ``_AXIS_GROUPS`` (None for an
    axis of one, the world for an axis of every rank).  ``dist.new_group``
    is called by every rank for every group, in one order."""
    world = math.prod(dims)
    grid = np.arange(world).reshape(dims)
    out = {}
    for name, axes in _AXIS_GROUPS:
        size = math.prod(dims[a] for a in axes)
        if size in (1, world):
            out[name] = dist.group.WORLD if size > 1 else None
            continue
        rest = [a for a in range(3) if a not in axes]
        for ranks in grid.transpose(rest + list(axes)).reshape(-1, size).tolist():
            g = dist.new_group(ranks)
            if rank in ranks:
                out[name] = g
    return out


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("dp", "tp") mesh, or ("dp", "tp", "sp") when ``sp > 1``.  ``dp=-1``
    takes every remaining device.  ``devices`` are this process's
    (``torch.device``s, repeats allowed); by default the rank's device
    under a process group, else every visible card, else the CPU.  Under a
    process group of N ranks the mesh spans N times the local devices and
    must use all of them; with tp or sp above 1 it takes one device a rank
    and makes the axes' sub-groups (every rank must call this together)."""
    from mvc_tpu_torch.parallel import distributed

    rank, world = distributed.data_shard()
    local = [torch.device(d) for d in (devices if devices is not None
                                       else distributed.local_devices())]
    n = world * len(local)
    if dp == -1:
        if n % (tp * sp):
            raise ValueError(f"{n} devices not divisible by tp*sp={tp * sp}")
        dp = n // (tp * sp)
    if dp * tp * sp > n:
        raise ValueError(f"mesh {dp}x{tp}x{sp} needs more than {n} devices")
    if world > 1 and dp * tp * sp != n:
        raise ValueError(f"a mesh over {world} processes takes all {n} devices, "
                         f"not {dp}x{tp}x{sp}")
    shape = {"dp": dp, "tp": tp, **({"sp": sp} if sp > 1 else {})}
    groups = {}
    if world > 1 and tp * sp > 1:
        if len(local) != 1:
            raise ValueError(f"a tp/sp mesh over processes takes one device a rank, not "
                             f"{len(local)}")
        groups = _new_groups((dp, tp, sp), rank)
    return Mesh(shape, local[:(dp * tp * sp) // world], group=distributed.process_group(),
                rank=rank, world_size=world, groups=groups)


def mesh_from_config(cfg: MeshConfig, devices=None) -> Mesh:
    return make_mesh(dp=cfg.dp, tp=cfg.tp, sp=getattr(cfg, "sp", 1), devices=devices)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows (a loader's process shard, padded by
    ``pad_batch_to_multiple``) as tensors on the rank's device, with its
    block of the frames on an sp mesh (``split_frames``); values that are
    not arrays stay as they are; on an sp mesh ``frames_split`` says
    whether the frames were split.  The JAX function assembles the global
    array from every process's rows; here each rank keeps its own and the
    gradients meet in the all-reduce."""
    out = {k: torch.from_numpy(np.asarray(v)).to(mesh.device) if hasattr(v, "ndim") else v
           for k, v in batch.items()}
    out, split = split_frames(mesh, out)
    return dict(out, frames_split=split) if mesh.sp > 1 else out


_SP_TIME_AXIS = ("audio", "visual", "feat_mask")     # [B, T, ...]: frames on axis 1


def split_frames(mesh: Optional[Mesh], batch: dict) -> Tuple[dict, bool]:
    """(the batch with this rank's block of the frames of ``audio``,
    ``visual`` and ``feat_mask``, True) on an sp mesh when sp divides the
    batch's T; else (the batch, False): the frames stay whole, as the JAX
    ``shard_batch`` leaves them (``mesh.py:124-127``).  Captions never split."""
    sp = 1 if mesh is None else mesh.sp
    T = batch["feat_mask"].shape[1] if "feat_mask" in batch else None
    if sp == 1 or T is None or T % sp:
        return batch, False
    s, t = mesh.coords()[2], T // sp
    return {k: v[:, s * t:(s + 1) * t] if k in _SP_TIME_AXIS else v
            for k, v in batch.items()}, True


# ------------------------------------------------------------------ the vocab-sharded leaves
def _spec(path: str, leaf) -> tuple:
    """``_decoder_param_spec`` of ``mvc_tpu/parallel/mesh.py:70-86`` as a
    tuple: an embedding table's rows, ``out/w``'s columns and ``out/b``
    over tp; everything else replicated."""
    if "embedding" in path and leaf.ndim == 2:
        return ("tp", None)
    if path.endswith("out/w"):
        return (None, "tp")
    if path.endswith("out/b"):
        return ("tp",)
    return ()


def _map_specs(fn, tree, prefix="", in_list=False):
    """``fn(spec, leaf)`` over every leaf.  As the JAX ``param_shardings``
    walks only dicts, a list (the transformer's layers) takes one
    replicated spec as a prefix: every leaf under it is ``()``, whatever
    its path."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, f"{prefix}/{k}" if prefix else k, in_list)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_specs(fn, v, prefix, True) for v in tree]
    return fn(() if in_list else _spec(prefix, tree), tree)


def param_specs(params):
    """The partition spec of every leaf of a parameter tree, as the
    ``.spec`` of the JAX ``param_shardings``: ``("tp", None)``, ``(None,
    "tp")``, ``("tp",)`` or ``()``."""
    return _map_specs(lambda spec, _: spec, params)


def _slice_width(n: int, tp: int) -> int:
    """The ids of one tp slice: ``ceil(n / tp)``, the last slice the rest
    (GSPMD accepts a V that tp does not divide)."""
    width = -(-n // tp)
    if width * (tp - 1) >= n:
        raise ValueError(f"a vocab of {n} leaves an empty slice on tp={tp}")
    return width


def shard_leaf(mesh: Mesh, spec: tuple, x):
    """This rank's contiguous slice of ``x`` (a tensor or an array) along
    its ``"tp"`` axis; ``x`` itself when it is replicated."""
    if "tp" not in spec or mesh.tp == 1:
        return x
    axis = spec.index("tp")
    width = _slice_width(x.shape[axis], mesh.tp)
    lo = mesh.coords()[1] * width
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, min(lo + width, x.shape[axis]))
    part = x[tuple(idx)]
    return part.clone() if isinstance(part, torch.Tensor) else np.array(part)


def gather_leaf(mesh: Mesh, spec: tuple, x: torch.Tensor, n: int) -> torch.Tensor:
    """The whole leaf of ``n`` vocab ids from every tp rank's slice: each
    rank writes its slice into zeros and the tp group sums them, which
    NCCL and gloo both take for CUDA tensors (gloo gathers no CUDA
    tensor).  Exact: every element has one nonzero term."""
    if "tp" not in spec or mesh.tp == 1:
        return x
    axis = spec.index("tp")
    lo = mesh.coords()[1] * _slice_width(n, mesh.tp)
    shape = list(x.shape)
    shape[axis] = n
    full = x.new_zeros(shape)
    full.narrow(axis, lo, x.shape[axis]).copy_(x.detach())
    dist.all_reduce(full, group=mesh.groups["tp"])
    return full


def shard_params(mesh: Mesh, params):
    """The tree with this rank's vocab slice of every tp-sharded leaf (new
    tensors; replicated leaves as they are)."""
    return _map_specs(lambda spec, x: shard_leaf(mesh, spec, x), params)


def gather_params(mesh: Mesh, params, vocab_size: int):
    """The whole tree from every tp rank's slices (every tp-sharded axis is
    the vocab axis); the caller's tree on a mesh without tp.  Every rank
    of the tp group calls it."""
    if mesh.tp == 1:
        return params
    return _map_specs(lambda spec, x: gather_leaf(mesh, spec, x, vocab_size), params)


def sharded_leaves(mesh: Mesh, params) -> List[bool]:
    """For each leaf of ``tree_leaves(params)`` order, whether it is a tp
    slice on this mesh."""
    from mvc_tpu_torch.training.optimizer import tree_leaves

    return [mesh.tp > 1 and "tp" in spec for spec in tree_leaves(param_specs(params))]


def sum_over_ranks(tensors: Sequence[torch.Tensor], group, bucket_elems: int = 1 << 23) -> None:
    """Sum ``tensors`` over the ranks of ``group`` in place, through flat
    buckets of about ``bucket_elems`` elements (one all-reduce each)."""
    buckets, cur, size = [], [], 0
    for t in tensors:
        cur.append(t)
        size += t.numel()
        if size >= bucket_elems:
            buckets.append(cur)
            cur, size = [], 0
    if cur:
        buckets.append(cur)
    for bucket in buckets:
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def sum_gradients(mesh: Mesh, leaves: Sequence[torch.Tensor], sharded: Sequence[bool],
                  extra: Sequence[torch.Tensor] = ()) -> None:
    """Sum each leaf's gradient (a missing one as zeros) over the ranks that
    hold the same slice of it, in place: a replicated leaf and ``extra``
    over every rank, a vocab-sharded leaf over the dp·sp ranks of its tp
    index.  Each bucket is one all-reduce (``sum_over_ranks``)."""
    grads: List[torch.Tensor] = []
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    sum_over_ranks([g for g, s in zip(grads, sharded) if not s] + list(extra), mesh.group)
    if mesh.groups.get("dp_sp") is not None:
        sum_over_ranks([g for g, s in zip(grads, sharded) if s], mesh.groups["dp_sp"])


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the batch axis so it divides the dp mesh axis (padding rows carry
    sample_mask=False and drop out of every loss).  Captions are [L, B],
    time-first."""
    ref_key = "audio" if "audio" in batch else "video_rows"
    b = batch[ref_key].shape[0]
    target = ((b + multiple - 1) // multiple) * multiple
    if target == b:
        return batch
    pad = target - b
    out = {}
    for k, v in batch.items():
        if not hasattr(v, "ndim"):
            out[k] = v
        elif k == "captions":
            out[k] = np.concatenate([v, np.zeros((v.shape[0], pad), v.dtype)], axis=1)
        else:
            out[k] = np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)], axis=0)
    return out
