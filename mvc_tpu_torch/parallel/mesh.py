"""The device mesh (``mvc_tpu/parallel/mesh.py``) for data parallelism.

The JAX package expresses parallelism as a ``jax.sharding.Mesh`` with
``dp`` and ``tp`` (and optionally ``sp``) axes and lets GSPMD insert the
collectives.  Here nothing inserts them, so the mesh is a small record of
who does what:

- ``shape``: the axis sizes, in the JAX package's order;
- ``devices``: the devices this process drives, one per local shard.  A
  device may repeat: several shards then share one card, each on its own
  CUDA stream (``ops/sharded.py``), or the CPU in the tests;
- ``group``, ``rank``, ``world_size``: the ``torch.distributed`` process
  group of the data-parallel ranks (``parallel/distributed.py``); None, 0
  and 1 in a process without one.

Training runs one process per device: rank r trains on ``devices[0]`` and
all-reduces its gradients (``training/trainer.py``).  Prediction, serving
and extraction split one process's batch over ``devices``
(``ops/sharded.py``).  The tensor-parallel parameter rules of the JAX
module (``mesh.py:67-95``) are not ported (ROADMAP.md §1).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mvc_tpu_torch.config import MeshConfig


class Mesh:
    def __init__(self, shape: Dict[str, int], devices: Sequence[torch.device], group=None,
                 rank: int = 0, world_size: int = 1):
        self.shape = dict(shape)
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        self.rank = rank
        self.world_size = world_size

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


def make_mesh(dp: int = -1, tp: int = 1, sp: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ("dp", "tp") mesh, or ("dp", "tp", "sp") when ``sp > 1``.  ``dp=-1``
    takes every remaining device.  ``devices`` are this process's
    (``torch.device``s, repeats allowed); by default the rank's device
    under a process group, else every visible card, else the CPU.  Under a
    process group of N ranks the mesh spans N times the local devices and
    must use all of them."""
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
    return Mesh(shape, local[:(dp * tp * sp) // world], group=distributed.process_group(),
                rank=rank, world_size=world)


def mesh_from_config(cfg: MeshConfig, devices=None) -> Mesh:
    return make_mesh(dp=cfg.dp, tp=cfg.tp, sp=getattr(cfg, "sp", 1), devices=devices)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows (a loader's process shard, padded by
    ``pad_batch_to_multiple``) as tensors on the rank's device; values
    that are not arrays stay as they are.  The JAX function assembles the
    global array from every process's rows; here each rank keeps its own
    and the gradients meet in the all-reduce."""
    return {k: torch.from_numpy(np.asarray(v)).to(mesh.device) if hasattr(v, "ndim") else v
            for k, v in batch.items()}


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
