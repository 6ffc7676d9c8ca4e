"""Multi-process bring-up (``mvc_tpu/parallel/distributed.py``).

``initialize`` joins this process to a ``torch.distributed`` process group
and picks the rank's device; ``data_shard`` hands back the coordinates for
``DataLoader(process_index=..., process_count=...)`` and
``make_global_mesh`` the mesh over every rank.  With no configuration
everything stays single-process.

The backend follows the rank's device: NCCL for a card, gloo for the CPU.
NCCL takes one card per rank ("Duplicate GPU detected" otherwise), so
several ranks on one card must ask for gloo (``backend="gloo"``), which
all-reduces and broadcasts CUDA tensors but gathers only through
``all_gather_object``.  The backend is never switched behind the caller's
back: NCCL asked for on the CPU raises.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

_DEVICE: List[Optional[torch.device]] = [None]


def _default_device(process_id: int) -> torch.device:
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
    return torch.device("cuda", local)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None, timeout_s: float = 300.0) -> Tuple[int, int]:
    """Join the process group (idempotent); returns (process_index,
    process_count) for the data loader.

    Unset arguments come from the JAX package's environment
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``),
    else from PyTorch's as ``torchrun`` sets it (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  The address
    is ``host:port`` or a URL (``tcp://host:port``, ``file:///path``).
    With no address this is a no-op returning (0, 1).

    ``device``: the rank's device, by default ``cuda:LOCAL_RANK`` when
    there is a card, else the CPU.  ``backend``: "nccl" for a card and
    "gloo" for the CPU unless given.  ``timeout_s`` bounds every
    collective."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        num_processes = int(env.get("JAX_NUM_PROCESSES") or env.get("WORLD_SIZE") or 0)
    if process_id is None:
        process_id = int(env.get("JAX_PROCESS_ID") or env.get("RANK") or 0)
    if not coordinator_address or not num_processes:
        return 0, 1

    device = torch.device(device) if device is not None else _default_device(process_id)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if init_method.startswith("file://"):     # a relative path would parse as a host name
        init_method = "file://" + os.path.abspath(init_method[len("file://"):])
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _DEVICE[0] = device
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE[0] = None


def process_group():
    """The default process group, or None in a single process."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def data_shard() -> Tuple[int, int]:
    """(process_index, process_count) for DataLoader sharding over data
    parallelism alone; on a tp/sp mesh the loaders take ``Mesh.data_shard``."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices() -> List[torch.device]:
    """The rank's device under a process group; else every visible card,
    else the CPU."""
    if _DEVICE[0] is not None:
        return [_DEVICE[0]]
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_global_mesh(dp: int = -1, tp: int = 1, sp: int = 1):
    """The mesh over every rank's device (every rank calls it together)."""
    from mvc_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(dp=dp, tp=tp, sp=sp, devices=local_devices())
