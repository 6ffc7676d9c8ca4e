"""Data parallelism: the mesh, the process group and the multi-process
smoke path (``mvc_tpu/parallel/``)."""

from mvc_tpu_torch.parallel.distributed import (
    data_shard,
    initialize,
    make_global_mesh,
    shutdown,
)
from mvc_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_from_config,
    pad_batch_to_multiple,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "mesh_from_config", "pad_batch_to_multiple", "shard_batch",
           "data_shard", "initialize", "make_global_mesh", "shutdown"]
