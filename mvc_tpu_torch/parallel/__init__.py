"""Data, tensor and sequence parallelism: the mesh, the process group, the
hand-written collectives and the multi-process smoke path
(``mvc_tpu/parallel/``)."""

from mvc_tpu_torch.parallel.distributed import (
    data_shard,
    initialize,
    make_global_mesh,
    shutdown,
)
from mvc_tpu_torch.parallel.mesh import (
    Mesh,
    gather_params,
    make_mesh,
    mesh_from_config,
    pad_batch_to_multiple,
    param_specs,
    shard_batch,
    shard_params,
)

__all__ = ["Mesh", "make_mesh", "mesh_from_config", "pad_batch_to_multiple", "shard_batch",
           "param_specs", "shard_params", "gather_params",
           "data_shard", "initialize", "make_global_mesh", "shutdown"]
