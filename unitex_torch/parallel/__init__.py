"""Multi-GPU serving over ``torch.distributed`` (port of
unitex_tpu/parallel): process meshes and the tensor-parallel cuts."""

from .mesh import Mesh, broadcast_tensors, make_mesh
from .sharding import data_parallel, data_shard, shard_flux_params, shard_sd3_params
