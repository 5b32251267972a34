"""Multi-GPU serving and training over ``torch.distributed`` (port of
unitex_tpu/parallel): process meshes, the tensor-parallel cuts, their
autograd collectives and the GPipe schedule."""

from .mesh import Mesh, broadcast_tensors, make_mesh
from .sharding import data_parallel, data_shard, shard_flux_params, shard_sd3_params
