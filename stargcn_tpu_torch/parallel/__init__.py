"""Device meshes over ``torch.distributed``, the sharding layouts of both
trainers, the collectives and their model (``perfmodel``), and the scaling
and mesh-scale twins (the port of ``stargcn_tpu/parallel``)."""

from stargcn_tpu_torch.parallel.mesh import (Mesh, initialize_distributed,
                                             make_mesh)
from stargcn_tpu_torch.parallel.shardings import GraphShardings, Shard

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "GraphShardings",
           "Shard"]
