"""Device meshes over ``torch.distributed`` and the sharding layouts of
full-graph training (the port of ``stargcn_tpu/parallel``)."""

from stargcn_tpu_torch.parallel.mesh import (Mesh, initialize_distributed,
                                             make_mesh)
from stargcn_tpu_torch.parallel.shardings import GraphShardings, Shard

__all__ = ["Mesh", "make_mesh", "initialize_distributed", "GraphShardings",
           "Shard"]
