"""repro_torch.launch: device meshes (``mesh.py``, the production meshes
among them), the ranks that run one shard a process (``ranks.py``), the
sharding rules (``sharding.py``), the dry run's input
specs (``specs.py``) and the dry run itself (``python -m
repro_torch.launch.dryrun``), the serving launcher (``python -m
repro_torch.launch.serve``) and the training launcher (``python -m
repro_torch.launch.train``)."""
from .mesh import (Mesh, init_ranks, make_data_mesh, make_host_mesh,
                   make_production_mesh)

__all__ = ["Mesh", "init_ranks", "make_data_mesh", "make_host_mesh",
           "make_production_mesh"]
