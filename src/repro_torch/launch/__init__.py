"""repro_torch.launch: device meshes (``mesh.py``), the dry-run's input
specs (``specs.py``), the serving launcher (``python -m
repro_torch.launch.serve``) and the training launcher (``python -m
repro_torch.launch.train``).  The production sharding (``dryrun.py``,
``sharding.py``) comes later (ROADMAP queue A, item 15, step 4)."""
from .mesh import Mesh, make_data_mesh

__all__ = ["Mesh", "make_data_mesh"]
