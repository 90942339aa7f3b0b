"""repro_torch.launch: device meshes (``mesh.py``) and the serving
launcher (``python -m repro_torch.launch.serve``).  The training
launcher and the production sharding (``train.py``, ``dryrun.py``,
``sharding.py``, ``specs.py``) come later (ROADMAP queue A, item 15)."""
from .mesh import Mesh, make_data_mesh

__all__ = ["Mesh", "make_data_mesh"]
