"""repro_torch.launch: the device mesh of the sharded assembly path
(counterpart of ``repro.launch.mesh``'s ``make_data_mesh``; the rest of
``repro.launch`` belongs to the LM stack, ROADMAP queue A, item 15)."""
from .mesh import Mesh, make_data_mesh

__all__ = ["Mesh", "make_data_mesh"]
