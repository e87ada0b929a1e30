"""Parallelism of the port on ``torch.distributed``: the (dp, tp) mesh and
its collectives (``mesh``), the ring-overlapped tp matmul
(``tp_overlap``) and the launcher of local ranks (``launch``)."""
from .mesh import MeshConfig, input_shardings, make_mesh, param_shardings
