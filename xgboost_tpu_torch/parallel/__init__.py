"""Distributed training over ``torch.distributed``: row groups
(``mesh.py``), the distributed grower (``grow.py``) and sketch
(``sketch.py``)."""

from .grow import distributed_boost_rounds, distributed_grow_tree_fused
from .mesh import (ROW_AXIS, RowGroup, collective_active, current_mesh,
                   init_distributed, make_mesh, mesh_context)
from .sketch import distributed_compute_cuts

__all__ = ["ROW_AXIS", "RowGroup", "init_distributed", "make_mesh",
           "mesh_context", "current_mesh", "collective_active",
           "distributed_grow_tree_fused", "distributed_boost_rounds",
           "distributed_compute_cuts"]
