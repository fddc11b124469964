"""Distributed training over ``torch.distributed``: row groups
(``mesh.py``, with ``form_world`` for elastic worlds), the distributed
grower (``grow.py``) and sketch (``sketch.py``), and the heartbeat
membership of elastic training (``membership.py``)."""

from .grow import distributed_boost_rounds, distributed_grow_tree_fused
from .mesh import (ROW_AXIS, RowGroup, collective_active, current_mesh,
                   form_world, init_distributed, make_mesh, mesh_context)
from .membership import Membership, WorkerLost
from .sketch import distributed_compute_cuts

__all__ = ["ROW_AXIS", "RowGroup", "init_distributed", "form_world",
           "make_mesh", "mesh_context", "current_mesh", "collective_active",
           "distributed_grow_tree_fused", "distributed_boost_rounds",
           "distributed_compute_cuts", "Membership", "WorkerLost"]
