"""Parallel execution: device meshes on torch.distributed (`mesh`, the
twin of the JAX package's parallel/mesh.py; `sharded`, of its
parallel/sharded.py: the points, ('frames', 'points') and ('windows',
'points') layouts of the LM solve and of the engines' window solves) and
the elastic work scheduler of the multi-sequence refinement
(photobundle_torch/multi.py)."""

from . import mesh, sharded
from .mesh import initialize_distributed, make_mesh
from .scheduler import LeaseScheduler, WorkUnit, make_units
from .sharded import (ShardedLMSolver, make_batched_sharded_solver,
                      make_frames_mesh, make_frames_sharded_solver)

__all__ = ["LeaseScheduler", "ShardedLMSolver", "WorkUnit",
           "initialize_distributed", "make_batched_sharded_solver",
           "make_frames_mesh", "make_frames_sharded_solver", "make_mesh",
           "make_units", "mesh", "sharded"]
