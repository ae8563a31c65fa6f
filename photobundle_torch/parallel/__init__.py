"""Parallel execution: the elastic work scheduler of the multi-sequence
refinement (photobundle_torch/multi.py). Device meshes (the JAX package's
parallel/mesh.py and parallel/sharded.py) are not ported yet (ROADMAP.md
queue 1 item 3)."""

from .scheduler import LeaseScheduler, WorkUnit, make_units

__all__ = ["LeaseScheduler", "WorkUnit", "make_units"]
