"""Device meshes on torch.distributed.

Twin of photobundle_tpu/parallel/mesh.py. The JAX package names its mesh
axes and lets `shard_map` run the per-shard program on every device; here
every rank of a torch.distributed world runs that program (SPMD, one rank
per device) and a named axis is a process group:

    'points'  — residual-block sharding: the point table and every
                (N, ...) tensor split over the axis; the Schur reduction
                is a sum over its group.
    'windows' — window/sequence data parallelism: independent windows
                solved on the axis' ranks, no cross-talk.
    'frames'  — window-frame sharding (parallel/sharded.make_frames_mesh).

A mesh spans the whole world: `make_mesh` raises unless a process group
of exactly the mesh's size is initialized (`torchrun --nproc-per-node N`,
or `initialize_distributed`). It never solves unsharded in its place.

Backends: NCCL when the ranks' tensors live on cards, gloo on the CPU, and
gloo on a card only when the caller asks for it (`backend="gloo"`; it
stages card tensors through the host and cannot be captured in a CUDA
graph). NCCL missing or failing raises; nothing switches quietly.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

POINTS_AXIS = "points"
WINDOWS_AXIS = "windows"
FRAMES_AXIS = "frames"


def backend_for(device, backend: str | None = None) -> str:
    """The process-group backend for ranks whose tensors live on `device`:
    `backend` when given ('gloo' anywhere, 'nccl' on a card), else 'nccl'
    on a card and 'gloo' on the CPU."""
    kind = torch.device(device).type
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    if backend == "nccl":
        if kind != "cuda":
            raise ValueError("NCCL carries card tensors only; the CPU "
                             "takes backend='gloo'")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL; pass "
                               "backend='gloo' to run on gloo instead")
    return backend


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device="cuda",
                           backend: str | None = None) -> None:
    """Twin of `jax.distributed.initialize`: join `num_processes` ranks
    (rank `process_id`) through the TCP store at `coordinator`
    ('host:port'); a no-op for a single process. The backend follows
    `backend_for(device, backend)`."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend_for(device, backend),
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def initialize_from_env(device="cuda", backend: str | None = None):
    """Join the world `torchrun` describes in the environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK). Returns the device
    of this rank: `device`, or on a card the card LOCAL_RANK when the
    world has more than one rank. A world already initialized is taken as
    it is; a single process initializes nothing."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not dist.is_initialized() and world > 1:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
            torch.cuda.set_device(device)
        dist.init_process_group(backend_for(device, backend),
                                init_method="env://")
    return device


def is_lead() -> bool:
    """Whether this process writes a run's outputs: rank 0 of an
    initialized world, or a process outside any."""
    return not dist.is_initialized() or dist.get_rank() == 0


def check_replicated(tensor: torch.Tensor, what: str) -> None:
    """Raise unless `tensor` is bitwise the same on every rank of the
    world (rank 0's copy is broadcast and compared bit for bit)."""
    bits = tensor.contiguous().view(torch.uint8)
    ref = bits.clone()
    dist.broadcast(ref, src=0)
    differs = torch.tensor([int(not torch.equal(ref, bits))],
                           device=bits.device)
    dist.all_reduce(differs)
    if int(differs):
        raise RuntimeError(f"{what} differs between ranks on "
                           f"{int(differs)} of {dist.get_world_size()}")


def make_mesh(points: int = 1, windows: int = 1):
    """A ('windows', 'points') DeviceMesh over the initialized world,
    whose size must be points * windows; each axis' process group is
    `mesh.get_group(name)`."""
    return mesh_of((windows, points), (WINDOWS_AXIS, POINTS_AXIS))


def mesh_of(shape: tuple, names: tuple):
    """A DeviceMesh of `shape` with axes `names` over the whole world
    (raises naming torchrun when no world of that size is initialized)."""
    from torch.distributed.device_mesh import init_device_mesh

    need = 1
    for k in shape:
        need *= k
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        axes = " x ".join(f"{n}={k}" for n, k in zip(names, shape))
        raise RuntimeError(
            f"a device mesh of {axes} needs an initialized torch.distributed "
            f"world of {need} ranks (found "
            f"{'none' if have is None else have}); launch with `torchrun "
            f"--nproc-per-node {need} ...`, or call "
            f"parallel.mesh.initialize_distributed first")
    # The mesh's device type names the backend's devices: gloo groups take
    # card tensors too, so a gloo world's mesh is a CPU mesh.
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(names))


def axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name: str) -> int:
    return mesh.get_local_rank(name)
