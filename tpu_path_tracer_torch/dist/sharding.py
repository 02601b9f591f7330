"""Process groups and ray-axis sharding (``tpu_path_tracer.dist.sharding``)
on ``torch.distributed``.

The JAX package shards the pixel axis over a 1-D device mesh named "rays"
and replicates the scene (``sharding.py:1-13``).  The port keeps that
split with one process per rank: rank r of an n-rank mesh owns rows
``[r * n_pad / n, (r + 1) * n_pad / n)`` of the padded framebuffer, every
rank holds the whole scene, and the parameter gradients are summed over
the ranks (``render_dist``).  A mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` named ``"rays"``; ``None``
stands for one process with no group.

Backends: NCCL when every rank of a host has a card of its own, gloo on the
CPU and when ranks share a card (NCCL refuses two ranks on one GPU).  Gloo
collectives here stage CUDA tensors through host memory explicitly; the
tracing stays on the card.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils import profiling

RAY_AXIS = "rays"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> int:
    """Join the process group (``sharding.py:26-60``), env-driven.

    Arguments default to torch's launcher variables, as ``torchrun`` sets
    them: ``MASTER_ADDR``/``MASTER_PORT`` (``coordinator_address`` is
    ``"host:port"``), ``WORLD_SIZE`` and ``RANK``.  On ``device="cuda"``
    the rank takes card ``LOCAL_RANK % torch.cuda.device_count()``
    (``LOCAL_RANK`` defaults to the rank) and the group runs NCCL, or gloo
    when the host has more ranks (``LOCAL_WORLD_SIZE``, default the world)
    than cards; ``device="cpu"`` runs gloo.  Call once per process before
    any device use.

    Returns this process's rank: 0 when no variable and no argument asks
    for a group (one process, none formed), and the rank again when the
    group already exists.
    """
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return 0
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"init_distributed needs a coordinator address, a process count "
            f"and a rank; got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r} (MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)")
    device = torch.device(device)
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("init_distributed(device='cuda'): no CUDA "
                               "device is available; pass device='cpu'")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)) % cards)
        torch.cuda.init()
        if int(env.get("LOCAL_WORLD_SIZE", num_processes)) <= cards:
            backend = "nccl"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return process_id


def make_mesh(devices: Optional[Sequence[int]] = None,
              n_devices: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh on the ``"rays"`` axis (``sharding.py:63-71``) over the
    ranks ``devices``, by default every rank of the group; ``n_devices``
    takes the first N.  Every rank of the group must call it (a smaller
    mesh forms a subgroup); ranks outside the mesh take no part in its
    calls (:func:`in_mesh`).  ``device_type`` is where the ranks keep their
    tensors: ``"cuda"`` (the card :func:`init_distributed` chose) or
    ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first")
    if devices is None:
        devices = range(dist.get_world_size())
        if n_devices is not None:
            devices = devices[:n_devices]
    return DeviceMesh(device_type, list(devices), mesh_dim_names=(RAY_AXIS,))


def mesh_size(mesh: Optional[DeviceMesh]) -> int:
    """Ranks on the ray axis; 1 without a mesh."""
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's place on the ray axis; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank()


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank keeps its tensors on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _staged(op, x: torch.Tensor, mesh: DeviceMesh):
    """Run the collective ``op`` on ``x`` in place, through host memory
    where the group's backend is gloo and ``x`` is on a card."""
    group = mesh.get_group()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        host = x.cpu()
        op(host, group)
        x.copy_(host)
    else:
        op(x, group)
    return x


def all_reduce_sum_(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum ``x`` over the mesh's ranks, in place."""
    return _staged(lambda t, g: dist.all_reduce(t, group=g), x, mesh)


def broadcast_(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Overwrite ``x`` with the mesh's first rank's, in place."""
    src = int(mesh.mesh.flatten()[0])  # a global rank
    return _staged(lambda t, g: dist.broadcast(t, src=src, group=g), x, mesh)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along rows, in rank order, on every
    rank (the chunks of a ray-sharded tensor make the global one)."""
    group = mesh.get_group()
    src = x
    if x.is_cuda and dist.get_backend(group) == "gloo":
        profiling.count("host_syncs")
        src = x.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size())]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts).to(x.device)


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def ray_sharding(mesh: DeviceMesh):
    """Leading axis split over the ranks (``sharding.py:74-76``): returns
    ``put(x)``, this rank's contiguous chunk of the rows of a global
    tensor ``x`` (framebuffers, targets), on this rank's device.  The row
    count must divide by the mesh size (``render_dist.padded_pixels``)."""
    size, rank, device = mesh.size(), mesh.get_local_rank(), rank_device(mesh)

    def put(x: torch.Tensor) -> torch.Tensor:
        x = torch.as_tensor(x)
        if x.shape[0] % size:
            raise ValueError(f"{x.shape[0]} rows do not split over {size} "
                             f"ranks")
        n = x.shape[0] // size
        return x[rank * n:(rank + 1) * n].to(device).contiguous()

    return put


def replicated(mesh: DeviceMesh):
    """Every rank holds all of it (``sharding.py:79-81``): returns
    ``put(x)``, ``x`` on this rank's device overwritten with the mesh's
    first rank's, so all ranks hold the same bits."""
    device = rank_device(mesh)

    def put(x: torch.Tensor) -> torch.Tensor:
        return broadcast_(x.detach().to(device).clone(), mesh)

    return put


def shard_scene(scene, mesh: DeviceMesh):
    """Every tensor of the scene, BVH included, on this rank's device with
    the first rank's values (``sharding.py:84-88``).  Every rank of the
    mesh must pass a scene of the same layout (the same build)."""
    put = replicated(mesh)

    def tree(x):
        if isinstance(x, torch.Tensor):
            return put(x)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(tree(v) for v in x))
        return x

    return tree(scene)
