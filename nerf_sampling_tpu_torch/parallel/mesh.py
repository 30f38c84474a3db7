"""The rank mesh and the ray-batch split (nerf_sampling_tpu/parallel/mesh.py).

One process per card (a *rank*) in one ``torch.distributed`` process group.
Both training and rendering split the ray batch into equal, contiguous row
blocks in rank order; parameters are replicated. A ``Mesh`` records how the
ranks are laid out: ``("rays",)`` for the flat 1-D mesh, or ``("dcn",
"rays")`` for the hybrid one, one row per host. Ranks are numbered
host-major (torchrun's numbering), so the hybrid mesh's row blocks are the
JAX package's DCN-major ray sharding: the ray blocks of one host are
neighbours, and rank r holds block r on either mesh shape.

Without a process group every helper sees a world of one rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

RAY_AXIS = "rays"
DCN_AXIS = "dcn"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group laid out as ``shape`` over ``axis_names``."""

    world: int
    rank: int
    local_rank: int
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    group: Any = None  # the process group (None: the default group, or no group at world 1)

    @property
    def backend(self) -> str | None:
        """The group's backend ("gloo" or "nccl"), None at world 1 without a group."""
        return dist.get_backend(self.group) if dist.is_initialized() else None


def _world() -> tuple[int, int, int]:
    """(world size, rank, local rank) of this process, (1, 0, 0) without a group."""
    if not dist.is_initialized():
        return 1, 0, 0
    rank = dist.get_rank()
    return dist.get_world_size(), rank, int(os.environ.get("LOCAL_RANK", rank))


def make_mesh(n: int | None = None) -> Mesh:
    """The 1-D ``("rays",)`` mesh over every rank; ``n`` (the JAX device
    count argument), where given, must be the world size: a rank drives one
    card, so a mesh over part of the world would leave ranks idle."""
    world, rank, local = _world()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: start {n} ranks (one per card)")
    return Mesh(world, rank, local, (world,), (RAY_AXIS,))


def make_hybrid_mesh(*, groups: int | None = None) -> Mesh:
    """The 2-D ``("dcn", "rays")`` mesh, one row per host.

    The hosts are found from the local world size (``LOCAL_WORLD_SIZE``, which
    torchrun sets; the whole world when it is unset). ``groups`` splits the
    world into that many equal rows instead (to test the layout on one host).
    """
    world, rank, local = _world()
    if groups is None:
        per = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if per < 1 or world % per:
            raise ValueError("hosts expose unequal device counts; pass groups=")
        groups = world // per
    elif world % groups:
        raise ValueError(f"{world} devices not divisible into {groups} groups")
    return Mesh(world, rank, local, (groups, world // groups), (DCN_AXIS, RAY_AXIS))


def ray_rows(mesh: Mesh, n: int) -> tuple[int, int]:
    """The rank's rows ``(lo, hi)`` of a global batch of ``n`` rays."""
    if n % mesh.world:
        raise ValueError(f"ray batch of {n} rows not divisible into {mesh.world} shards "
                         f"({' x '.join(map(str, mesh.shape))} {'/'.join(mesh.axis_names)} mesh)")
    per = n // mesh.world
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_ray_batch(mesh: Mesh, batch):
    """The rank's rows of a global batch: a tensor (or array), or a tuple,
    list or dict of them, all of the same leading size."""
    if isinstance(batch, dict):
        return {k: shard_ray_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_ray_batch(mesh, v) for v in batch)
    lo, hi = ray_rows(mesh, batch.shape[0])
    return batch[lo:hi]


def host_side(mesh: Mesh, t: torch.Tensor) -> bool:
    """Whether a collective on ``t`` goes through a host copy: gloo takes the
    CPU tensors of every collective used here, so a CUDA tensor is copied to
    the host and back under gloo (the only backend that lets two ranks
    share one card); nccl works on the card."""
    return mesh.backend == "gloo" and t.device.type != "cpu"


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """``module``'s parameters and buffers broadcast from rank 0 (in place)."""
    if mesh.world == 1:
        return module
    tensors = [t for t in (*module.parameters(), *module.buffers()) if t.numel()]
    if not tensors:
        return module
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    buf = flat.cpu() if host_side(mesh, flat) else flat
    dist.broadcast(buf, src=0, group=mesh.group)
    flat = buf.to(flat.device)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return module
