"""The landmark group of a distributed window BA (port of
`viso_tpu/parallel/mesh.py`).

The reference lays a 1-D `landmark` axis over a JAX device mesh. Here the
group is the `torch.distributed` world, one rank per process: camera
blocks are replicated on every rank, the landmark dimension is cut into
one contiguous block per rank, in rank order, as `P(LANDMARK_AXIS)` cuts
it, and the reduced camera system is summed with `all_reduce`.

Without an initialized process group the world is one rank with no group:
its reduction is the identity and its block is the whole landmark range.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

LANDMARK_AXIS = "landmark"


@dataclass(frozen=True)
class Mesh:
    """The landmark group as one rank sees it. Hashable: solvers are
    cached per (mesh, params)."""

    group: Optional[object]   # a torch.distributed ProcessGroup, or None
    rank: int
    size: int
    device: torch.device


def make_mesh(num_devices: int | None = None, device="cuda") -> Mesh:
    """The whole `torch.distributed` world when it is initialized, else a
    world of one rank with no group; the problem lives on `device`.

    `num_devices` of 0, None or the world size gives the whole world. Any
    other value raises: a rank left outside a subgroup would still have
    to issue the subgroup's collectives in the same order as its members.
    """
    device = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if num_devices not in (None, 0, size):
        raise ValueError(
            f"mesh_devices={num_devices}: the landmark group is the whole "
            f"torch.distributed world (world size {size}); pass 0 or {size}"
        )
    return Mesh(group, rank, size, device)


def shard_landmarks(mesh: Mesh, num_landmarks: int) -> tuple[int, int]:
    """(start, stop) of this rank's landmark block. `num_landmarks` must be
    a multiple of the group size (`dist_ba.pad_landmarks`)."""
    if num_landmarks % mesh.size:
        raise ValueError(
            f"{num_landmarks} landmarks do not split over {mesh.size} ranks"
        )
    n = num_landmarks // mesh.size
    return mesh.rank * n, (mesh.rank + 1) * n


def replicated(mesh: Mesh, num_landmarks: int) -> tuple[int, int]:
    """(start, stop) of a replicated array: the whole range on every rank."""
    return 0, num_landmarks
