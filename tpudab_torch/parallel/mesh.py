"""The ensemble x time mesh on a torch.distributed world (counterpart of
tpudab.parallel.mesh).

Rank r of a world of n_e * n_t processes sits at (e, t) = divmod(r, n_t),
the row-major order of tpudab's device array reshaped to (ensemble, time).
Its time group holds the n_t ranks of its ensemble row (the halo ring);
its ensemble group holds the n_e ranks of its time column.

The mesh says where a rank sits, not where it computes: the compute
device is the caller's (ShardedReceiveStep's `device`), and the transport
is the group's own backend, read once here. So two ranks may share one
card over gloo, which init_device_mesh("cuda", ...) would refuse: it
picks NCCL and sets each rank's device from its rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Factor n_devices into (ensemble, time).

    Prefer more ensemble parallelism (zero-communication) and keep a time
    axis of at least 2 when possible so the halo path is exercised.
    """
    if n_devices == 1:
        return (1, 1)
    time = 2
    while n_devices % time:
        time += 1
    return (n_devices // time, time)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the (ensemble, time) mesh and its groups."""

    shape: Tuple[int, int]
    rank: int
    time_group: dist.ProcessGroup
    ensemble_group: dist.ProcessGroup
    backend: str          # the time group's, which carries the halo

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.shape[1])

    def rank_at(self, e: int, t: int) -> int:
        return e * self.shape[1] + t


def make_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """The mesh of the initialised default world, shape (ensemble, time)
    (default_mesh_shape of the world size by default). Every rank must
    call it, in the same order as its other group creations: each group is
    made by all ranks (dist.new_group)."""
    n = dist.get_world_size()
    shape = tuple(shape) if shape is not None else default_mesh_shape(n)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} does not hold the world's {n} ranks")
    n_e, n_t = shape
    rank = dist.get_rank()
    time_group = ensemble_group = None
    for e in range(n_e):
        g = dist.new_group([e * n_t + t for t in range(n_t)])
        if rank // n_t == e:
            time_group = g
    for t in range(n_t):
        g = dist.new_group([e * n_t + t for e in range(n_e)])
        if rank % n_t == t:
            ensemble_group = g
    return Mesh(shape, rank, time_group, ensemble_group, dist.get_backend(time_group))
