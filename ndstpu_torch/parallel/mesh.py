"""The shard axis as a rank count (``ndstpu.parallel.mesh``).

The JAX package distributes over a 1-D device mesh whose axis is named
``"shards"``.  The port's counterpart is the ranks of a
``torch.distributed`` process group: :func:`make_mesh` returns a
:class:`Mesh` of ``n`` ranks, where ``n`` may not exceed the world size of
the initialized group (1 when there is none).  Nothing here initializes a
group; the session's out-of-core path uses ``make_mesh(1)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

SHARD_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_dev`` ranks along the one shard axis; this process is
    ``rank``."""

    n_dev: int
    rank: int = 0
    axis: str = SHARD_AXIS

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)


def world_size() -> int:
    """The world size of the initialized ``torch.distributed`` group, or
    1 when there is none."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def make_mesh(n_devices: Optional[int] = None,
              axis: str = SHARD_AXIS) -> Mesh:
    n = world_size()
    want = n_devices or n
    if want > n:
        raise ValueError(f"requested {want} devices, have {n}")
    rank = 0
    if n > 1:
        import torch.distributed as dist
        rank = int(dist.get_rank())
    return Mesh(int(want), rank, axis)


def default_mesh() -> Mesh:
    return make_mesh()
