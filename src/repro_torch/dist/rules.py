"""Mesh rules of the sharded partitioner (counterpart of the partition
half of ``repro/dist/rules.py``; the language-model sharding rules wait
for the training slice).

The reference lays its shards on a 1-D device mesh with axis ``"shard"``
or a 2-D ``("coarse", "refine")`` mesh. The port runs one process (or
thread) per rank, so a mesh is the calling rank's ``Communicator``
viewed with that shape: ``partition_mesh(P)`` and
``partition_mesh2d(P1, P2)`` return it. The flat rank order of
``(P1, P2)`` is the row-major order of ``P1*P2``: rank ``c*P2 + j`` sits
at coarse row c, refine column j, as in the reference's
``reshape(p1, p2)`` of the first ``p1*p2`` devices.
"""
from __future__ import annotations

from .comm import Communicator, current

# the axis names of the reference's meshes, kept as the names of the
# port's mesh axes (stats and messages use them)
PARTITION_AXIS = "shard"
COARSE_AXIS = "coarse"
REFINE_AXIS = "refine"


def mesh_shape(devices) -> tuple[int, ...]:
    """``devices`` (an int P or a (P1, P2) pair) as a mesh shape."""
    if isinstance(devices, (tuple, list)):
        shape = tuple(int(d) for d in devices)
        if len(shape) != 2:
            raise ValueError(
                f"devices tuple must be (P1, P2), got {devices!r}")
        if min(shape) < 1:
            raise ValueError(f"devices must be >= 1, got {devices!r}")
        return shape
    P = int(devices)
    if P < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    return (P,)


def mesh_size(devices) -> int:
    """Number of ranks of the mesh ``devices``."""
    return _prod(mesh_shape(devices))


def _prod(shape) -> int:
    size = 1
    for s in shape:
        size *= s
    return size


def comm_for(devices) -> Communicator | None:
    """The calling rank's communicator viewed as the mesh ``devices``, or
    None when the caller is not a rank (the entry point then launches the
    ranks itself).

    Raises:
        ValueError: the caller is a rank of a group whose size is not the
            mesh's.
    """
    shape = mesh_shape(devices)
    comm = current()
    if comm is None:
        return None
    if comm.size != _prod(shape):
        raise ValueError(
            f"devices={devices!r} needs {_prod(shape)} ranks, but this "
            f"process group has {comm.size}; call with devices="
            f"{comm.size} (or a (P1, P2) of that product)")
    return comm.with_shape(shape)


def partition_mesh(devices: int | None = None) -> Communicator:
    """The 1-D ``"shard"`` mesh over the calling rank's group
    (``devices=None``: the whole group)."""
    comm = current()
    if comm is None:
        raise RuntimeError("partition_mesh: the caller is not a rank; run "
                           "inside torchrun or dist.launch")
    return comm_for(comm.size if devices is None else int(devices))


def partition_mesh2d(p1: int, p2: int) -> Communicator:
    """The 2-D ``("coarse", "refine")`` mesh over the calling rank's
    group, row-major: the flat order is ``partition_mesh(p1 * p2)``'s."""
    p1, p2 = int(p1), int(p2)
    if p1 < 1 or p2 < 1:
        raise ValueError(f"mesh extents must be >= 1, got ({p1}, {p2})")
    if current() is None:
        raise RuntimeError("partition_mesh2d: the caller is not a rank; "
                           "run inside torchrun or dist.launch")
    return comm_for((p1, p2))
