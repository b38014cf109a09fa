"""The training mesh (reference: ``repro/launch/mesh.py``).

The reference lays a ``(data, model)`` mesh over its devices. The port
runs one process (or thread) per rank: a ``Mesh`` names its axes and
their extents, holds the rank's device and, inside a rank, the rank's
communicator viewed with the mesh's shape (``Mesh.comm``). Rank order is
row-major over the axes, as ``jax.make_mesh`` lays the first devices:
the rank at ``(d, m)`` of a ``(data, model)`` mesh is ``d * model + m``.
``Mesh.axis_comm(name)`` is the communicator along one axis (the ranks
that share every other coordinate).

``make_host_mesh(data, model)`` is the ``(data, model)`` mesh of any
shape: serving and training shard attention, the MLPs, the experts, the
SSM layers and the vocabulary over ``model`` and the batch over ``data``
(training also FSDP of the ``embed`` leaves over ``data``).
``make_mesh`` is the reference's
``make_compat_mesh``: any shape, for callers that shard over one axis
and replicate over the others (``make_distributed_partitioner``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device
from repro_torch.dist.comm import Communicator
from repro_torch.dist.rules import comm_for


@dataclass(frozen=True)
class Mesh:
    """Axis names, their extents (``shape``: name -> extent, as the
    reference's ``Mesh.shape``) and the device of this rank."""
    axis_names: tuple[str, ...]
    extents: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.extents))

    @property
    def size(self) -> int:
        n = 1
        for e in self.extents:
            n *= e
        return n

    @property
    def comm(self) -> Communicator | None:
        """The calling rank's communicator viewed as this mesh (1-D for a
        one-axis mesh, else ``(extents[0], prod(extents[1:]))``), or None
        for a one-rank mesh (the single-device path, in a rank or not).

        Raises:
            RuntimeError: a mesh of several ranks used outside a rank.
            ValueError: the caller's group has another size than the
                mesh (``dist.rules.comm_for``).
        """
        if self.size == 1:
            return None
        view = (self.size,) if len(self.extents) == 1 else \
            (self.extents[0], self.size // self.extents[0])
        comm = comm_for(view)
        if comm is None:
            raise RuntimeError(
                f"a {self.shape} mesh is used outside a rank: run inside "
                f"the ranks of dist.launch (or torchrun) of {self.size} "
                f"ranks")
        return comm

    def axis_comm(self, name: str) -> Communicator | None:
        """The communicator along axis ``name`` (its extent's ranks that
        share this rank's other coordinates), or None when its extent is
        1 (nothing to reduce over)."""
        if self.shape[name] == 1:
            return None
        if len(self.extents) > 2 and self.shape[name] != self.size:
            raise ValueError(f"axis groups of a mesh of more than two "
                             f"axes ({self.shape}) are not supported")
        comm = self.comm
        if len(self.extents) == 1 or self.shape[name] == self.size:
            return comm.axis_group(0) if len(comm.shape) == 1 else \
                comm.with_shape((self.size,))
        return comm.axis_group(self.axis_names.index(name))

    def coordinate(self, name: str) -> int:
        """This rank's index along axis ``name`` (0 on a one-rank mesh)."""
        comm = self.comm
        if comm is None:
            return 0
        i = self.axis_names.index(name)
        inner = 1
        for e in self.extents[i + 1:]:
            inner *= e
        return comm.rank // inner % self.extents[i]


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A mesh of ``shape`` (extents) over ``axis_names`` on ``device``
    (default ``cuda``): the reference's ``make_compat_mesh``."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} over axes {axis_names}")
    return Mesh(axis_names, shape, resolve_device(device))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh on ``device`` (default ``cuda``):
    ``data`` data-parallel ranks times ``model`` tensor-parallel ranks,
    row-major (the rank at ``(d, m)`` is ``d * model + m``), the calling
    rank's communicator bound where the mesh is used (``Mesh.comm``).
    Serving and training run on any such mesh.

    Raises:
        ValueError: ``data`` or ``model`` below 1.
    """
    if int(data) < 1 or int(model) < 1:
        raise ValueError(f"data and model must be >= 1, got ({data}, "
                         f"{model})")
    return make_mesh((int(data), int(model)), ("data", "model"), device)
