"""The training mesh (reference: ``repro/launch/mesh.py``).

The reference lays a ``(data, model)`` mesh over its devices. The port
runs one process (or thread) per rank: a ``Mesh`` names its axes and
their extents, holds the rank's device and, inside a rank, the rank's
communicator viewed with the mesh's shape (``Mesh.comm``). Rank order is
row-major over the axes, as ``jax.make_mesh`` lays the first devices:
the rank at ``(d, m)`` of a ``(data, model)`` mesh is ``d * model + m``.
``Mesh.axis_comm(name)`` is the communicator along one axis, or over a
set of axes (the ranks that share every other coordinate, in the
row-major order of their coordinates on those axes: over ``("pod",
"data")``, pod-major, as jax lays out ``P(("pod", "data"))``), and
``Mesh.coordinate`` a rank's index there.

``make_production_mesh`` is the reference's production mesh: the pod's
``(data, model)`` = 16 x 16 and, with ``multi_pod``, 2 x 16 x 16 over
``(pod, data, model)``. The dry run (``launch/dryrun.py``) traces one
rank of it on ``meta`` tensors, its communicator a
``dist.comm.meta_communicator``.

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
from repro_torch.dist.comm import Communicator, current


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
        """The calling rank's communicator viewed as this mesh (its
        extents, row-major), or None for a one-rank mesh (the
        single-device path, in a rank or not).

        Raises:
            RuntimeError: a mesh of several ranks used outside a rank.
            ValueError: the caller's group has another size than the
                mesh.
        """
        if self.size == 1:
            return None
        comm = current()
        if comm is None:
            raise RuntimeError(
                f"a {self.shape} mesh is used outside a rank: run inside "
                f"the ranks of dist.launch (or torchrun) of {self.size} "
                f"ranks")
        if comm.size != self.size:
            raise ValueError(f"a {self.shape} mesh needs {self.size} "
                             f"ranks, but this process group has "
                             f"{comm.size}")
        return comm.with_shape(self.extents)

    def _axes(self, names) -> tuple:
        return (names,) if isinstance(names, str) else tuple(names)

    def extent(self, names) -> int:
        """The number of ranks over axis ``names`` (a name, or a tuple of
        names: the product of their extents)."""
        n = 1
        for name in self._axes(names):
            n *= self.shape[name]
        return n

    def axis_comm(self, names) -> Communicator | None:
        """The communicator over axis ``names`` (a name or a tuple of
        names): the ranks that share this rank's coordinates on every
        other axis, in the row-major order of their coordinates on
        ``names`` (``Communicator.axes_group``); None when ``names`` hold
        one rank between them (nothing to reduce over)."""
        names = self._axes(names)
        if self.extent(names) == 1:
            return None
        comm = self.comm
        if self.extent(names) == self.size:
            return comm.with_shape((self.size,))
        return comm.axes_group(self.axis_names.index(n) for n in names)

    def coordinate(self, names) -> int:
        """This rank's index over axis ``names`` (a name, or a tuple of
        names: row-major over them, the first outermost), 0 on a one-rank
        mesh."""
        comm = self.comm
        if comm is None:
            return 0
        coords = comm.coords
        i = 0
        for name in sorted(self._axes(names), key=self.axis_names.index):
            i = i * self.shape[name] + coords[self.axis_names.index(name)]
        return i


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


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production mesh on ``device`` (default ``cuda``;
    the dry run's ``meta``): one pod of 16 x 16 ranks over ``(data,
    model)`` or, with ``multi_pod``, 2 x 16 x 16 over ``(pod, data,
    model)``, the ``pod`` axis carrying data parallelism across pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)
