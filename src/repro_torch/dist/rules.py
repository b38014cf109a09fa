"""Mesh rules (reference: ``repro/dist/rules.py``): the sharded
partitioner's meshes, and the language model's logical-axis sharding
rules.

**Language model.** Model and training code name each tensor's axes
logically (``act_batch``, ``embed``, ``expert``, ...); ``resolve_rules``
maps them to mesh axes (``None`` = replicated) for a phase in {"train",
"prefill", "decode", "long_decode"}: the reference's table, its phase
rule (FSDP of ``embed`` over ``data`` in train), its drop of batch
parallelism when the batch does not divide, the per-arch overrides
(``configs.sharding_overrides``) and its drop of axes the mesh lacks.
The mesh is ``launch.mesh.Mesh``: a ``(data, model)`` mesh of ranks,
each holding its own rows and shards. ``Rules.shard`` checks the names
against the tensor's rank and returns it: a rank's activation is already
its shard, and what GSPMD's constraints would move the port moves
explicitly, ``Rules.reduce`` summing over the mesh axes of a logical axis
(``act_batch``: the data ranks, or ``pod`` x ``data`` on a multi-pod
mesh), and ``dist.fsdp`` gathering the leaves sharded over ``data``.
The layers sharded over ``model`` take one decision,
``splits`` (a dimension is held as one shard a rank where the extent
divides it, whole elsewhere), and with it ``local_range`` (the rank's
slice) and three differentiable moves between the three kinds of
tensor a model rank holds (whole and the same on every rank; the
rank's own part; a partial sum), each the identity where the dimension
is held whole:

* ``reduce_partial``: a product that contracted a split dimension, its
  partial sums all-reduced; the backward is the identity (the gradient
  of the whole value is every rank's, whole);
* ``enter_split``: a whole value about to feed the rank's part of a
  split computation, as it is; the backward all-reduces its gradient,
  which each rank's part gives only a share of (Megatron's "copy to the
  tensor-parallel region"). It goes on each such edge, after any
  computation shared by whole and split branches, never on a block's
  input where a whole branch also reads it;
* ``gather_split``: the ranks' parts all-gathered; the backward keeps
  the rank's slice of the gradient (whole on every rank, since every
  value computed from the gathered one is whole or entered).

With every such edge entered, the gradient of every whole value is the
same bits on every model rank and each split leaf's is its own shard's:
training needs no reduction of gradients over ``model``.
``Rules.sharding`` / ``param_shardings`` give ``NamedSharding``
objects: the rank's ``device`` (where ``CheckpointManager.restore``
places a leaf), the rank's ``shard_shape`` of a leaf, its slice
(``local``) and, from every rank's slice, the whole leaf (``whole``),
split where the extent divides the dimension and whole elsewhere
(``Rules.shard``'s rule in the reference).

**Partitioner.** The reference lays its shards on a 1-D device mesh
with axis ``"shard"`` or a 2-D ``("coarse", "refine")`` mesh. The port
runs one process (or thread) per rank, so a mesh is the calling rank's
``Communicator`` viewed with that shape: ``partition_mesh(P)`` and
``partition_mesh2d(P1, P2)`` return it. The flat rank order of
``(P1, P2)`` is the row-major order of ``P1*P2``: rank ``c*P2 + j`` sits
at coarse row c, refine column j, as in the reference's
``reshape(p1, p2)`` of the first ``p1*p2`` devices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

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


# ---------------------------------------------------------------------------
# language-model sharding rules
# ---------------------------------------------------------------------------

# mesh axis aliases
_DATA = "data"
_MODEL = "model"
_POD = "pod"


def _batch_axes(mesh):
    if _POD in mesh.axis_names:
        return (_POD, _DATA)
    return _DATA


def _default_table(mesh, phase: str) -> dict:
    batch = _batch_axes(mesh)
    table: dict[str, Any] = {
        # --- activations
        "act_batch": batch,
        "act_seq": None,            # flash path q-chunks when seq unsharded
        "act_res_seq": None,        # residual-stream sequence axis
        "logits_seq": None,
        "act_embed": None,
        "act_mlp": _MODEL,
        "act_heads": _MODEL,
        "act_kv": _MODEL,
        "act_vocab": _MODEL,
        "act_e_embed": None,
        # --- caches
        "cache_seq": None,
        "cache_kv": _MODEL,
        # --- params
        "repeat": None,             # stacked-layer leading axis
        "nil": None,
        "embed": _DATA if phase == "train" else None,   # FSDP in train
        "mlp": _MODEL,
        "heads": _MODEL,
        "heads_joined": _MODEL,
        "kv_heads": _MODEL,
        "head_dim": None,
        "vocab": _MODEL,
        "rank": None,
        "state": None,
        "conv": None,
        "expert": _MODEL,
        "e_embed": None,
        "e_mlp": None,
        "codebooks": None,
    }
    return table


def _axis_extent(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    ext = 1
    for a in axes:
        ext *= mesh.shape[a]
    return ext


def axes_of(axis) -> tuple:
    """The mesh axis names of a ``split_dims`` entry (a name or a tuple
    of names) as a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _split_axes(mesh, axes) -> tuple:
    """The mesh axes of a spec entry whose extent is above 1."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        axes = (axes,)
    return tuple(a for a in axes if mesh.shape[a] > 1)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: the mesh and its partition spec (a tuple of
    mesh axes or None, one a dim)."""
    mesh: Any
    spec: tuple

    @property
    def device(self):
        return self.mesh.device

    def split_dims(self, shape) -> list:
        """(dim, mesh axes) of each dimension of a leaf of ``shape`` that
        is held as one shard a rank: its spec names mesh axes of extent
        above 1 whose product divides it. The axes are one name, or a
        tuple of names for a dimension split over several (``("pod",
        "data")``: one shard a rank of their product, in the row-major
        order of the rank's coordinates on them, pod-major as jax lays
        out ``P(("pod", "data"))``). A dimension the extent does not
        divide is held whole."""
        out = []
        for dim, (n, axes) in enumerate(zip(shape, self.spec)):
            split = _split_axes(self.mesh, axes)
            if split and n % _axis_extent(self.mesh, split) == 0:
                out.append((dim, split[0] if len(split) == 1 else split))
        return out

    def shard_shape(self, shape) -> tuple:
        """The shape of a rank's shard of a leaf of ``shape``."""
        shape = list(shape)
        for dim, axis in self.split_dims(shape):
            shape[dim] //= _axis_extent(self.mesh, axis)
        return tuple(shape)

    def local(self, x):
        """This rank's shard of the whole leaf ``x`` (a view)."""
        for dim, axis in self.split_dims(x.shape):
            part = x.shape[dim] // _axis_extent(self.mesh, axis)
            x = x.narrow(dim, self.mesh.coordinate(axis) * part, part)
        return x

    def whole(self, x, shape):
        """The whole leaf of ``shape`` from this rank's shard ``x``: each
        split dimension all-gathered over its mesh axis, in dimension
        order (no gradient; every rank of those axes calls it)."""
        x = x.detach()
        for dim, axis in self.split_dims(shape):
            x = self.mesh.axis_comm(axis).gather_along(x, dim)
        return x


@dataclasses.dataclass(frozen=True)
class Rules:
    """Resolved logical -> mesh table for one (mesh, config, phase)."""
    mesh: Any
    table: Mapping[str, Any]
    phase: str = "train"

    def spec(self, *logical) -> tuple:
        """Partition spec of a tuple of logical axis names (None entries
        and unknown names are replicated), a one-axis tuple written as
        its axis (as ``jax.sharding.PartitionSpec`` holds it)."""
        def entry(name):
            axes = self.table.get(name) if name is not None else None
            return axes[0] if isinstance(axes, tuple) and len(axes) == 1 \
                else axes
        return tuple(entry(name) for name in logical)

    def sharding(self, logical) -> NamedSharding:
        """The sharding of a logical-axis tuple (e.g. a param spec)."""
        return NamedSharding(self.mesh, self.spec(*logical))

    def shard(self, x, *logical):
        """``x`` under the resolved sharding: the names must match
        ``x.ndim``. A rank holds its own shard of every activation, so
        that is ``x`` itself."""
        assert len(logical) == x.ndim, (
            f"{len(logical)} logical names for rank-{x.ndim} tensor")
        return x

    def extent(self, logical: str) -> int:
        """The number of ranks the logical axis is split over."""
        return _axis_extent(self.mesh, self.table.get(logical))

    def comm(self, logical: str):
        """The communicator over exactly the mesh axes of ``logical``
        (``act_batch`` on ``(pod, data, model)``: the ``pod`` x ``data``
        ranks of this rank's ``model`` coordinate, pod-major); None when
        they have one rank between them."""
        split = _split_axes(self.mesh, self.table.get(logical))
        return self.mesh.axis_comm(split) if split else None

    def reduce(self, x, logical: str, op: str = "sum"):
        """``x`` reduced over the mesh axes of the logical axis
        ``logical``: the sum GSPMD inserts where a value computed from a
        rank's shard of that axis is used whole (``act_batch``: the data
        ranks' loads, losses and gradients; ``heads``, ``mlp``,
        ``expert``, ``vocab``: the partial sums of a product over a split
        dimension, ``reduce_partial``). ``x`` itself when every one of
        those extents is 1."""
        comm = self.comm(logical)
        return x if comm is None else comm.all_reduce(x, op)


def splits(rules: Rules | None, logical: str, n: int) -> bool:
    """The one decision of every sharded layer: whether a dimension of
    size ``n`` named ``logical`` is held as one shard a rank
    (``NamedSharding.split_dims``' rule: an extent above 1 that divides
    ``n``), the same on every rank; False without rules (one rank)."""
    return rules is not None and bool(
        rules.sharding((logical,)).split_dims((n,)))


def local_range(rules: Rules | None, logical: str, n: int):
    """This rank's index range ``[lo, hi)`` of a dimension of size ``n``
    named ``logical``: its shard's where the dimension is split
    (``splits``), ``(0, n)`` where it is held whole or without rules."""
    if not splits(rules, logical, n):
        return 0, n
    (_, axis), = rules.sharding((logical,)).split_dims((n,))
    part = n // _axis_extent(rules.mesh, axis)
    lo = rules.mesh.coordinate(axis) * part
    return lo, lo + part


class _ReducePartial(torch.autograd.Function):
    """The sum of every rank's partial sums ``x``; the gradient of the
    whole sum, whole on every rank, is each partial sum's."""

    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _EnterSplit(torch.autograd.Function):
    """``x`` as it is; its gradient, of which each rank's part of the
    computation gives a share, summed over the ranks."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad), None


class _GatherSplit(torch.autograd.Function):
    """Every rank's part ``x`` concatenated along ``dim``; the gradient,
    whole on every rank, sliced to the rank's part."""

    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim, ctx.n = comm, dim, x.shape[dim]
        return comm.gather_along(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.comm.rank * ctx.n, ctx.n), None, \
            None


def reduce_partial(x, rules: Rules | None, logical: str, n: int):
    """``x``, a product that contracted a dimension of size ``n`` named
    ``logical``: where that dimension is split (``splits``), the rank's
    partial sums, all-reduced once over its mesh axes (``Rules.reduce``'s
    collective; the backward is the identity); where it is held whole,
    every rank's whole result, returned as it is (a reduction there would
    multiply it by the extent)."""
    if not splits(rules, logical, n):
        return x
    return _ReducePartial.apply(x, rules.comm(logical))


def enter_split(x, rules: Rules | None, logical: str, n: int):
    """``x``, whole and the same on every rank, where it feeds the rank's
    part of a computation split over a dimension of size ``n`` named
    ``logical``: ``x`` itself, whose gradient is all-reduced over the
    split mesh axes in the backward. ``x`` itself, with no autograd node,
    where the dimension is held whole or no gradient flows (serving)."""
    if not (splits(rules, logical, n) and torch.is_grad_enabled()
            and x.requires_grad):
        return x
    return _EnterSplit.apply(x, rules.comm(logical))


def gather_split(x, rules: Rules | None, logical: str, n: int, dim: int):
    """``x`` whole along ``dim``: the ranks' shards of a dimension of size
    ``n`` named ``logical`` all-gathered where it is split (exact, in rank
    order; the backward keeps the rank's slice of the gradient), ``x``
    itself where it is held whole."""
    if not splits(rules, logical, n):
        return x
    return _GatherSplit.apply(x, rules.comm(logical), dim)


def resolve_rules(mesh, cfg, phase: str, batch_size: int | None = None,
                  overrides: Mapping[str, Any] | None = None) -> Rules:
    """The sharding rules of ``phase`` on ``mesh`` (``launch.mesh.Mesh``).

    ``batch_size``: when given and not divisible by the batch axes'
    extent, batch data-parallelism is dropped. ``overrides``: {logical:
    mesh_axes} merged last (``configs.sharding_overrides``). Mesh axes the
    mesh does not have are dropped.
    """
    if phase not in ("train", "prefill", "decode", "long_decode"):
        raise ValueError(f"unknown phase {phase!r}")
    table = _default_table(mesh, phase)
    if batch_size is not None:
        ext = _axis_extent(mesh, table["act_batch"])
        if ext > 1 and batch_size % ext != 0:
            table["act_batch"] = None
    if overrides:
        table.update(overrides)
    names = set(mesh.axis_names)

    def known(axes):
        if axes is None:
            return None
        if isinstance(axes, str):
            return axes if axes in names else None
        kept = tuple(a for a in axes if a in names)
        return kept if kept else None

    table = {k: known(v) for k, v in table.items()}
    return Rules(mesh=mesh, table=table, phase=phase)


def param_shardings(rules: Rules, logical_specs):
    """A tree of logical-axis tuples -> the tree of their shardings."""
    if isinstance(logical_specs, dict):
        return {k: param_shardings(rules, v)
                for k, v in logical_specs.items()}
    return rules.sharding(logical_specs)
