"""The communicator of the multi-device path: what the reference's
``axis_name`` is under ``shard_map``.

A ``Communicator`` holds one rank's process group, its rank, the world
size, the mesh shape (``(P,)``, ``(P1, P2)`` or more axes, row-major)
and the subgroups along its axes (``axis_group``: the row of a rank, or
its column; ``axes_group``: the ranks that share every coordinate but
those of a set of axes). It offers the reductions of the paper's communication
discipline (§4.1), ``all_reduce(x, "sum" | "min" | "max")``, plus the
shard id (the reference's ``axis_index``), and the collectives that move
data: ``all_gather`` and ``all_to_all``, the reference's ``all_gather``
and ``all_to_all`` of the SFC redistribution
(``core.partitioner._sfc_redistribute``, the sample sort under
``make_distributed_partitioner``), and ``gather_along`` /
``reduce_scatter``, the all-gather of a data-parallel shard and the sum
of its gradient that GSPMD inserts around an FSDP leaf
(``dist.fsdp``). The rank order of ``(P1, P2)`` is the row-major flat
order of ``P1*P2`` (``jax.make_mesh``'s order of the first ``P1*P2``
devices), so a collective over the whole mesh runs over the same group
in the same order as the flat mesh's and gives the same bits.

``current()`` is the communicator of the calling rank: the one a
launcher (``dist.launch``) or a ``using(comm)`` block made active in
this thread, else one over the default process group when the caller
initialized it (as under ``torchrun``), else None: no rank, the
single-device path.

``meta_communicator`` is one rank of a mesh traced alone on ``meta``
tensors (the dry run): its group and every subgroup it makes are
``MetaGroup``s, whose collectives complete at once and append ``(kind,
bytes, group size)`` to one log, the bytes as ``counters`` counts them.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.distributed as tdist

OPS = ("sum", "min", "max")


class CancelledError(RuntimeError):
    """A collective ended because another rank failed."""


#: the collectives ``counters()`` counts apart: (kind, its count's key)
KINDS = (("all_reduce", "all_reduces"), ("all_gather", "all_gathers"),
         ("all_to_all", "all_to_alls"), ("reduce_scatter", "reduce_scatters"))

#: (backend, device type) pairs whose process group reduce-scatters
#: natively; elsewhere ``reduce_scatter`` all-reduces the whole tensor and
#: keeps the rank's chunk (the same sums: one value a rank an element).
#: gloo (torch 2.11) reduce-scatters CUDA tensors and CPU ones, but its
#: work does not report completion before ``wait`` (``is_completed``
#: stays False), which the cancellable wait of thread ranks (CPU tensors
#: only) polls: on the CPU, gloo all-reduces instead.
NATIVE_REDUCE_SCATTER = {("nccl", "cuda"), ("gloo", "cuda")}


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _reduce_op(op: str):
    return {"sum": tdist.ReduceOp.SUM, "min": tdist.ReduceOp.MIN,
            "max": tdist.ReduceOp.MAX}[op]


class _Shared:
    """What the views of one rank's group share: the collective counters
    (calls, host seconds, bytes of each kind) and the subgroups along the
    axes of each mesh shape, made once per (shape, axes); and the
    counters of every collective of the rank, its subgroups' included
    (``rank_counts``, shared with the subgroups)."""

    def __init__(self, subgroup_factory, cancel=None, rank_counts=None):
        self.subgroup_factory = subgroup_factory
        self.cancel = cancel
        self.subgroups: dict = {}
        self.counts = {kind: [0, 0.0, 0] for kind, _ in KINDS}
        self.rank_counts = {kind: [0, 0.0, 0] for kind, _ in KINDS} \
            if rank_counts is None else rank_counts

    def finish(self, kind: str, work, t0: float, nbytes: int) -> None:
        """Wait for ``work`` (a collective started at ``t0``) and count it.
        With ``cancel`` set by a failing thread rank, leave at once with
        ``CancelledError``."""
        if self.cancel is not None:
            while not work.is_completed():
                if self.cancel.is_set():
                    raise CancelledError("another rank of the launch "
                                         "failed")
                time.sleep(2e-5)
        work.wait()
        seconds = time.perf_counter() - t0
        for counts in (self.counts, self.rank_counts):
            count = counts[kind]
            count[0] += 1
            count[1] += seconds
            count[2] += nbytes


class Communicator:
    """One rank's view of a process group as a device mesh.

    Args:
        group: a ``torch.distributed`` process group (``ProcessGroup`` or
            a backend group such as ``ProcessGroupGloo``); collectives go
            through its ``allreduce`` method.
        rank, size: this rank and the group's size.
        backend: ``"gloo"`` or ``"nccl"``.
        shape: mesh shape, ``(size,)`` or ``(P1, P2)`` with
            ``P1 * P2 == size``.
        subgroup_factory: ``fn(ranks) -> group`` making the subgroup of
            the given flat ranks; every rank calls it for every coarse row
            in the same order (``torch.distributed.new_group``'s rule).
        cancel: a ``threading.Event`` that ends a pending all-reduce
            with ``CancelledError`` once set (ranks that are threads of
            one process: a failing rank sets it, so the others do not
            wait for their collectives' timeout).
        device_type: the device type the collectives run as where it is
            not the tensors' own (a ``MetaGroup``'s ``meta`` tensors
            stand for the card's: ``"cuda"``); None: the tensors'.
    """

    def __init__(self, group, rank: int, size: int, *, backend: str,
                 shape=None, subgroup_factory=None, cancel=None,
                 device_type=None, _shared=None):
        shape = (int(size),) if shape is None else tuple(int(s)
                                                         for s in shape)
        if not shape or min(shape) < 1 or _prod(shape) != size:
            raise ValueError(f"mesh shape {shape} does not cover "
                             f"{size} ranks")
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.backend = backend
        self.shape = shape
        self.device_type = device_type
        self._shared = _shared or _Shared(subgroup_factory, cancel)

    @property
    def shard_id(self) -> int:
        """This rank's flat index in the mesh (``axis_index`` over the
        whole mesh)."""
        return self.rank

    @property
    def coarse_index(self) -> int:
        return self.rank // self.shape[-1] if len(self.shape) == 2 else 0

    @property
    def refine_index(self) -> int:
        return self.rank % self.shape[-1] if len(self.shape) == 2 \
            else self.rank

    @property
    def coords(self) -> tuple:
        """This rank's coordinates on the mesh's axes (row-major)."""
        out, r = [], self.rank
        for extent in reversed(self.shape):
            out.append(r % extent)
            r //= extent
        return tuple(reversed(out))

    def with_shape(self, shape) -> "Communicator":
        """The same ranks viewed as mesh ``shape`` (counters shared)."""
        return Communicator(self.group, self.rank, self.size,
                            backend=self.backend, shape=shape,
                            device_type=self.device_type,
                            _shared=self._shared)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The reduction of ``x`` over every rank of the group, as a new
        tensor (``x`` is left as it is): ``psum`` / ``pmin`` / ``pmax``.
        Boolean tensors are reduced as int32 and come back boolean."""
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        was_bool = x.dtype == torch.bool
        out = (x.to(torch.int32) if was_bool else x).clone().contiguous()
        opts = tdist.AllreduceOptions()
        opts.reduceOp = _reduce_op(op)
        t0 = time.perf_counter()
        work = self.group.allreduce([out], opts)
        self._shared.finish("all_reduce", work, t0, _nbytes(out))
        return out.bool() if was_bool else out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: [P, *x.shape] (the
        reference's ``all_gather`` with ``tiled=False``). Boolean tensors
        travel as uint8 and come back boolean. Bytes counted: this rank's
        ``x``."""
        was_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if was_bool else x).contiguous()
        outs = [torch.empty_like(src) for _ in range(self.size)]
        t0 = time.perf_counter()
        work = self.group.allgather([outs], [src])
        self._shared.finish("all_gather", work, t0, _nbytes(src))
        out = torch.stack(outs)
        return out.bool() if was_bool else out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Dim 0 of ``x`` split into P equal chunks, chunk j sent to rank
        j; the chunks received, concatenated in rank order (the
        reference's ``all_to_all(split_axis=0, concat_axis=0,
        tiled=False)`` over a leading axis of P). Boolean tensors travel
        as uint8. Bytes counted: this rank's ``x``.

        Raises:
            ValueError: dim 0 is not a multiple of P.
        """
        if x.dim() == 0 or x.shape[0] % self.size:
            raise ValueError(f"all_to_all splits dim 0 into {self.size} "
                             f"equal chunks; got shape {tuple(x.shape)}")
        was_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if was_bool else x).contiguous()
        out = torch.empty_like(src)
        t0 = time.perf_counter()
        work = self.group.alltoall_base(out, src, [], [],
                                        tdist.AllToAllOptions())
        self._shared.finish("all_to_all", work, t0, _nbytes(src))
        return out.bool() if was_bool else out

    def gather_along(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (the whole of a leaf held as one shard a rank). Bytes counted:
        this rank's ``x``, as ``all_gather``'s."""
        src = x.contiguous()
        outs = [torch.empty_like(src) for _ in range(self.size)]
        t0 = time.perf_counter()
        work = self.group.allgather([outs], [src])
        self._shared.finish("all_gather", work, t0, _nbytes(src))
        return torch.cat(outs, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of ``x`` over the ranks, this rank's chunk of it along
        ``dim`` (chunk r of P equal ones for rank r): the gradient of a
        shard that ``gather_along`` made whole. Natively where the backend
        has it for the device (``NATIVE_REDUCE_SCATTER``), else the whole
        sum by ``all_reduce`` (counted there) and its chunk. Bytes
        counted: ``x``'s.

        Raises:
            ValueError: ``x.shape[dim]`` is not a multiple of P.
        """
        n = x.shape[dim]
        if n % self.size:
            raise ValueError(f"reduce_scatter splits dim {dim} of "
                             f"{tuple(x.shape)} into {self.size} chunks")
        part = n // self.size
        if (self.backend, self.device_type or x.device.type) not in \
                NATIVE_REDUCE_SCATTER:
            return self.all_reduce(x).narrow(dim, self.rank * part,
                                             part).contiguous()
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((part,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        t0 = time.perf_counter()
        # flat: dim 0's chunks are contiguous runs of the flat tensor
        work = self.group._reduce_scatter_base(
            out.view(-1), src.view(-1), tdist.ReduceScatterOptions())
        self._shared.finish("reduce_scatter", work, t0, _nbytes(src))
        return out.movedim(0, dim).contiguous()

    def axis_group(self, axis: int) -> "Communicator":
        """The ranks that share this rank's coordinates on every axis but
        ``axis`` of its mesh, as a 1-D communicator (the rank's index on
        ``axis`` is its rank there): on a ``(P1, P2)`` mesh, axis 1 is
        the rank's row (P2 ranks) and axis 0 its column (P1 ranks).
        ``axes_group((axis,))``."""
        if not 0 <= axis < len(self.shape):
            raise ValueError(f"mesh {self.shape} has no axis {axis}")
        return self.axes_group((axis,))

    def axes_group(self, axes) -> "Communicator":
        """The ranks that share this rank's coordinates on every axis of
        its mesh but ``axes``, as a 1-D communicator in the row-major
        order of their coordinates on ``axes`` (this rank's rank there is
        that order's index of its own): over the ``(pod, data)`` axes of
        a ``(pod, data, model)`` mesh, pod-major. Every rank of the mesh
        must call this at the same point of the program, as it may
        create the subgroups of those axes: each rank all of them, one a
        line, the lines in the row-major order of their other
        coordinates (``torch.distributed.new_group``'s rule). A mesh
        whose other extents are 1 is its own group (the counters shared,
        no subgroup made)."""
        shape = self.shape
        axes = tuple(sorted({int(a) for a in axes}))
        if not axes or not all(0 <= a < len(shape) for a in axes):
            raise ValueError(f"mesh {shape} has no axes {axes}")
        n = _prod(shape[a] for a in axes)
        if n == self.size:
            return self.with_shape((self.size,))
        others = tuple(a for a in range(len(shape)) if a not in axes)
        sh = self._shared
        key = (shape, axes)
        if key not in sh.subgroups:
            if sh.subgroup_factory is None:
                raise RuntimeError("this communicator cannot make "
                                   "subgroups")
            sh.subgroups[key] = [
                sh.subgroup_factory([_flat(shape, axes, others, i, j)
                                     for i in range(n)])
                for j in range(self.size // n)]
        coords = self.coords
        line = _index([coords[a] for a in others],
                      [shape[a] for a in others])
        index = _index([coords[a] for a in axes], [shape[a] for a in axes])
        return Communicator(sh.subgroups[key][line], index, n,
                            backend=self.backend, shape=(n,),
                            device_type=self.device_type,
                            _shared=_Shared(None, sh.cancel,
                                            sh.rank_counts))

    def refine_group(self) -> "Communicator":
        """The ranks of this rank's coarse row (the refine axis of a
        ``(P1, P2)`` mesh) as a communicator of size P2: ``axis_group(1)``.
        Every rank of the mesh must call this at the same point of the
        program, as it may create the subgroups."""
        if len(self.shape) != 2:
            raise ValueError(f"refine_group needs a (P1, P2) mesh, this "
                             f"one is {self.shape}")
        return self.axis_group(1)

    def counters(self, *, rank: bool = False) -> dict:
        """Collectives of this group so far, each kind apart: the
        all-reduces as ``{"all_reduces", "seconds", "bytes"}`` (host
        seconds inside ``all_reduce``), the others as ``"all_gathers"``,
        ``"all_gather_seconds"``, ``"all_gather_bytes"`` and the same for
        ``all_to_all`` and ``reduce_scatter``. ``rank``: every collective
        of the rank, those of the subgroups made from its group included
        (on a mesh of more than one axis of extent above 1, what the
        rank moves). Callers take the difference around the work they
        measure."""
        counts = self._shared.rank_counts if rank else self._shared.counts
        out = {}
        for kind, key in KINDS:
            calls, seconds, nbytes = counts[kind]
            prefix = "" if kind == "all_reduce" else f"{kind}_"
            out.update({key: calls, f"{prefix}seconds": seconds,
                        f"{prefix}bytes": nbytes})
        return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _index(coords, extents) -> int:
    """The row-major index of ``coords`` over ``extents``."""
    i = 0
    for c, e in zip(coords, extents):
        i = i * e + c
    return i


def _unindex(i: int, extents) -> list:
    """The coordinates of row-major index ``i`` over ``extents``."""
    out = []
    for e in reversed(extents):
        out.append(i % e)
        i //= e
    return out[::-1]


def _flat(shape, axes, others, i: int, j: int) -> int:
    """The flat rank of ``shape`` at index ``i`` over ``axes`` and ``j``
    over ``others`` (both row-major)."""
    coords = [0] * len(shape)
    for a, c in zip(axes, _unindex(i, [shape[a] for a in axes])):
        coords[a] = c
    for a, c in zip(others, _unindex(j, [shape[a] for a in others])):
        coords[a] = c
    return _index(coords, shape)


class _Done:
    """A collective that completed when it was started."""

    def is_completed(self) -> bool:
        return True

    def wait(self) -> bool:
        return True


class MetaGroup:
    """The process group of a rank traced alone (the dry run): the four
    calls a ``Communicator`` makes on its group, each complete at once
    with its outputs left as allocated, and each appended to ``log`` as
    ``(kind, bytes, group size)``, the bytes as ``counters`` counts them
    (the input's: an all-gather's own part, a reduce-scatter's whole
    operand)."""

    def __init__(self, size: int, log: list):
        self.size = int(size)
        self.log = log

    def _done(self, kind: str, x: torch.Tensor) -> _Done:
        self.log.append((kind, _nbytes(x), self.size))
        return _Done()

    def allreduce(self, tensors, opts=None):
        return self._done("all_reduce", tensors[0])

    def allgather(self, outputs, inputs):
        return self._done("all_gather", inputs[0])

    def alltoall_base(self, out, src, *args):
        return self._done("all_to_all", src)

    def _reduce_scatter_base(self, out, src, opts=None):
        return self._done("reduce_scatter", src)


def meta_communicator(shape, rank: int, *, backend: str = "nccl",
                      device_type: str | None = "cuda"):
    """Rank ``rank`` of a mesh of ``shape`` traced alone: (its
    communicator over a ``MetaGroup``, the log every collective of it
    and of every subgroup it makes appends to). Bound with ``using``, it
    is the rank's ``current()``: the ``Communicator`` code runs
    unchanged, its outputs allocated as a real rank's are. ``backend``
    and ``device_type`` name the deployment it stands for (the card's
    ``nccl``; ``("gloo", None)``: CPU ranks, which reduce-scatter by an
    all-reduce)."""
    shape = tuple(int(s) for s in shape)
    log: list = []
    size = _prod(shape)
    if not 0 <= int(rank) < size:
        raise ValueError(f"rank {rank} of a mesh of {size}")
    comm = Communicator(MetaGroup(size, log), rank, size, backend=backend,
                        shape=shape, device_type=device_type,
                        subgroup_factory=lambda ranks: MetaGroup(
                            len(ranks), log))
    return comm, log


def log_counters(log) -> dict:
    """A ``meta_communicator`` log (or a part of it) in ``counters``'
    form: each kind's calls and bytes (no seconds)."""
    out = {}
    for kind, key in KINDS:
        prefix = "" if kind == "all_reduce" else f"{kind}_"
        out[key] = sum(1 for k, _, _ in log if k == kind)
        out[f"{prefix}bytes"] = sum(b for k, b, _ in log if k == kind)
    return out


def reduce(x: torch.Tensor, comm: Communicator | None, op: str = "sum"):
    """``x`` reduced over ``comm``'s ranks; the identity when ``comm`` is
    None (the single-device path)."""
    return x if comm is None else comm.all_reduce(x, op)


_LOCAL = threading.local()
_WORLD: dict = {}


def _world() -> Communicator:
    """The communicator over the caller's default process group."""
    group = tdist.group.WORLD
    comm = _WORLD.get(id(group))
    if comm is None or comm.group is not group:
        comm = Communicator(group, tdist.get_rank(), tdist.get_world_size(),
                            backend=str(tdist.get_backend()),
                            subgroup_factory=lambda ranks: tdist.new_group(
                                ranks))
        _WORLD.clear()
        _WORLD[id(group)] = comm
    return comm


def current() -> Communicator | None:
    """The calling rank's communicator, or None outside any rank."""
    comm = getattr(_LOCAL, "comm", None)
    if comm is not None:
        return comm
    if tdist.is_available() and tdist.is_initialized():
        return _world()
    return None


@contextlib.contextmanager
def using(comm: Communicator):
    """Make ``comm`` the calling thread's communicator inside the block."""
    prev = getattr(_LOCAL, "comm", None)
    _LOCAL.comm = comm
    try:
        yield comm
    finally:
        _LOCAL.comm = prev
