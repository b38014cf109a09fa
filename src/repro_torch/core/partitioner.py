"""Geographer: SFC bootstrap + balanced k-means (paper Algorithm 2).
Counterpart of ``repro/core/partitioner.py``.

Single device (``geographer_partition``, ``geographer_repartition``): the
point array goes to the device once. The Hilbert keys, their stable sort
and the strided or weighted center picks run there (``sfc.
sfc_initial_centers_torch``); the warm-up permutation is drawn on the host
with ``np.random.default_rng(seed)``, as in the reference, so it is the
same permutation bit for bit, and applied on the device. Labels come back
in the original point order.

Distributed (``make_distributed_partitioner``): the paper's own
redistribution (§4.1; Alg. 2 l.7) over a rank's ``dist.Communicator``.
Every rank keys its shard by the Hilbert curve in the global bounding
box; a sample sort over ``all_to_all`` leaves each rank one contiguous
stretch of the curve in ``cap`` slots a source rank; the k initial
centers are the points at the strided global curve positions; each rank
then runs balanced k-means on its stretch. Every output of the
redistribution equals the reference's bit for bit (sorts, gathers and
integer counts; no float sum). One deliberate departure: the strided
positions are int64, where the reference's int32 wraps once k * N >=
2^31 (ROADMAP.md, queue 3 item 15).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.device import on_card, resolve_device
from repro_torch.dist import launch
from repro_torch.dist.comm import current
from repro_torch.dist.rules import comm_for, mesh_shape, mesh_size

from .balanced_kmeans import BKMConfig, balanced_kmeans, pin_backend
from .sfc import hilbert_index_int32, sfc_initial_centers_torch

INT32_MAX = int(np.iinfo(np.int32).max)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def stats_to_numpy(stats: dict) -> dict:
    """Solver stats with every tensor moved to a numpy array."""
    out = {}
    for key, val in stats.items():
        if isinstance(val, dict):
            out[key] = stats_to_numpy(val)
        elif isinstance(val, torch.Tensor):
            out[key] = val.detach().cpu().numpy()
        else:
            out[key] = val
    return out


def _to_device(points, weights, perm, dev, dtype):
    """Points and weights (float64) to the device once, then permuted
    there. Returns (points64, weights64, points, weights): the float64
    pair in the original order for the bootstrap, the other pair permuted
    and cast for the solver."""
    pts64 = torch.tensor(np.asarray(points, dtype=np.float64), device=dev)
    w64 = (None if weights is None else
           torch.tensor(np.asarray(weights, dtype=np.float64), device=dev))
    perm_t = torch.from_numpy(perm).to(dev)
    w = None if w64 is None else w64[perm_t].to(dtype)
    return pts64, w64, pts64[perm_t].to(dtype), w


def _labels(A: torch.Tensor, perm: np.ndarray) -> np.ndarray:
    out = np.empty(perm.shape[0], dtype=np.int64)
    out[perm] = A.cpu().numpy()
    return out


def geographer_partition(points: np.ndarray, k: int,
                         weights: np.ndarray | None = None,
                         cfg: BKMConfig | None = None, seed: int = 0,
                         return_stats: bool = False,
                         return_state: bool = False,
                         device: torch.device | str | None = None):
    """Partition ``points`` into k balanced blocks. Returns [n] block ids;
    ``return_stats=True`` returns ``(labels, stats)``,
    ``return_state=True`` returns ``(labels, centers, influence,
    stats)``. ``device`` defaults to ``cuda``. ``stats["seconds"]`` holds
    the host-clock split into ``bootstrap`` and ``kmeans`` (each ended by
    a device synchronize)."""
    dev = resolve_device(device)
    cfg = cfg or BKMConfig(k=k)
    if cfg.k != k:
        cfg = replace(cfg, k=k)
    n = points.shape[0]
    t0 = time.perf_counter()
    perm = np.random.default_rng(seed).permutation(n)
    pts64, w64, pts, w = _to_device(points, weights, perm, dev, cfg.dtype)
    centers0 = sfc_initial_centers_torch(pts64, k, w64).to(cfg.dtype)
    _sync(dev)
    t1 = time.perf_counter()
    A, centers, infl, stats = balanced_kmeans(pts, cfg, w, centers0)
    out = _labels(A, perm)
    t2 = time.perf_counter()
    stats = stats_to_numpy(stats)
    stats["seconds"] = {"bootstrap": t1 - t0, "kmeans": t2 - t1}
    if return_state:
        return out, centers.cpu().numpy(), infl.cpu().numpy(), stats
    if return_stats:
        return out, stats
    return out


def geographer_repartition(points: np.ndarray, k: int,
                           centers0: np.ndarray,
                           influence0: np.ndarray | None = None,
                           weights: np.ndarray | None = None,
                           cfg: BKMConfig | None = None, seed: int = 0,
                           prev_labels: np.ndarray | None = None,
                           device: torch.device | str | None = None):
    """Warm-started Geographer: balanced k-means resumed from a previous
    partition's ``(centers0, influence0)``, skipping the SFC bootstrap and
    the sampled warm-up. ``prev_labels`` (original point order) enables
    no-op detection. Returns (labels [n] int64, centers [k, d], influence
    [k], stats); ``stats["iters"]`` is 0 when the previous state is still
    a fixed point."""
    dev = resolve_device(device)
    cfg = cfg or BKMConfig(k=k, warmup=False)
    if cfg.k != k or cfg.warmup:
        cfg = replace(cfg, k=k, warmup=False)
    if centers0.shape[0] != k:
        raise ValueError(f"centers0 has {centers0.shape[0]} rows, k={k}")
    n = points.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    _, _, pts, w = _to_device(points, weights, perm, dev, cfg.dtype)
    infl0 = (None if influence0 is None else
             torch.tensor(np.asarray(influence0), device=dev).to(cfg.dtype))
    prev = (None if prev_labels is None else
            torch.from_numpy(np.asarray(prev_labels)[perm].astype(np.int32))
            .to(dev))
    c0 = torch.tensor(np.asarray(centers0), device=dev).to(cfg.dtype)
    A, centers, infl, stats = balanced_kmeans(
        pts, cfg, w, c0, influence0=infl0, warm_start=True,
        prev_assignment=prev)
    return (_labels(A, perm), centers.cpu().numpy(), infl.cpu().numpy(),
            stats_to_numpy(stats))


# ---------------------------------------------------------------------------
# Distributed: the SFC redistribution (a sample sort over all_to_all)
# ---------------------------------------------------------------------------

def _sample_indices(n_local: int, oversample: int) -> np.ndarray:
    """The reference's ``jnp.linspace(0, n_local - 1, oversample)
    .astype(int32)`` bit for bit, computed on the host: float32
    throughout, with the multiply XLA makes of jax's ``stop * (iota /
    div)`` (the division by the constant as a multiply by its float32
    reciprocal, reassociated to ``(stop * (1 / div)) * iota``), floored;
    the last index is ``n_local - 1``. numpy's float64 ``linspace``
    differs from it at some sizes (2^21 and 3 * 2^19 among them), and the
    splitters, with every destination, depend on these indices."""
    if oversample < 1:
        raise ValueError(f"oversample must be >= 1, got {oversample}")
    f32 = np.float32
    if oversample == 1:
        return np.zeros(1, np.int32)
    div = oversample - 1
    stop = f32(n_local - 1)
    inner = (stop * (f32(1.0) / f32(div))) * np.arange(div, dtype=f32)
    return np.append(np.floor(inner), stop).astype(np.int32)


@dataclass
class Redistribution:
    """One rank's side of ``redistribute``: ``P * cap`` slots, ``cap``
    from each source rank, sorted by key with the invalid slots last
    (zero points, zero weights)."""
    points: torch.Tensor       # [P*cap, d] float32
    weights: torch.Tensor      # [P*cap]
    valid: torch.Tensor        # [P*cap] bool
    count: int                 # valid slots of this rank
    offset: int                # valid slots of the ranks before it
    dropped: int               # points past a capacity, over all ranks
    cap: int
    splitters: torch.Tensor    # [P-1] int32; rank r: keys in [s[r-1], s[r])
    lo: torch.Tensor           # [d] global bounding box of the keys
    hi: torch.Tensor


def redistribute(points: torch.Tensor, weights: torch.Tensor, comm,
                 oversample: int = 32,
                 capacity_factor: float = 2.0) -> Redistribution:
    """Sample-sort bucket redistribution by Hilbert key, the reference's
    ``_sfc_redistribute`` step by step: the global box by a min and a max
    all-reduce, int32 keys, a stable sort, ``oversample`` samples a rank
    all-gathered and sorted, the splitters at ``arange(1, P) *
    oversample``, destinations by ``searchsorted(right=True)``, slots by
    arrival order with the overflow past ``cap = ceil(capacity_factor *
    n_local / P)`` dropped and counted (a sum all-reduce), the four send
    buffers through ``all_to_all``, a stable sort of what arrived (invalid
    slots keyed ``INT32_MAX``), and the counts all-gathered.
    ``points`` [n_local, d] float32 and ``weights`` [n_local] are this
    rank's shard, the same size on every rank."""
    n_local, d = points.shape
    P = comm.size
    dev = points.device
    lo = comm.all_reduce(torch.min(points, dim=0).values, "min")
    hi = comm.all_reduce(torch.max(points, dim=0).values, "max")
    keys = hilbert_index_int32(points, lo=lo, hi=hi)
    order = torch.sort(keys, stable=True).indices
    points, weights, keys = points[order], weights[order], keys[order]
    pick = torch.from_numpy(_sample_indices(n_local, oversample)).to(dev)
    samples = torch.sort(comm.all_gather(keys[pick.long()]).reshape(-1))
    splitters = samples.values[torch.arange(1, P, device=dev) * oversample]
    dest = torch.searchsorted(splitters, keys, right=True)
    cap = int(np.ceil(capacity_factor * n_local / P))
    # the keys are sorted, so the points bound for one rank are a run of
    # dest and a point's arrival order is its distance from the run start
    per_dest = torch.bincount(dest, minlength=P)
    start = torch.cumsum(per_dest, 0) - per_dest
    slot = torch.arange(n_local, device=dev) - start[dest]
    ok = slot < cap
    flat = torch.where(ok, dest * cap + slot, P * cap)

    def send(values, fill):
        # slot P * cap takes every dropped point and is cut off
        buf = values.new_full((P * cap + 1, *values.shape[1:]), fill)
        buf[flat] = values
        return comm.all_to_all(buf[:-1])

    dropped = comm.all_reduce(torch.sum(~ok, dtype=torch.int32))
    rp, rw, rk, rv = (send(points, 0.0), send(weights, 0.0),
                      send(keys, -1), send(ok, False))
    o = torch.sort(torch.where(rv, rk, INT32_MAX), stable=True).indices
    rp, rw, rv = rp[o], rw[o], rv[o]
    count = torch.sum(rv, dtype=torch.int32).reshape(1)
    counts = comm.all_gather(count).reshape(-1).cpu()
    return Redistribution(rp, rw, rv, int(counts[comm.rank]),
                          int(counts[:comm.rank].sum()), int(dropped), cap,
                          splitters, lo, hi)


def _sfc_redistribute(points, weights, comm, oversample=32,
                      capacity_factor=2.0):
    """``redistribute`` in the reference's return shape: (points [P*cap,
    d], weights [P*cap], valid [P*cap], my_count, my_offset,
    n_dropped)."""
    r = redistribute(points, weights, comm, oversample, capacity_factor)
    return r.points, r.weights, r.valid, r.count, r.offset, r.dropped


def _strided_centers(points, my_count: int, my_offset: int, k: int,
                     comm) -> torch.Tensor:
    """Initial centers at the global curve positions ``i*N//k + N//2k``
    (Alg. 2 l.7): the rank holding a position contributes its point, the
    others zeros, and a sum all-reduce makes them replicated. The
    positions are int64: the reference's int32 ``arange(k) * N`` wraps
    once k * N >= 2^31 and leaves those centers at the origin."""
    dev = points.device
    n_total = int(comm.all_reduce(torch.tensor(my_count, dtype=torch.int32,
                                               device=dev)))
    gpos = (torch.arange(k, dtype=torch.int64, device=dev) * n_total) // k \
        + n_total // (2 * k)
    local = gpos - my_offset
    mine = (local >= 0) & (local < my_count)
    idx = torch.clamp(local, 0, points.shape[0] - 1)
    contrib = torch.where(mine[:, None], points[idx],
                          torch.zeros((), dtype=points.dtype, device=dev))
    return comm.all_reduce(contrib)


def _partition_on_rank(points, weights, cfg: BKMConfig, comm, device):
    """This rank's share of the distributed partitioner on its shard:
    the redistribution, the strided centers, ``balanced_kmeans`` over the
    rank's slots with the padding at weight 0. Returns (A [P*cap] with -1
    on invalid slots, Redistribution, centers, influence, stats); stats
    holds the solver's stats as numpy, ``seconds`` (this rank's host clock,
    each part ended by a synchronize), ``collectives`` (this rank's, by
    kind) and ``redistribution`` (count, offset, cap, dropped, splitters,
    box, the initial centers)."""
    dev = launch.rank_device(resolve_device(device), comm.rank)
    with on_card(dev):
        before = comm.counters()
        t0 = time.perf_counter()
        cfg = pin_backend(cfg, dev)
        pts = torch.tensor(np.asarray(points, np.float32), device=dev)
        w = (torch.ones(pts.shape[0], dtype=torch.float32, device=dev)
             if weights is None else
             torch.tensor(np.asarray(weights, np.float32), device=dev))
        r = redistribute(pts, w, comm)
        _sync(dev)
        t1 = time.perf_counter()
        centers0 = _strided_centers(r.points, r.count, r.offset, cfg.k,
                                    comm)
        _sync(dev)
        t2 = time.perf_counter()
        # the padding keeps its zero points: the solver's box includes
        # the origin, as the reference's does
        w_eff = torch.where(r.valid, r.weights, 0.0)
        A, centers, infl, stats = balanced_kmeans(
            r.points, cfg, w_eff, centers0, comm=comm,
            n_global=pts.shape[0] * comm.size)
        A = torch.where(r.valid, A, -1)
        _sync(dev)
        t3 = time.perf_counter()
        after = comm.counters()
        stats = stats_to_numpy(stats)
        stats["seconds"] = {"redistribute": t1 - t0, "centers": t2 - t1,
                            "kmeans": t3 - t2}
        stats["collectives"] = {key: after[key] - before[key]
                                for key in after}
        stats["redistribution"] = {
            "count": r.count, "offset": r.offset, "cap": r.cap,
            "dropped": r.dropped, "splitters": r.splitters.cpu().numpy(),
            "lo": r.lo.cpu().numpy(), "hi": r.hi.cpu().numpy(),
            "centers0": centers0.cpu().numpy()}
        stats["backend"] = comm.backend
        return A, r, centers, infl, stats


def _result(A, rp, rv, centers, infl, stats, return_stats):
    out = (A.cpu().numpy(), rp.cpu().numpy(), rv.cpu().numpy(),
           centers.cpu().numpy(), infl.cpu().numpy(),
           stats["final_imbalance"], stats["redistribution"]["dropped"])
    return out + (stats,) if return_stats else out


def _axis_comm(mesh, axis_name: str):
    """(the communicator along ``axis_name`` of ``mesh``, the caller's
    rank in the whole mesh): the group that shards the solve; the groups
    along the other axis run the same solve (replicas)."""
    world = mesh.comm if mesh.size > 1 else comm_for(1)
    if len(mesh.extents) == 1 or mesh.size == 1:
        return world, world.rank
    if len(mesh.extents) != 2:
        raise ValueError(f"a mesh of {len(mesh.extents)} axes: the "
                         "distributed partitioner takes one or two")
    return world.axis_group(mesh.axis_names.index(axis_name)), world.rank


def _partition_launched(points, weights, cfg, *, device, return_stats,
                        mesh=None, axis_name=None):
    """Body of every rank of a launch made by ``run`` outside a rank: the
    rank's rows of the global arrays (``P(axis_name)``'s deal: the rows
    of the rank's coordinate on the axis, the same on every replica),
    then the axis-order concatenation of its group's slots,
    all-gathered."""
    if mesh is None:
        comm, rank = current(), current().rank
    else:
        comm, rank = _axis_comm(mesh, axis_name)
    rows = points.shape[0] // comm.size
    mine = slice(comm.rank * rows, (comm.rank + 1) * rows)
    A, r, centers, infl, stats = _partition_on_rank(
        points[mine], None if weights is None else weights[mine], cfg, comm,
        launch.rank_device(resolve_device(device), rank))
    A, rp, rv = (comm.all_gather(x).flatten(0, 1)
                 for x in (A, r.points, r.valid))
    return _result(A, rp, rv, centers, infl, stats, return_stats)


def make_distributed_partitioner(devices, cfg: BKMConfig,
                                 axis_name: str = "data", *, device=None):
    """The paper's distributed Geographer (§4.1) over ``devices``:
    returns ``run(points, weights=None, *, return_stats=False)``.

    ``devices`` is the number of ranks P, or a mesh of ranks
    (``launch.mesh.Mesh``; a pair ``(P1, P2)`` is the mesh
    ``make_mesh((P1, P2), ("data", "model"))``), sharded over
    ``axis_name`` as the reference's ``shard_map`` over
    ``mesh[axis_name]``: each group of ranks along that axis runs the
    solve over its ``P = mesh.shape[axis_name]`` ranks, and the groups
    along the other axis run the same solve on the same rows (the
    reference's replication, ``in_specs`` ``P(axis_name)``): every
    replica's result is ``devices=P``'s, bit for bit.

    Called outside a rank, ``run`` takes the global ``points`` [N, d] and
    ``weights`` [N] (None: unit), launches the ranks (``dist.launch``;
    the rank at coordinate s of the axis holds rows ``[s*N/P,
    (s+1)*N/P)``) and returns the global result. Called inside a rank
    (``dist.current()``), it takes the rank's own shard and returns the
    rank's slots with the replicated values. Either way it returns numpy
    arrays, the reference's: (A [P*P*cap] block ids aligned with the
    redistributed order, -1 on invalid slots; rp [P*P*cap, d]; rv
    [P*P*cap] bool; centers [k, d]; influence [k]; final_imbalance;
    n_dropped), the first three over this rank's ``P*cap`` slots inside a
    rank; with ``return_stats`` the rank's stats come last (rank 0's from
    outside).

    Args:
        devices: the number of ranks P, a mesh, or ``(P1, P2)``.
        cfg: BKMConfig of the solve.
        axis_name: the mesh axis the points are sharded over (a mesh
            only).
        device: every rank's device; None means the mesh's, or ``cuda``
            (rank r on card ``r % device_count``).

    Raises:
        ValueError: the mesh has no axis ``axis_name``, or N is not a
            multiple of P.
    """
    mesh = devices
    if isinstance(devices, (tuple, list)):
        from repro_torch.launch.mesh import Mesh
        mesh = Mesh(("data", "model"), mesh_shape(devices),
                    torch.device("cuda" if device is None else device))
    if hasattr(mesh, "axis_names"):
        if axis_name not in mesh.axis_names:
            raise ValueError(f"the mesh {mesh.shape} has no axis "
                             f"{axis_name!r} to shard the points over")
        if device is None:
            device = mesh.device
        P, world = mesh.shape[axis_name], mesh.size
    else:
        mesh = None
        P = world = mesh_size(devices)

    def run(points, weights=None, *, return_stats=False):
        if launch.needed(world):
            resolve_device(device)      # no card: raise before launching
            points = np.asarray(points)
            if points.shape[0] % P:
                raise ValueError(f"{points.shape[0]} points do not split "
                                 f"into {P} equal shards")
            extra = {} if mesh is None else {"mesh": mesh,
                                              "axis_name": axis_name}
            return launch.run(_partition_launched, world, device, points,
                              None if weights is None else
                              np.asarray(weights), cfg, device=device,
                              return_stats=return_stats, **extra)
        if mesh is None:
            comm, rank = comm_for(P), None
        else:
            comm, rank = _axis_comm(mesh, axis_name)
        dev = device if rank is None else launch.rank_device(
            resolve_device(device), rank)
        A, r, centers, infl, stats = _partition_on_rank(
            points, weights, cfg, comm, dev)
        return _result(A, r.points, r.valid, centers, infl, stats,
                       return_stats)

    return run
