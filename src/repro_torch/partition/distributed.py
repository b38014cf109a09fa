"""Sharded multi-device balanced k-means — ``partition(..., devices=P)``
(counterpart of ``repro/partition/distributed.py``).

The paper's scalability story (§4.1) is that every step of Algorithms 1
and 2 communicates only global vector sums over per-process partials:
cluster sizes [k], weighted coordinate sums [k, d], weighted counts [k]
and the bounding box [d]. The reference runs them under ``shard_map``;
the port runs one rank per process over ``torch.distributed``, each
holding one shard, and passes the rank's ``dist.Communicator`` through
``core.balanced_kmeans`` where the reference passes ``axis_name``.

* ``ShardedPartitionProblem`` — the static-shape sharded view: the points
  permuted with the problem's seed, then dealt round-robin (permuted
  position g lives at shard g % P, slot g // P), every shard padded to
  ``cap = ceil(n / P)`` slots with copies of real points at weight 0.
  The deal streams in bounded slot slices (``chunk=``) with the same
  bits as the one-shot deal. A rank builds only its own shard
  (``deal_shard``), O(cap) on the host.
* ``partition_sharded`` / ``repartition_sharded`` — cold and warm solves.
  Called by a rank (inside a launch, or under ``torchrun`` with the
  default process group initialized), they run that rank's share; called
  from outside, they launch the P ranks (``dist.launch``) and return rank
  0's result. Every rank returns the same result.
* ``devices=(P1, P2)`` — the same solve over the ranks viewed as a 2-D
  mesh. Every reduction runs over the whole group in the flat rank order,
  so the result equals ``devices=P1*P2`` bit for bit.

Labels go home without an all-gather: each rank writes its labels into
an [n] zero vector at its points' positions, and a sum all-reduce
combines them (the reference's ``eval/sharded.py`` pattern).

SFC bootstrap: ``bootstrap="host"`` (default) runs the single-device
bootstrap on every rank (each holds the problem), so ``devices=1`` equals
``partition()`` bit for bit; ``bootstrap="device"`` is the distributed
bootstrap over 30-bit keys (``core.sfc.sfc_initial_centers_sharded``).

Agreement: ``devices=1`` is bit for bit the single-device path.
``devices=P>1`` with ``warmup=False`` differs from it by the order of
the float sums (the reference's contract: >= 97% equal labels; the
port's tests hold it to 99% against the reference's own ``devices=P``).
With the warm-up each shard samples its own prefix, so only the balance
is guaranteed.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.balanced_kmeans import (BKMConfig, balanced_kmeans,
                                             pin_backend)
from repro_torch.core.partitioner import stats_to_numpy
from repro_torch.core.sfc import (sfc_initial_centers_sharded,
                                  sfc_initial_centers_torch)
from repro_torch.device import on_card, resolve_device
from repro_torch.dist import launch
from repro_torch.dist.rules import comm_for, mesh_size

from .problem import PartitionProblem, PartitionResult

BOOTSTRAPS = ("host", "device")

#: largest per-shard slot index the int32 index math can address (the
#: solver's warm-up index, the assign kernel's rows)
INT32_INDEX_CAP = np.iinfo(np.int32).max

def _devices_stat(devices):
    """JSON-friendly devices value for stats dicts (tuple -> list)."""
    return list(devices) if isinstance(devices, (tuple, list)) \
        else int(devices)


def check_index_capacity(n: int, devices) -> int:
    """Validate that the per-shard slot count fits the int32 index math.

    Every shard gets ``cap = ceil(n / P)`` slots. Global positions are
    int64 on the host; the per-shard index math (the warm-up index in
    ``core.balanced_kmeans``, the assign kernel's rows) is int32, so
    ``cap`` must stay <= 2**31 - 1.

    Args:
        n: global point count.
        devices: shard count P, or a (P1, P2) mesh tuple.

    Returns:
        cap — the per-shard slot count ``ceil(n / P)``.

    Raises:
        ValueError: ``cap`` exceeds the int32 index capacity (names n,
            P, cap, and the limit).
    """
    P = mesh_size(devices)
    cap = -(-int(n) // P)
    if cap > INT32_INDEX_CAP:
        raise ValueError(
            f"per-shard slot count cap=ceil(n/P)={cap} overflows the "
            f"int32 traced index capacity ({INT32_INDEX_CAP}) at "
            f"n={n}, devices={P}; shard over more devices so that "
            f"ceil(n/P) <= {INT32_INDEX_CAP}")
    return cap


def _sources(problem: PartitionProblem):
    """(points, weights) as the deal reads them: floating sources keep
    their dtype, integer ones become float64; None weights are ones."""
    src = np.asarray(problem.points)
    pdtype = (src.dtype if np.issubdtype(src.dtype, np.floating)
              else np.dtype(np.float64))
    if problem.weights is None:
        w = np.ones(problem.n, pdtype)
    else:
        w = np.asarray(problem.weights)
        if not np.issubdtype(w.dtype, np.floating):
            w = np.asarray(w, np.float64)
    return src, pdtype, w


def _check_devices(problem: PartitionProblem, devices) -> int:
    P = mesh_size(devices)
    if P > problem.n:
        raise ValueError(f"devices={P} exceeds n={problem.n} points")
    check_index_capacity(problem.n, P)
    return P


@dataclass(frozen=True)
class ShardedPartitionProblem:
    """Static-shape sharded view of a ``PartitionProblem``.

    Layout: the points are permuted with the problem's seed (the
    permutation the single-device path samples its warm-up from), then
    dealt round-robin — permuted position g lives at shard g % P, slot
    g // P. A shard's slot prefix follows the global permutation prefix
    within P-1 points, which keeps the warm-up's per-shard prefix masks
    close to the single-device run's. Slots past n wrap around to real
    points at weight 0: they move neither a weighted sum nor the bounding
    box, and their labels are dropped on the way home.

    Attributes:
        problem: the source ``PartitionProblem``.
        devices: flat shard count P (the product for a 2-D mesh: the
            layout depends only on P).
        points: [P, cap, d] dealt coordinates in the source floating
            dtype (integer sources become float64).
        weights: [P, cap] dealt weights; exactly 0 marks a padded slot.
        gather: [P, cap] int64 original point id of every slot.
        valid: [P, cap] bool, False for padded slots.
    """
    problem: PartitionProblem
    devices: int
    points: np.ndarray
    weights: np.ndarray
    gather: np.ndarray
    valid: np.ndarray

    @property
    def cap(self) -> int:
        """Per-shard slot count, ``ceil(n / P)``."""
        return self.points.shape[1]

    @classmethod
    def from_problem(cls, problem: PartitionProblem, devices, *,
                     chunk: int | None = None) -> "ShardedPartitionProblem":
        """Deal ``problem`` onto ``devices`` shards.

        Every shard is dealt as a rank deals its own (``deal_shard``),
        streaming in slot slices of ``chunk``; ``chunk=None`` is one
        full-cap slice, with the same bits as any chunked setting.

        Args:
            problem: the instance to shard; its seed fixes the
                permutation, so re-sharding is deterministic.
            devices: shard count P with ``1 <= P <= problem.n``, or a
                (P1, P2) mesh shape (the layout depends on the product).
            chunk: per-shard slots gathered per slice (None = all).

        Returns:
            The static-shape sharded view.

        Raises:
            ValueError: P < 1, P > n, or an int32 index-capacity
                overflow (``check_index_capacity``).
        """
        P = _check_devices(problem, devices)
        perm = np.random.default_rng(problem.seed).permutation(problem.n)
        pts, wts, gather, valid = (np.stack(parts) for parts in zip(*(
            deal_shard(problem, P, p, chunk=chunk, perm=perm)
            for p in range(P))))
        return cls(problem=problem, devices=P, points=pts, weights=wts,
                   gather=gather, valid=valid)

    def deal(self, values: np.ndarray,
             chunk: int | None = None) -> np.ndarray:
        """Deal a per-point host array onto the shard layout (padded slots
        take the value of the real point they copy).

        Args:
            values: [n, ...] array in original point order.
            chunk: per-shard slots per slice (None = one shot); the same
                bits for every setting.

        Returns:
            [P, cap, ...] dealt array (source dtype preserved).
        """
        values = np.asarray(values)
        if chunk is None:
            return values[self.gather]
        out = np.empty(self.gather.shape + values.shape[1:], values.dtype)
        step = max(1, min(int(chunk), self.cap))
        for s0 in range(0, self.cap, step):
            s1 = min(s0 + step, self.cap)
            out[:, s0:s1] = values[self.gather[:, s0:s1]]
        return out

    def scatter_labels(self, A: np.ndarray,
                       chunk: int | None = None) -> np.ndarray:
        """Scatter shard labels back home.

        Args:
            A: [P, cap] per-shard labels.
            chunk: per-shard slots per slice (None = one shot); every
                valid slot addresses a distinct point, so the chunked
                scatter writes the same bits.

        Returns:
            [n] int64 labels in original point order (padded slots
            dropped).
        """
        A = np.asarray(A)
        labels = np.empty(self.problem.n, np.int64)
        step = self.cap if chunk is None else max(1, min(int(chunk),
                                                         self.cap))
        for s0 in range(0, self.cap, step):
            s1 = min(s0 + step, self.cap)
            v = self.valid[:, s0:s1]
            labels[self.gather[:, s0:s1][v]] = A[:, s0:s1][v]
        return labels


def deal_shard(problem: PartitionProblem, devices, shard: int, *,
               chunk: int | None = None, perm: np.ndarray | None = None,
               dtype=None):
    """Shard ``shard`` of the round-robin deal, built alone: what a rank
    holds. Equal to row ``shard`` of ``ShardedPartitionProblem.
    from_problem``; host staging O(cap).

    Args:
        problem: the instance.
        devices: shard count P or a (P1, P2) mesh shape.
        shard: the shard index in [0, P).
        chunk: slots per slice (None = all); the same bits.
        perm: the problem's seeded permutation, when the caller has it.
        dtype: numpy dtype of the points and weights (None = source's).

    Returns:
        (points [cap, d], weights [cap], gather [cap] int64, valid [cap]).
    """
    P = _check_devices(problem, devices)
    if not 0 <= shard < P:
        raise ValueError(f"shard {shard} out of range for {P} shards")
    n = problem.n
    cap = -(-n // P)
    if perm is None:
        perm = np.random.default_rng(problem.seed).permutation(n)
    src, pdtype, w = _sources(problem)
    odtype = pdtype if dtype is None else np.dtype(dtype)
    step = cap if chunk is None else max(1, min(int(chunk), cap))
    pts = np.empty((cap, src.shape[1]), odtype)
    wts = np.empty(cap, odtype if dtype is not None else w.dtype)
    gather = np.empty(cap, np.int64)
    valid = np.empty(cap, bool)
    for s0 in range(0, cap, step):
        s1 = min(s0 + step, cap)
        g = np.arange(s0, s1, dtype=np.int64) * P + shard
        v = g < n
        gth = perm[g % n]
        gather[s0:s1] = gth
        valid[s0:s1] = v
        pts[s0:s1] = src[gth]
        wts[s0:s1] = np.where(v, w[gth], 0)
    return pts, wts, gather, valid


def labels_home(A: torch.Tensor, gather: np.ndarray, valid: np.ndarray,
                n: int, comm) -> np.ndarray:
    """[n] int64 labels in original point order from every rank's shard
    labels ``A`` [cap]: each rank writes its valid slots into an [n] zero
    vector and one sum all-reduce combines them (every point has exactly
    one valid slot)."""
    keep = torch.from_numpy(valid).to(A.device)
    full = torch.zeros(n, dtype=torch.int32, device=A.device)
    full[torch.from_numpy(gather[valid]).to(A.device)] = \
        A.to(torch.int32)[keep]
    return comm.all_reduce(full).cpu().numpy().astype(np.int64)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).rsplit(".", 1)[-1])


def _collectives(before: dict, after: dict) -> dict:
    return {key: after[key] - before[key] for key in after}


def _solve_on_rank(problem: PartitionProblem, comm, cfg: BKMConfig,
                   device, *, bootstrap: str, chunk: int | None,
                   centers0=None, influence0=None, prev_labels=None):
    """This rank's share of a sharded solve: its shard, the bootstrap (or
    the warm state), ``balanced_kmeans`` with ``comm``, the labels home.
    Returns what every rank returns alike: (labels [n] int64, centers,
    influence, stats) with ``stats["seconds"]`` (this rank's host clock:
    deal and bootstrap, k-means and the labels home) and
    ``stats["collectives"]`` (this rank's all-reduces)."""
    dev = launch.rank_device(resolve_device(device), comm.rank)
    warm = centers0 is not None
    with on_card(dev):
        before = comm.counters()
        t0 = time.perf_counter()
        cfg = pin_backend(cfg, dev)
        n = problem.n
        pts, w, gather, valid = deal_shard(problem, comm.size,
                                           comm.shard_id, chunk=chunk,
                                           dtype=_np_dtype(cfg.dtype))
        pts_t = torch.from_numpy(pts).to(dev)
        w_t = torch.from_numpy(w).to(dev)
        kw = {}
        if warm:
            c0 = torch.tensor(np.asarray(centers0), device=dev).to(cfg.dtype)
            kw["influence0"] = (None if influence0 is None else torch.tensor(
                np.asarray(influence0), device=dev).to(cfg.dtype))
            # without previous labels a -1 sentinel is dealt: it never
            # equals a block id, so no-op detection cannot fire on it
            prev = (np.full(gather.shape, -1, np.int32) if prev_labels is None
                    else np.asarray(prev_labels, np.int32)[gather])
            kw.update(warm_start=True,
                      prev_assignment=torch.from_numpy(prev).to(dev))
        elif bootstrap == "host":
            pts64 = torch.tensor(np.asarray(problem.points, np.float64),
                                 device=dev)
            w64 = (None if problem.weights is None else torch.tensor(
                np.asarray(problem.weights, np.float64), device=dev))
            c0 = sfc_initial_centers_torch(pts64, cfg.k, w64).to(cfg.dtype)
        else:
            c0 = sfc_initial_centers_sharded(
                pts_t.float(), w_t.float(), cfg.k, comm).to(cfg.dtype)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        A, centers, infl, stats = balanced_kmeans(
            pts_t, cfg, w_t, c0, n_global=n, comm=comm, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        labels = labels_home(A, gather, valid, n, comm)
        t3 = time.perf_counter()
        stats = stats_to_numpy(stats)
        stats["seconds"] = {"bootstrap": t1 - t0, "kmeans": t2 - t1,
                            "labels_home": t3 - t2}
        stats["collectives"] = _collectives(before, comm.counters())
        stats["backend"] = comm.backend
        return labels, centers.cpu().numpy(), infl.cpu().numpy(), stats


def geographer_partition_sharded(problem: PartitionProblem, devices,
                                 cfg: BKMConfig | None = None,
                                 bootstrap: str = "host",
                                 chunk: int | None = None, *,
                                 device=None):
    """Raw sharded cold-start run.

    Args:
        problem: the instance; its seed fixes the round-robin deal.
        devices: shard count P (1 <= P <= problem.n), or a (P1, P2) mesh
            shape — bit-identical to the flat P1*P2 run.
        cfg: BKMConfig; None uses the problem's (k, epsilon).
        bootstrap: "host" (the single-device bootstrap on every rank) or
            "device" (the distributed bootstrap over 30-bit keys).
        chunk: per-shard slots per deal slice (the same bits).
        device: every rank's device; None means ``cuda`` (rank r on card
            ``r % device_count``).

    Returns:
        (labels [n] int64 in original point order, centers [k, d],
        influence [k], stats dict) — the same on every rank. Prefer the
        front door ``partition(problem, devices=...)``.
    """
    if bootstrap not in BOOTSTRAPS:
        raise ValueError(f"bootstrap must be one of {BOOTSTRAPS}, "
                         f"got {bootstrap!r}")
    _check_devices(problem, devices)
    if launch.needed(devices):
        return launch.run(geographer_partition_sharded, devices, device,
                          problem, devices, cfg, bootstrap, chunk,
                          device=device)
    cfg = cfg or BKMConfig(k=problem.k, epsilon=problem.epsilon)
    return _solve_on_rank(problem, comm_for(devices), cfg, device,
                          bootstrap=bootstrap, chunk=chunk)


def geographer_repartition_sharded(problem: PartitionProblem, devices,
                                   centers0: np.ndarray,
                                   influence0: np.ndarray | None = None,
                                   cfg: BKMConfig | None = None,
                                   prev_labels: np.ndarray | None = None,
                                   chunk: int | None = None, *,
                                   device=None):
    """Raw sharded warm-start run: balanced k-means resumed from a
    previous partition's (centers0, influence0), no SFC bootstrap, no
    warm-up. The state is replicated on every rank and the communication
    stays all-reduces only; ``devices=1`` equals the single-device
    ``core.partitioner.geographer_repartition`` bit for bit.

    Args:
        problem: the (re-weighted or moved) instance.
        devices: shard count P, or a (P1, P2) mesh shape.
        centers0: [k, d] previous centers.
        influence0: [k] previous influence (None = ones).
        cfg: BKMConfig; ``warmup`` is forced off.
        prev_labels: [n] previous block ids in original point order; an
            unchanged, still balanced partition is then re-emitted
            verbatim. Without them a -1 sentinel is dealt, which never
            matches a real block id.
        chunk: per-shard slots per deal slice (None = one shot).
        device: every rank's device; None means ``cuda``.

    Returns:
        (labels [n] int64, centers [k, d], influence [k], stats dict);
        ``stats["iters"]`` is 0 at a fixed point.
    """
    cfg = cfg or BKMConfig(k=problem.k, epsilon=problem.epsilon,
                           warmup=False)
    if cfg.warmup:
        cfg = dataclasses.replace(cfg, warmup=False)
    if np.asarray(centers0).shape[0] != cfg.k:
        raise ValueError(f"centers0 has {np.asarray(centers0).shape[0]} "
                         f"rows, k={cfg.k}")
    _check_devices(problem, devices)
    if launch.needed(devices):
        return launch.run(geographer_repartition_sharded, devices, device,
                          problem, devices, centers0, influence0, cfg,
                          prev_labels, chunk, device=device)
    return _solve_on_rank(problem, comm_for(devices), cfg, device,
                          bootstrap="warm", chunk=chunk, centers0=centers0,
                          influence0=influence0, prev_labels=prev_labels)


def partition_sharded(problem: PartitionProblem, devices, *,
                      device=None, bootstrap: str = "host",
                      chunk: int | None = None, **opts) -> PartitionResult:
    """Multi-device geographer partition of ``problem`` over ``devices``
    shards (the ``devices=`` path of the ``partition()`` front door).

    Args:
        problem: the instance (its seed fixes the shard layout).
        devices: shard count P, or a (P1, P2) mesh shape (bit-identical
            to the flat P1*P2 run); 1 <= P <= problem.n.
        device: every rank's device; None means ``cuda``.
        bootstrap: "host" (the agreement default) or "device".
        chunk: per-shard slots per deal slice (the same bits).
        **opts: BKMConfig fields (``max_iter=50``, ``warmup=False``,
            ...); unknown fields raise TypeError.

    Returns:
        PartitionResult with labels in original point order, the final
        (centers, influence) state and ``stats`` with the iteration
        history plus ``devices``, ``bootstrap`` and ``backend``.
    """
    from .algorithms import make_bkm_config
    cfg = make_bkm_config(problem, **opts)
    labels, centers, infl, stats = geographer_partition_sharded(
        problem, devices, cfg=cfg, bootstrap=bootstrap, chunk=chunk,
        device=device)
    return PartitionResult(
        labels=labels, k=problem.k, method="geographer", problem=problem,
        centers=np.asarray(centers), influence=np.asarray(infl),
        stats={"levels": [dict(stats)],
               "final_imbalance": float(stats["final_imbalance"]),
               "devices": _devices_stat(devices), "bootstrap": bootstrap,
               "backend": stats["backend"]})


def repartition_sharded(problem: PartitionProblem, devices,
                        centers0: np.ndarray,
                        influence0: np.ndarray | None = None,
                        prev_labels: np.ndarray | None = None,
                        chunk: int | None = None, *, device=None,
                        **opts) -> PartitionResult:
    """Multi-device warm-started repartition (the ``devices=`` path of the
    ``repartition()`` front door).

    Args:
        problem: the perturbed instance.
        devices: shard count P, or a (P1, P2) mesh shape.
        centers0: [k, d] previous centers.
        influence0: [k] previous influence (None = ones).
        prev_labels: [n] previous block ids (no-op detection).
        chunk: per-shard slots per deal slice (None = one shot).
        device: every rank's device; None means ``cuda``.
        **opts: BKMConfig fields (``warmup`` is forced off).

    Returns:
        PartitionResult (labels, final centers/influence, stats with
        ``warm_start`` True and the movement iterations at ``iters``).
    """
    from .algorithms import make_bkm_config
    cfg = make_bkm_config(problem, **dict(opts, warmup=False))
    labels, centers, infl, stats = geographer_repartition_sharded(
        problem, devices, centers0, influence0, cfg=cfg,
        prev_labels=prev_labels, chunk=chunk, device=device)
    return PartitionResult(
        labels=labels, k=problem.k, method="geographer", problem=problem,
        centers=np.asarray(centers), influence=np.asarray(infl),
        stats={"levels": [dict(stats)],
               "final_imbalance": float(stats["final_imbalance"]),
               "iters": int(stats["iters"]),
               "devices": _devices_stat(devices), "warm_start": True,
               "backend": stats["backend"]})
