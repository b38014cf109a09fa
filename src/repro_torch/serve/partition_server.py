"""Partitioning as a service: a batched multi-tenant ``PartitionServer``
(counterpart of ``repro/serve/partition_server.py``)::

    from repro_torch.serve import PartitionServer, PartitionRequest

    server = PartitionServer(tiers=(1024, 2048, 4096), slots=4)
    server.submit(PartitionRequest(tenant="sim-a", points=pts_a, k=16))
    server.submit(PartitionRequest(tenant="sim-b", points=pts_b, k=8))
    for resp in server.step():          # one bucket solve per bucket
        resp.labels, resp.warm, resp.iters

    # next timestep: same tenants, drifted weights -> warm hits
    server.submit(PartitionRequest(tenant="sim-a", points=pts_a, k=16,
                                   weights=w_t))
    [resp] = server.step()

Requests of varying n and k are admitted into static slot buckets (a
power-of-two point tier times a fixed number of slots); a request with n
points lands in the smallest tier with cap >= n and is padded to the cap
by cycling its own permuted points at weight zero. Requests sharing a
bucket key (cap, k, d, epsilon, warm/cold) are grouped ``slots`` at a
time; short groups are topped up with filler copies of their first
request, masked invalid. Every bucket goes through
``partition.batched.bucket_balanced_kmeans`` on the server's device, and
per-tenant warm state (``repartition.WarmState``) lives in an LRU cache,
so steady-state requests take the warm path.

Determinism: each slot equals a standalone solve of its padded
subproblem, and the per-request prep (permutation by the request seed,
SFC bootstrap from the request's own points) never depends on queue
order, so a request stream gives the same labels however it is
interleaved into buckets.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Hashable

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.balanced_kmeans import BKMConfig
from repro_torch.core.sfc import sfc_initial_centers
from repro_torch.device import resolve_device
from repro_torch.partition.batched import bucket_balanced_kmeans
from repro_torch.partition.repartition import (MAX_BALANCE_RETRIES,
                                               WARM_DELTA_TOL, WarmState)

DEFAULT_TIERS = (1024, 2048, 4096, 8192, 16384)

_BKM_FIELDS = {f.name for f in dataclasses.fields(BKMConfig)}


@dataclass
class PartitionRequest:
    """One tenant's (re)partition request.

    Attributes:
        tenant: hashable tenant id — the warm-state cache key.
        points: [n, d] float coordinates.
        k: number of blocks, ``1 <= k <= n``.
        weights: [n] nonneg node weights, or None (= unit weights).
        epsilon: balance slack (a bucket key component).
        seed: permutation seed — per request, so results do not depend on
            how requests are interleaved into buckets.
        uid: server-assigned admission id (set by ``submit``).
    """
    tenant: Hashable
    points: np.ndarray
    k: int
    weights: np.ndarray | None = None
    epsilon: float = 0.03
    seed: int = 0
    uid: int | None = None

    def __post_init__(self):
        self.points = np.asarray(self.points, np.float64)
        if self.points.ndim != 2:
            raise ValueError(f"points must be [n, d], "
                             f"got {self.points.shape}")
        if not (1 <= self.k <= self.n):
            raise ValueError(f"k={self.k} out of range for n={self.n}")
        if self.weights is not None:
            self.weights = np.asarray(self.weights, np.float64)
            if self.weights.shape != (self.n,):
                raise ValueError(
                    f"weights must be [{self.n}], "
                    f"got {self.weights.shape}")

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]


@dataclass
class PartitionResponse:
    """The server's answer to one ``PartitionRequest``.

    Attributes:
        uid / tenant: echo of the request.
        labels: [n] int64 block ids in the request's point order.
        centers: [k, d] final centers (also cached as warm state).
        influence: [k] final influence.
        warm: True when the solve resumed from cached warm state.
        iters: movement iterations spent (cumulative over balance
            retries).
        imbalance: the request's imbalance (host metric of its slot).
        balanced: ``imbalance <= epsilon + 1e-6``.
        migration_fraction: fraction of weight that changed blocks
            against the tenant's previous labels (warm solves only).
        tier: the point cap of the bucket that served this request.
        time_s: wall time of the bucket solve(s) this request rode in.
        stats: the slot's solver stats (numpy).
    """
    uid: int
    tenant: Hashable
    labels: np.ndarray
    centers: np.ndarray
    influence: np.ndarray
    warm: bool
    iters: int
    imbalance: float
    balanced: bool
    migration_fraction: float | None
    tier: int
    time_s: float
    stats: dict = field(default_factory=dict)


def _slot_stats(stats: dict, S: int) -> dict:
    """The per-slot array leaves of a bucket's stats, on the host."""
    out = {}
    for name, v in stats.items():
        if isinstance(v, dict):
            continue
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        if v is not None and np.ndim(v) >= 1 and np.shape(v)[0] == S:
            out[name] = np.asarray(v)
    return out


class PartitionServer:
    """Multi-tenant partition serving over static slot buckets.

    Args:
        tiers: ascending power-of-two point caps. A request is padded to
            the smallest tier >= its n; larger requests are rejected at
            ``submit``.
        slots: fixed lane count per bucket. Short groups are
            filler-padded and masked.
        cache_slots: warm-state cache capacity (LRU over tenants); 0
            disables warm serving (every solve cold-starts).
        device: where the solves run; None means ``cuda``.
        **solver_opts: BKMConfig field overrides shared by every solve;
            unknown names raise. Warm solves force ``warmup=False`` and
            default ``delta_tol`` to the warm movement threshold, like
            ``repartition()``.
    """

    def __init__(self, tiers=DEFAULT_TIERS, slots: int = 4,
                 cache_slots: int = 64,
                 device: torch.device | str | None = None, **solver_opts):
        tiers = tuple(sorted(int(t) for t in tiers))
        if not tiers:
            raise ValueError("need at least one tier")
        for t in tiers:
            if t < 1 or (t & (t - 1)):
                raise ValueError(f"tiers must be powers of two, got {t}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if cache_slots < 0:
            raise ValueError(f"cache_slots must be >= 0, got {cache_slots}")
        bad = set(solver_opts) - _BKM_FIELDS
        if bad:
            raise TypeError(f"unknown BKMConfig options {sorted(bad)}")
        for fixed in ("k", "epsilon"):
            if fixed in solver_opts:
                raise TypeError(f"{fixed!r} is per-request state, not a "
                                "server-wide solver option")
        self.device = resolve_device(device)
        self.tiers = tiers
        self.slots = int(slots)
        self.cache_slots = int(cache_slots)
        self._opts = dict(solver_opts)
        self._queue: list[PartitionRequest] = []
        self._cache: OrderedDict[Hashable, WarmState] = OrderedDict()
        self._next_uid = 0
        self.stats: dict[str, int] = {
            "submitted": 0, "solved": 0, "dispatches": 0,
            "warm_hits": 0, "cold_solves": 0, "invalidations": 0,
            "evictions": 0, "filler_slots": 0, "balance_retries": 0,
        }

    # -- admission ---------------------------------------------------------

    def tier_for(self, n: int) -> int:
        """Smallest tier cap >= n; ValueError past the largest tier."""
        for t in self.tiers:
            if n <= t:
                return t
        raise ValueError(
            f"request with n={n} points exceeds the largest tier "
            f"(cap={self.tiers[-1]}); configure a bigger tier or shrink "
            "the request")

    def submit(self, request: PartitionRequest) -> int:
        """Admit one request; returns its uid. Oversized requests fail
        here, not inside a bucket solve."""
        if not isinstance(request, PartitionRequest):
            raise TypeError(f"submit() takes a PartitionRequest, "
                            f"got {type(request)}")
        self.tier_for(request.n)
        request.uid = self._next_uid
        self._next_uid += 1
        self._queue.append(request)
        self.stats["submitted"] += 1
        return request.uid

    def pending(self) -> int:
        """Number of admitted, not yet served requests."""
        return len(self._queue)

    # -- warm cache --------------------------------------------------------

    def _lookup_warm(self, req: PartitionRequest) -> WarmState | None:
        state = self._cache.get(req.tenant)
        if state is None:
            return None
        if not state.compatible_with(req.n, req.k):
            # the tenant changed its problem shape: drop the state
            del self._cache[req.tenant]
            self.stats["invalidations"] += 1
            return None
        return state

    def _store_warm(self, tenant: Hashable, state: WarmState) -> None:
        if self.cache_slots == 0:
            return
        if tenant in self._cache:
            del self._cache[tenant]
        self._cache[tenant] = state          # most-recently-used at the end
        while len(self._cache) > self.cache_slots:
            self._cache.popitem(last=False)  # evict least-recently-used
            self.stats["evictions"] += 1

    def cached_tenants(self) -> list:
        """Tenant ids currently holding a warm slot, LRU-first."""
        return list(self._cache)

    # -- serving -----------------------------------------------------------

    def step(self) -> list[PartitionResponse]:
        """Drain the queue: group requests into static buckets, solve each
        bucket (plus warm balance retries), update the warm cache, and
        return one response per request (in bucket order). An empty queue
        returns [] without solving."""
        queue, self._queue = self._queue, []
        if not queue:
            return []
        buckets: OrderedDict[tuple, list] = OrderedDict()
        for req in queue:
            state = self._lookup_warm(req)
            key = (self.tier_for(req.n), req.k, req.dim, req.epsilon,
                   state is not None)
            buckets.setdefault(key, []).append((req, state))
        responses: list[PartitionResponse] = []
        for (cap, k, _d, epsilon, warm), group in buckets.items():
            for base in range(0, len(group), self.slots):
                chunk = group[base:base + self.slots]
                responses.extend(
                    self._solve_bucket(cap, k, epsilon, warm, chunk))
        return responses

    def serve(self, requests: list[PartitionRequest]
              ) -> list[PartitionResponse]:
        """Submit ``requests`` and step until the queue drains; responses
        come back in submission order."""
        for r in requests:
            self.submit(r)
        out: list[PartitionResponse] = []
        while self._queue:
            out.extend(self.step())
        return sorted(out, key=lambda r: r.uid)

    # -- bucket mechanics --------------------------------------------------

    def _cfg(self, k: int, epsilon: float, warm: bool) -> BKMConfig:
        opts = dict(self._opts)
        if warm:
            opts.setdefault("delta_tol", WARM_DELTA_TOL)
            opts["warmup"] = False
        return BKMConfig(k=k, epsilon=epsilon, **opts)

    def _prep_slot(self, req: PartitionRequest, cap: int,
                   state: WarmState | None):
        """Per-request static-shape prep: permute by the request seed (as
        ``geographer_partition`` does), pad to the cap by cycling the
        permuted points at weight zero, and seed centers from the SFC
        bootstrap (cold) or the cached warm state."""
        n = req.n
        perm = np.random.default_rng(req.seed).permutation(n)
        idx = perm[np.arange(cap) % n]
        live = np.arange(cap) < n
        pts = req.points[idx]
        w = np.ones(n) if req.weights is None else req.weights
        w = np.where(live, w[idx], 0.0)
        if state is None:
            c0 = sfc_initial_centers(req.points, req.k, req.weights)
            i0 = np.ones(req.k)
            pa = np.zeros(cap, np.int32)
        else:
            c0 = state.centers
            i0 = state.influence_or_ones()
            # padded duplicates inherit their source point's previous
            # label, so slot-level no-op detection matches the unpadded
            # problem's exactly
            pa = state.labels[idx].astype(np.int32)
        return perm, pts, w, c0, i0, pa

    def _solve_bucket(self, cap: int, k: int, epsilon: float, warm: bool,
                      chunk: list) -> list[PartitionResponse]:
        S = self.slots
        d = chunk[0][0].dim
        pts = np.zeros((S, cap, d))
        w = np.zeros((S, cap))
        c0 = np.zeros((S, k, d))
        i0 = np.ones((S, k))
        pa = np.zeros((S, cap), np.int32)
        perms, counts = [], np.ones(S, np.int64)
        for s, (req, state) in enumerate(chunk):
            perm, pts[s], w[s], c0[s], i0[s], pa[s] = \
                self._prep_slot(req, cap, state)
            perms.append(perm)
            counts[s] = req.n
        for s in range(len(chunk), S):     # filler lanes: copies of slot 0
            pts[s], w[s], c0[s], i0[s], pa[s] = (pts[0], w[0], c0[0],
                                                 i0[0], pa[0])
            counts[s] = counts[0]
        valid = np.arange(S) < len(chunk)
        self.stats["filler_slots"] += int(S - len(chunk))
        cfg = self._cfg(k, epsilon, warm)

        t0 = time.perf_counter()
        A, C, infl, stats = bucket_balanced_kmeans(
            pts, w, c0, cfg, counts=counts, valid=valid, warm=warm,
            influence0=i0 if warm else None,
            prev_assignment=pa if warm else None, device=self.device)
        total_iters = stats["iters"].cpu().numpy().astype(np.int64)
        retries = 0
        if warm:
            # a slot whose final balance pass ended above epsilon is
            # re-warmed from its own output; balanced slots re-emit
            # verbatim through no-op detection, so retrying the whole
            # bucket is safe
            while retries < MAX_BALANCE_RETRIES:
                imb = np.asarray(stats["imbalance"])
                if not np.any(valid & (imb > epsilon + 1e-6)):
                    break
                A, C, infl, stats = bucket_balanced_kmeans(
                    pts, w, C, cfg, counts=counts, valid=valid, warm=True,
                    influence0=infl, prev_assignment=A, device=self.device)
                total_iters += stats["iters"].cpu().numpy().astype(np.int64)
                retries += 1
                self.stats["balance_retries"] += 1
        dt = time.perf_counter() - t0
        self.stats["dispatches"] += 1 + retries

        A = A.cpu().numpy()
        C = C.cpu().numpy()
        infl = infl.cpu().numpy()
        imb = np.asarray(stats["imbalance"])
        host_stats = _slot_stats(stats, S)
        responses = []
        for s, (req, state) in enumerate(chunk):
            labels = np.empty(req.n, np.int64)
            labels[perms[s]] = A[s, :req.n]
            mf = None
            if warm:
                # against the tenant's previous labels under the new
                # weights (repartition() semantics); after retries the
                # bucket's value is against the retry input, so recount
                if retries == 0:
                    mf = float(host_stats["migration_fraction"][s])
                else:
                    mf = float(metrics.migration_fraction(
                        state.labels, labels, req.weights))
            resp = PartitionResponse(
                uid=req.uid, tenant=req.tenant, labels=labels,
                centers=C[s], influence=infl[s], warm=warm,
                iters=int(total_iters[s]), imbalance=float(imb[s]),
                balanced=bool(imb[s] <= epsilon + 1e-6),
                migration_fraction=mf, tier=cap, time_s=dt,
                stats={name: v[s] for name, v in host_stats.items()
                       if name not in ("counts", "valid")})
            self._store_warm(req.tenant, WarmState(
                centers=C[s], influence=infl[s], labels=labels))
            self.stats["solved"] += 1
            self.stats["warm_hits" if warm else "cold_solves"] += 1
            responses.append(resp)
        return responses


def request_stream(problems: "list[Any]", workload, steps: int,
                   seed_base: int = 0, *,
                   device: torch.device | str | None = None):
    """Yield per-step request lists for a tenant fleet driven by one
    time-evolving workload.

    Args:
        problems: list of ``PartitionProblem``s, one per tenant (tenant id
            = index); each keeps its own n/k/epsilon/seed.
        workload: ``core.meshes`` workload with ``weights_at(points, t)``.
        steps: number of steps T; step 0 is the cold start, steps 1..T-1
            re-weight every tenant (warm hits on a caching server).
        seed_base: added to each problem's seed.
        device: where the weights are computed (float32); None means
            ``cuda``.

    Yields:
        ``list[PartitionRequest]`` per step t in [0, steps).
    """
    dev = resolve_device(device)
    pts = [torch.from_numpy(np.asarray(p.points)).to(dev) for p in problems]
    for t in range(steps):
        batch = []
        for i, prob in enumerate(problems):
            w_t = workload.weights_at(pts[i], t).cpu().numpy()
            batch.append(PartitionRequest(
                tenant=i, points=prob.points, k=prob.k, weights=w_t,
                epsilon=prob.epsilon, seed=prob.seed + seed_base))
        yield batch
