"""``repartition()`` — dynamic repartitioning through the engine
(counterpart of ``repro/partition/repartition.py``)::

    from repro_torch.partition import PartitionProblem, partition, repartition

    prob0 = PartitionProblem(points, k=16, weights=w0)
    prev  = partition(prob0, method="geographer")         # cold start once
    prob1 = prob0.replace(weights=w1)                     # load drifted
    res   = repartition(prob1, prev)                      # warm restart
    res.stats["migration"]["fraction"]                    # weight moved
    res.stats["iters"]                                    # ~0-5, not ~30

Warm-starting from the previous partition's (centers, influence) skips
the SFC bootstrap and the sampled warm-up and moves little weight.
Methods without a warm-startable state (sfc/rcb/rib/multijagged) cold
start and are relabelled by greedy center matching, so block ids stay
stable across steps. The solve, and the refinement when ``refine=`` asks
for one, run on ``device`` (default ``cuda``). ``devices=P`` runs the
solve sharded over P ranks (``distributed.repartition_sharded``; the
previous state is replicated, the communication stays all-reduces),
and the refinement, when asked for, over the same ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.partitioner import geographer_repartition
from repro_torch.device import resolve_device
from repro_torch.dist import launch

from .engine import partition
from .problem import PartitionProblem, PartitionResult
from .refine import refine as _refine
from .refine import resolve_refiner
from .registry import resolve_method, supports_warm_start

# Warm-start movement threshold (x bbox diagonal): a warm start resumes
# next to a converged state, so "centers stopped moving at the scale the
# workload drifted" is the signal, not the tight cold threshold.
WARM_DELTA_TOL = 5e-3

# A warm solve whose final balance pass ends above epsilon is re-warmed
# from its own output state at most this many times.
MAX_BALANCE_RETRIES = 2


@dataclass
class WarmState:
    """The portable warm-start state of a balanced-k-means partition, on
    the host.

    Attributes:
        centers:   [k, d] final centers of the producing solve.
        influence: [k] final influence, or None for all-ones.
        labels:    [n] block ids in the *original* point order (the
            ``prev_assignment`` fed to no-op detection).
    """
    centers: np.ndarray
    influence: np.ndarray | None
    labels: np.ndarray

    def __post_init__(self):
        self.centers = np.asarray(self.centers)
        self.labels = np.asarray(self.labels)
        if self.influence is not None:
            self.influence = np.asarray(self.influence)
        if self.centers.ndim != 2:
            raise ValueError(f"centers must be [k, d], "
                             f"got {self.centers.shape}")
        if (self.influence is not None
                and self.influence.shape != (self.centers.shape[0],)):
            raise ValueError(
                f"influence shape {self.influence.shape} does not match "
                f"k={self.centers.shape[0]}")

    @property
    def n(self) -> int:
        return self.labels.shape[0]

    @property
    def k(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @classmethod
    def capture(cls, result: PartitionResult) -> "WarmState":
        """The warm-start state of ``result``.

        Raises:
            ValueError: the result carries no centers (produced by a
                method without warm-start state, e.g. sfc/rcb).
        """
        if result.centers is None:
            raise ValueError(
                "result carries no centers to warm-start from (was it "
                "produced by a center-based method?)")
        infl = (None if result.influence is None
                else np.asarray(result.influence))
        return cls(centers=np.asarray(result.centers), influence=infl,
                   labels=np.asarray(result.labels))

    def compatible_with(self, n: int, k: int) -> bool:
        """True when this state can warm-start an (n, k) instance."""
        return self.n == n and self.k == k

    def influence_or_ones(self) -> np.ndarray:
        """[k] influence, defaulting to all-ones (the solver's default)."""
        if self.influence is None:
            return np.ones(self.k)
        return self.influence


def weighted_centroids(points: np.ndarray, labels: np.ndarray, k: int,
                       weights: np.ndarray | None = None) -> np.ndarray:
    """[k, d] float64 weighted centroid of every block (empty blocks get
    the global centroid so matching never sees NaNs)."""
    pts = np.asarray(points, np.float64)
    lab = np.asarray(labels)
    w = np.ones(len(lab)) if weights is None else np.asarray(weights,
                                                             np.float64)
    csum = np.zeros((k, pts.shape[1]))
    cw = np.zeros(k)
    np.add.at(csum, lab, pts * w[:, None])
    np.add.at(cw, lab, w)
    fallback = pts.mean(axis=0) if len(pts) else np.zeros(pts.shape[1])
    return np.where(cw[:, None] > 0, csum / np.maximum(cw, 1e-12)[:, None],
                    fallback)


def greedy_center_match(new_centers: np.ndarray,
                        prev_centers: np.ndarray) -> np.ndarray:
    """[k] int64 permutation ``m`` with ``m[new_block] = prev_block``,
    pairing the globally closest unmatched (new, prev) centers first."""
    new_c = np.asarray(new_centers, np.float64)
    prev_c = np.asarray(prev_centers, np.float64)
    if new_c.shape != prev_c.shape:
        raise ValueError(f"center shape mismatch: {new_c.shape} vs "
                         f"{prev_c.shape}")
    k = new_c.shape[0]
    D = ((new_c[:, None, :] - prev_c[None, :, :]) ** 2).sum(axis=-1)
    mapping = np.full(k, -1, np.int64)
    for _ in range(k):
        i, j = np.unravel_index(np.argmin(D), D.shape)
        mapping[i] = j
        D[i, :] = np.inf
        D[:, j] = np.inf
    return mapping


def _migration_stats(previous: PartitionResult, labels: np.ndarray,
                     weights: np.ndarray | None) -> dict:
    vol = float(metrics.migration_volume(previous.labels, labels, weights))
    frac = float(metrics.migration_fraction(previous.labels, labels,
                                            weights))
    return {"volume": vol, "fraction": frac,
            "retained_fraction": 1.0 - frac}


def _check_previous(problem: PartitionProblem, previous: PartitionResult):
    if not isinstance(previous, PartitionResult):
        raise TypeError(f"previous must be a PartitionResult, got "
                        f"{type(previous)}")
    if previous.k != problem.k:
        raise ValueError(f"previous partition has k={previous.k}, "
                         f"problem has k={problem.k}")
    if len(previous.labels) != problem.n:
        raise ValueError(
            f"previous partition labels {len(previous.labels)} points, "
            f"problem has n={problem.n} (repartition requires the same "
            "point set, possibly moved or re-weighted)")


def _warm_geographer(problem: PartitionProblem, previous: PartitionResult,
                     device: torch.device, devices=None,
                     **opts) -> PartitionResult:
    """Warm-started balanced k-means with the balance-retry loop: a solve
    that ends above the effective epsilon is re-warmed from its own
    output, at most ``MAX_BALANCE_RETRIES`` times; ``iters`` adds up.
    With ``devices`` every attempt is a sharded solve."""
    from .algorithms import make_bkm_config
    from .distributed import repartition_sharded
    opts.setdefault("delta_tol", WARM_DELTA_TOL)
    opts["warmup"] = False
    state = WarmState.capture(previous)
    centers, infl = state.centers, state.influence
    prev_labels = state.labels
    # an opts override of epsilon is what the solver balances against
    eps_eff = opts.get("epsilon", problem.epsilon)
    total_iters = 0
    for attempt in range(MAX_BALANCE_RETRIES + 1):
        if devices is not None:
            res = repartition_sharded(problem, devices, centers, infl,
                                      prev_labels=prev_labels,
                                      device=device, **opts)
            iters = res.stats["iters"]
            imb = res.stats["final_imbalance"]
            labels, centers, infl = res.labels, res.centers, res.influence
        else:
            cfg = make_bkm_config(problem, **opts)
            labels, centers, infl, stats = geographer_repartition(
                problem.points, problem.k, centers, infl,
                weights=problem.weights, cfg=cfg, seed=problem.seed,
                prev_labels=prev_labels, device=device)
            iters = int(stats["iters"])
            imb = float(stats["final_imbalance"])
            res = PartitionResult(
                labels=labels, k=problem.k, method="geographer",
                problem=problem, centers=centers, influence=infl,
                stats={"levels": [dict(stats)], "final_imbalance": imb})
        total_iters += iters
        if imb <= eps_eff + 1e-6:
            break
        prev_labels = np.asarray(labels)
    res.stats.update({"warm_start": True, "iters": total_iters,
                      "balance_retries": attempt})
    return res


def _cold_relabel(problem: PartitionProblem, previous: PartitionResult,
                  method: str, device: torch.device, devices=None,
                  **opts) -> PartitionResult:
    res = partition(problem, method=method, device=device, devices=devices,
                    **opts)
    prev_centers = (np.asarray(previous.centers)
                    if previous.centers is not None else
                    weighted_centroids(problem.points, previous.labels,
                                       problem.k, problem.weights))
    new_centers = (np.asarray(res.centers) if res.centers is not None else
                   weighted_centroids(problem.points, res.labels,
                                      problem.k, problem.weights))
    mapping = greedy_center_match(new_centers, prev_centers)
    res.labels = mapping[np.asarray(res.labels)]
    # carry centers/influence into the matched id space too
    for name in ("centers", "influence"):
        value = getattr(res, name)
        if value is not None:
            relabeled = np.empty_like(np.asarray(value))
            relabeled[mapping] = np.asarray(value)
            setattr(res, name, relabeled)
    res.stats.update({"warm_start": False, "relabel_matched": True})
    res.stats.setdefault("iters", _stats_iters(res))
    return res


def _stats_iters(res: PartitionResult):
    """Movement-iteration count of a result, or None for methods without
    an iteration loop (sfc/rcb/...)."""
    if "iters" in res.stats:
        return res.stats["iters"]
    for lvl in res.stats.get("levels", []):
        if lvl.get("iters") is not None:
            v = lvl["iters"]
            return int(np.max(v)) if np.ndim(v) else int(v)
    return None


def repartition(problem: PartitionProblem, previous: PartitionResult,
                method: str = "geographer", *,
                device: torch.device | str | None = None,
                devices: int | None = None, warm: bool | None = None,
                refine=None, refine_eps: float | None = None,
                evaluate: bool = False, with_diameter: bool = False,
                **opts) -> PartitionResult:
    """Repartition ``problem`` starting from ``previous``.

    Args:
        problem: the perturbed instance — the same point set as
            ``previous``, typically with drifted weights.
        previous: the ``PartitionResult`` of the last (re)partition call.
        method: registry name. Warm-startable methods resume balanced
            k-means from ``previous.centers`` / ``previous.influence``;
            all others cold start and are relabel-matched.
        device: where the solve runs; None means ``cuda`` and raises
            without a card.
        devices: run the solve on the sharded path over P ranks (or a
            ``(P1, P2)`` mesh); the previous centers and influence are
            replicated and the communication stays all-reduces.
            ``devices=1`` is bit for bit the single-device path. Outside
            a process group the call launches the ranks itself.
        warm: force (True) or forbid (False) warm starting; None picks
            warm whenever the method supports it and ``previous`` carries
            centers. ``warm=False`` is the fair cold-restart baseline.
        refine: quality-recovery post-pass applied after the warm (or
            cold-relabelled) solve and before the migration accounting —
            True (= ``"label_prop"``) or a refiner registry name, run on
            ``device`` and sharded over ``devices`` when set. Migration is
            then measured on the refined labels,
            the ones the simulation redistributes to.
        refine_eps: balance slack for the refinement budgets (None =
            ``problem.epsilon``); only meaningful with ``refine``.
        evaluate: fill ``result.quality`` with the paper metric set.
        with_diameter: include block diameters in the evaluation.
        **opts: BKMConfig fields for geographer; warm solves default
            ``delta_tol`` to ``WARM_DELTA_TOL`` and force
            ``warmup=False``.

    Returns:
        PartitionResult whose ``stats`` add ``warm_start``, ``iters``
        (cumulative movement iterations; 0 at a fixed point) and
        ``migration`` = {"volume", "fraction", "retained_fraction"}
        measured against ``previous`` under the new weights.

    Raises:
        ValueError: k/n mismatch with ``previous``, or ``warm=True`` for
            a method without warm-start support or a previous result
            without centers.
    """
    if not isinstance(problem, PartitionProblem):
        raise TypeError(
            f"repartition() takes a PartitionProblem, got {type(problem)}")
    _check_previous(problem, previous)
    name = resolve_method(method)
    can_warm = supports_warm_start(name) and previous.centers is not None
    if warm is None:
        warm = can_warm
    elif warm and not supports_warm_start(name):
        raise ValueError(
            f"method {name!r} has no warm-start path; warm=True is "
            "supported by methods registered with supports_warm_start")
    elif warm and previous.centers is None:
        raise ValueError(
            "previous result carries no centers to warm-start from "
            "(was it produced by a center-based method?)")
    if refine is not None and refine is not False:
        refine = resolve_refiner(refine)   # fail fast, before the solve
    else:
        refine = None
    dev = resolve_device(device)
    if launch.needed(devices):
        return launch.run(repartition, devices, device, problem, previous,
                          method, device=device, devices=devices, warm=warm,
                          refine=refine, refine_eps=refine_eps,
                          evaluate=evaluate, with_diameter=with_diameter,
                          **opts)
    if warm:
        res = _warm_geographer(problem, previous, dev, devices, **opts)
    else:
        res = _cold_relabel(problem, previous, name, dev, devices, **opts)
    if refine is not None:
        res = _refine(problem, res, refine, device=dev, devices=devices,
                      eps=refine_eps)
    res.stats["migration"] = _migration_stats(previous, res.labels,
                                              problem.weights)
    if evaluate:
        res.evaluate(with_diameter=with_diameter)
    return res
