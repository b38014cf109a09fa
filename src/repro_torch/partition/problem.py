"""Problem/result dataclasses of the partitioning front door.
Counterpart of ``repro/partition/problem.py``.

``PartitionProblem`` is the input every algorithm consumes: a point cloud
with optional node weights and an optional CSR graph (for the quality
metrics), plus the balance constraint (k, epsilon). ``PartitionResult``
is the output: labels, optional centers / influence, stats and lazily
computed quality metrics, on the host or sharded over ranks
(``evaluate(devices=)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


class NotYetPortedError(NotImplementedError):
    """A feature of the JAX package that the port has not reached yet;
    the message names the slice that brings it (see ROADMAP.md)."""


@dataclass(frozen=True)
class PartitionProblem:
    """One partitioning instance.

    Attributes:
        points: [n, d] float coordinates; d in {2, 3} for the SFC-based
            methods.
        k: number of blocks, ``1 <= k <= n``.
        weights: [n] nonneg float node weights, or None (= unit weights).
        epsilon: balance slack — every block must end with weight
            ``<= (1 + epsilon) * W/k``.
        indptr, indices: optional CSR adjacency (metrics only — the
            geometric partitioners never read the graph, exactly like the
            paper). Must be given together.
        seed: permutation seed (warm-up sampling order + sharded layout).
        name: label used in benchmark tables.
    """
    points: np.ndarray
    k: int
    weights: np.ndarray | None = None
    epsilon: float = 0.03
    indptr: np.ndarray | None = None
    indices: np.ndarray | None = None
    seed: int = 0
    name: str = "problem"

    def __post_init__(self):
        pts = np.asarray(self.points)
        if pts.ndim != 2:
            raise ValueError(f"points must be [n, d], got {pts.shape}")
        if not (1 <= self.k <= pts.shape[0]):
            raise ValueError(f"k={self.k} out of range for n={pts.shape[0]}")
        if self.weights is not None and len(self.weights) != pts.shape[0]:
            raise ValueError("weights length mismatch")
        if (self.indptr is None) != (self.indices is None):
            raise ValueError("indptr and indices must be given together")
        # store the normalized arrays (frozen dataclass -> object.__setattr__)
        object.__setattr__(self, "points", pts)
        for name in ("weights", "indptr", "indices"):
            v = getattr(self, name)
            if v is not None:
                object.__setattr__(self, name, np.asarray(v))

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def has_graph(self) -> bool:
        return self.indptr is not None

    @property
    def total_weight(self) -> float:
        if self.weights is None:
            return float(self.n)
        return float(np.sum(self.weights))

    @property
    def target_weight(self) -> float:
        """Ideal per-block weight W/k (the denominator of the imbalance)."""
        return self.total_weight / self.k

    @classmethod
    def from_mesh(cls, mesh, k: int, epsilon: float = 0.03,
                  seed: int = 0) -> "PartitionProblem":
        """Build a problem from a ``core.meshes.Mesh``.

        Args:
            mesh: a Mesh (points + CSR graph + optional 2.5D weights).
            k: number of blocks.
            epsilon: balance slack (default 0.03, the paper's setting).
            seed: permutation seed.

        Returns:
            A ``PartitionProblem`` carrying the mesh's graph for metrics.
        """
        return cls(points=mesh.points, k=k, weights=mesh.weights,
                   epsilon=epsilon, indptr=mesh.indptr, indices=mesh.indices,
                   seed=seed, name=mesh.name)

    def replace(self, **kw) -> "PartitionProblem":
        """A copy with ``kw`` fields replaced (validation re-runs) — the
        idiom for perturbing a problem between ``repartition`` steps,
        e.g. ``problem.replace(weights=w_t)``."""
        import dataclasses
        return dataclasses.replace(self, **kw)

    def to_sharded(self, devices: int, chunk: int | None = None):
        """Static-shape sharded view for the multi-device engine: points
        and weights dealt round-robin over ``devices`` shards (source
        dtype preserved) and padded to a common per-shard cap; ``chunk``
        streams the deal in bounded host slices with the same bits (see
        partition/distributed.py)."""
        from .distributed import ShardedPartitionProblem
        return ShardedPartitionProblem.from_problem(self, devices,
                                                    chunk=chunk)

    def to_sharded_graph(self, devices: int):
        """Sharded CSR companion view for the sharded evaluation: the
        graph's rows dealt onto the same seed-permuted round-robin layout
        as ``to_sharded`` (see repro_torch.eval.sharded). Requires the
        problem to carry a CSR adjacency."""
        from repro_torch.eval.sharded import ShardedGraph
        return ShardedGraph.from_problem(self, devices)


@dataclass
class PartitionResult:
    """Output of ``partition()`` / ``repartition()``.

    Attributes:
        labels: [n] int64 block ids in [0, k), original point order.
        k: number of blocks.
        method: registry name that produced the result.
        problem: the source problem (weights/graph for lazy metrics).
        centers: [k, d] final k-means centers (center-based methods only)
            — together with ``influence`` this is the warm-start state
            ``repartition()`` resumes from.
        influence: [k] final influence (paper Eq. 1 state).
        stats: solver statistics; per-level entries under ``"levels"``.
            ``repartition()`` adds ``warm_start``, ``iters``,
            ``balance_retries`` and ``migration``.
        quality: lazily computed paper metric set (see ``evaluate``).
    """
    labels: np.ndarray
    k: int
    method: str
    problem: PartitionProblem | None = None
    centers: np.ndarray | None = None
    influence: np.ndarray | None = None
    stats: dict = field(default_factory=dict)
    quality: dict | None = None

    def imbalance(self) -> float:
        """Measured global imbalance max_b W_b / (W/k) - 1."""
        from repro_torch.core import metrics
        w = None if self.problem is None else self.problem.weights
        return metrics.imbalance(np.asarray(self.labels), self.k, w)

    def block_sizes(self) -> np.ndarray:
        from repro_torch.core import metrics
        w = None if self.problem is None else self.problem.weights
        return metrics.block_sizes(np.asarray(self.labels), self.k, w)

    def evaluate(self, with_diameter: bool = False,
                 devices: int | None = None, *, device=None) -> dict:
        """Compute (and cache at ``self.quality``) the paper's quality
        metric set.

        Args:
            with_diameter: also compute per-block diameter bounds (BFS —
                noticeably slower on large meshes; host path only).
            devices: compute the graph metrics over P ranks
                (``repro_torch.eval.evaluate_sharded``, equal to the host
                metrics). None keeps the host numpy path.
            device: the ranks' device with ``devices`` (None: ``cuda``).

        Returns:
            dict with ``imbalance`` / ``n_blocks_used`` always, plus
            ``cut`` / ``maxCommVol`` / ``totalCommVol`` /
            ``boundaryNodes`` (and diameter stats) when the problem
            carries a CSR graph.

        Raises:
            ValueError: the result has no problem attached, or
                ``devices`` is combined with ``with_diameter``.
        """
        from repro_torch.core import metrics
        if self.problem is None:
            raise ValueError("result has no problem attached")
        if devices is not None:
            if with_diameter:
                raise ValueError("with_diameter has no sharded path; "
                                 "call evaluate(with_diameter=True) "
                                 "without devices=")
            from repro_torch.eval import evaluate_sharded
            self.quality = evaluate_sharded(
                self.problem, np.asarray(self.labels), devices,
                device=device)
            return self.quality
        self.quality = metrics.evaluate_problem(
            self.problem, np.asarray(self.labels),
            with_diameter=with_diameter)
        return self.quality

    def refine(self, method="label_prop", *, device=None,
               devices=None, eps: float | None = None,
               evaluate: bool = False, **opts) -> "PartitionResult":
        """Quality-recovery post-pass over this result's labels (the
        ``repro_torch.partition.refine`` front door bound to ``self``).

        Args:
            method: refiner registry name (default size-constrained label
                propagation).
            device: where the rounds run; None means ``cuda`` and raises
                without a card.
            devices: None = one device; P (or ``(P1, P2)``) = the rounds
                sharded over P ranks, bit for bit equal (launched by this
                call outside a process group).
            eps: balance slack for the refinement budgets (None = the
                problem's epsilon).
            evaluate: fill ``quality`` on the refined result.
            **opts: forwarded to the refiner (e.g. ``max_rounds``).

        Returns:
            A new ``PartitionResult`` with refined labels, ``method``
            suffixed (e.g. ``"geographer+lp"``) and
            ``stats["refine"]`` recording rounds/moves/cut delta.

        Raises:
            ValueError: the result has no problem attached, or the
                problem carries no CSR graph.
        """
        if self.problem is None:
            raise ValueError("result has no problem attached")
        from .refine import refine as _refine
        return _refine(self.problem, self, method, device=device,
                       devices=devices, eps=eps, evaluate=evaluate, **opts)

    def summary(self) -> dict[str, Any]:
        out = {"method": self.method, "k": self.k,
               "imbalance": self.imbalance(),
               "n_blocks_used": int(len(np.unique(self.labels)))}
        if self.quality:
            out.update(self.quality)
        return out
