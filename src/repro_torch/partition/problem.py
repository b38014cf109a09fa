"""Problem/result dataclasses of the partitioning front door.
Counterpart of ``repro/partition/problem.py``.

``PartitionProblem`` is the input every algorithm consumes: a point cloud
with optional node weights and an optional CSR graph (for the quality
metrics), plus the balance constraint (k, epsilon). ``PartitionResult``
is the output: labels, optional centers / influence, stats and lazily
computed quality metrics. The sharded views and refinement raise
``NotYetPortedError`` until their slices land.
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
        """Sharded view for the multi-device engine (not ported yet)."""
        raise NotYetPortedError(
            "PartitionProblem.to_sharded: the multi-device path comes "
            "with the torch.distributed slice")

    def to_sharded_graph(self, devices: int):
        """Sharded CSR view for distributed evaluation (not ported yet)."""
        raise NotYetPortedError(
            "PartitionProblem.to_sharded_graph: sharded evaluation comes "
            "with the torch.distributed slice")


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
                 devices: int | None = None) -> dict:
        """Compute (and cache at ``self.quality``) the paper's quality
        metric set.

        Args:
            with_diameter: also compute per-block diameter bounds (BFS —
                noticeably slower on large meshes; host path only).
            devices: sharded evaluation; not ported yet (raises
                ``NotYetPortedError``). None keeps the host numpy path.

        Returns:
            dict with ``imbalance`` / ``n_blocks_used`` always, plus
            ``cut`` / ``maxCommVol`` / ``totalCommVol`` /
            ``boundaryNodes`` (and diameter stats) when the problem
            carries a CSR graph.

        Raises:
            ValueError: the result has no problem attached.
            NotYetPortedError: ``devices`` is given.
        """
        from repro_torch.core import metrics
        if self.problem is None:
            raise ValueError("result has no problem attached")
        if devices is not None:
            raise NotYetPortedError(
                "PartitionResult.evaluate(devices=...): sharded evaluation "
                "comes with the torch.distributed slice")
        self.quality = metrics.evaluate_problem(
            self.problem, np.asarray(self.labels),
            with_diameter=with_diameter)
        return self.quality

    def refine(self, method="label_prop", *, devices: int | None = None,
               eps: float | None = None, evaluate: bool = False,
               **opts) -> "PartitionResult":
        """Quality-recovery post-pass (not ported yet)."""
        raise NotYetPortedError(
            "PartitionResult.refine: label-propagation refinement comes "
            "with the refinement slice")

    def summary(self) -> dict[str, Any]:
        out = {"method": self.method, "k": self.k,
               "imbalance": self.imbalance(),
               "n_blocks_used": int(len(np.unique(self.labels)))}
        if self.quality:
            out.update(self.quality)
        return out
