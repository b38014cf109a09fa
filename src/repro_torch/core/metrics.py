"""Partition quality metrics (paper Section 2) and migration metrics.
Counterpart of ``repro/core/metrics.py``, host numpy throughout, with
results exactly equal to the reference on host inputs.

* edge cut          — #edges with endpoints in different blocks
* comm volume       — per block V_i: sum over v in V_i of the number of
                      *other* blocks containing a neighbor of v; max and
                      total over blocks (maxCommVol / sum CommVol)
* boundary nodes    — #vertices with a neighbor in another block
* imbalance         — max block weight / (total/k) - 1
* diameter          — per-block graph diameter lower bound (double-sweep
                      BFS, paper §5.2.4)
* migration volume / fraction / retained fraction — weight that changes
                      blocks between two partitions of one point set

The reference also evaluates the migration metrics in-graph on jax
arrays; here torch tensors are accepted and moved to the host first.
"""
from __future__ import annotations

import types

import numpy as np
import torch


def _host(*arrays):
    """Each argument as a numpy array (torch tensors moved to the host);
    None stays None."""
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        out.append(None if a is None else np.asarray(a))
    return out


def imbalance(part: np.ndarray, k: int, weights: np.ndarray | None = None) -> float:
    """``max block weight / (total weight / k) - 1`` (paper §2).

    The unit-weight and weighted branches use the same ``total/k`` target
    (no ceil), so ``imbalance(part, k)`` equals
    ``imbalance(part, k, np.ones(n))`` exactly and both match the balance
    bar the solvers optimize against."""
    if weights is None:
        sizes = np.bincount(part, minlength=k).astype(np.float64)
        target = part.shape[0] / k
    else:
        sizes = np.bincount(part, weights=weights, minlength=k)
        target = weights.sum() / k
    return float(sizes.max() / target - 1.0)


def block_sizes(part: np.ndarray, k: int, weights: np.ndarray | None = None) -> np.ndarray:
    if weights is None:
        return np.bincount(part, minlength=k).astype(np.float64)
    return np.bincount(part, weights=weights, minlength=k)


def migration_volume(prev: np.ndarray, new: np.ndarray,
                     weights: np.ndarray | None = None):
    """Total weight that changed blocks between two partitions.

    ``sum_{v: prev(v) != new(v)} w(v)`` — the amount of simulation data a
    dynamic load balancer would have to move. Unit weights when ``weights``
    is None.

    Args:
        prev: [n] previous block ids.
        new:  [n] new block ids (same point order).
        weights: [n] nonneg node weights, or None.

    Returns:
        float64 numpy scalar.
    """
    prev, new, weights = _host(prev, new, weights)
    moved = prev != new
    if weights is None:
        return np.sum(moved.astype(np.float64))
    return np.sum(np.where(moved, weights, 0.0))


def migration_fraction(prev: np.ndarray, new: np.ndarray,
                       weights: np.ndarray | None = None):
    """``migration_volume / total_weight`` in [0, 1] — the fraction of the
    workload that moves. Args/Returns as ``migration_volume``."""
    prev, new, weights = _host(prev, new, weights)
    total = prev.shape[0] if weights is None else np.sum(weights)
    return migration_volume(prev, new, weights) / np.maximum(total, 1e-12)


def retained_fraction(prev: np.ndarray, new: np.ndarray,
                      weights: np.ndarray | None = None):
    """``1 - migration_fraction``: the fraction of weight that stays in
    its block across a repartition step. Args/Returns as
    ``migration_volume``."""
    return 1.0 - migration_fraction(prev, new, weights)


def batch_imbalance(labels, k: int, weights):
    """Per-slot imbalance on a padded slot batch (the serving layer's
    metric): ``max_b W_b / (W/k) - 1`` for every slot independently.

    Padded entries carry weight 0 (the engine-wide padding discipline:
    replicated real points, zero weight) so they drop out of both the
    block weights and the per-slot total exactly.

    Args:
        labels:  [S, cap] block ids in [0, k) (padding rows may repeat
            real labels — their zero weight silences them).
        k:       number of blocks (shared by every slot in the bucket).
        weights: [S, cap] nonneg node weights, 0 on padded entries.

    Returns:
        [S] per-slot imbalance (numpy).
    """
    labels, weights = _host(labels, weights)
    lab = np.asarray(labels)
    w = np.asarray(weights, np.float64)
    out = np.empty(lab.shape[0])
    for s in range(lab.shape[0]):
        sizes = np.bincount(lab[s], weights=w[s], minlength=k)
        out[s] = sizes.max() / max(w[s].sum() / k, 1e-12) - 1.0
    return out


def batch_migration_fraction(prev, new, weights):
    """Per-slot migration fraction on a padded slot batch: the fraction
    of each slot's weight that changed blocks between ``prev`` and
    ``new``. Padded entries (weight 0) drop out exactly.

    Args:
        prev:    [S, cap] previous block ids.
        new:     [S, cap] new block ids (same padded point order).
        weights: [S, cap] nonneg node weights, 0 on padded entries.

    Returns:
        [S] per-slot fraction in [0, 1] (numpy).
    """
    prev, new, w = _host(prev, new, weights)
    moved = np.sum(np.where(prev != new, w, 0.0), axis=1)
    return moved / np.maximum(np.sum(w, axis=1), 1e-12)


# fixed-point scale for quantize_weights: the total quantized weight fits
# int32 (32-bit device integers) with headroom, so integer sums of quantized
# weights are EXACT on host numpy and under any psum order alike — the
# same "integer counts commute" discipline the sharded metrics rely on
WEIGHT_QUANT_TOTAL = (1 << 30) - 1


def quantize_weights(weights: np.ndarray | None, n: int) -> np.ndarray:
    """[n] int64 fixed-point node weights for exact integer balance
    arithmetic (the refinement budget protocol, DESIGN.md §11).

    Unit weights (``weights is None``) map to exactly 1 per node — no
    quantization error at all. Float weights are scaled so the total is
    ~``WEIGHT_QUANT_TOTAL`` (fits int32) and rounded to nearest; each
    node's error is <= 0.5 units, which the budget margin in
    ``partition.refine`` absorbs.

    Args:
        weights: [n] nonneg float node weights, or None.
        n: point count (fixes the unit-weight output length).

    Returns:
        [n] int64 quantized weights, every entry >= 0.

    Raises:
        ValueError: negative weights or an all-zero total.
    """
    if weights is None:
        return np.ones(n, np.int64)
    w = np.asarray(weights, np.float64)
    if w.shape != (n,):
        raise ValueError(f"weights must be [{n}], got {w.shape}")
    if np.any(w < 0):
        raise ValueError("weights must be nonnegative")
    total = float(w.sum())
    if total <= 0:
        raise ValueError("total weight must be positive")
    return np.round(w * (WEIGHT_QUANT_TOTAL / total)).astype(np.int64)


def edge_cut(part: np.ndarray, indptr: np.ndarray, indices: np.ndarray) -> int:
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return int((part[src] != part[indices]).sum() // 2)


def _distinct_remote_pairs(part: np.ndarray, indptr: np.ndarray,
                           indices: np.ndarray) -> tuple[np.ndarray, int]:
    """Distinct (vertex, remote block) adjacency pairs, vectorized.

    Unique-per-row formulation: expand the CSR rows to a directed edge
    list, keep the cut edges, lexsort by (vertex, neighbor block) and drop
    adjacent duplicates — no per-node Python loop and no ``v * k + block``
    key that could overflow. Returns ``(v, n_pairs)`` where ``v`` holds
    the source vertex of each distinct pair (``comm_volume`` bins them by
    block; ``boundary_nodes`` only needs which vertices appear)."""
    n = len(indptr) - 1
    src = np.repeat(np.arange(n), np.diff(indptr))
    nb_block = part[indices]
    remote = nb_block != part[src]
    v, b = src[remote], nb_block[remote]
    order = np.lexsort((b, v))
    v, b = v[order], b[order]
    first = np.ones(v.shape[0], dtype=bool)
    first[1:] = (v[1:] != v[:-1]) | (b[1:] != b[:-1])
    return v[first], int(first.sum())


def comm_volume(part: np.ndarray, indptr: np.ndarray, indices: np.ndarray,
                k: int) -> tuple[int, int, np.ndarray]:
    """Returns (max_comm, total_comm, per_block_comm).

    comm(V_i) = sum_{v in V_i} #{distinct blocks j != part(v) adjacent to v}.
    """
    v, _ = _distinct_remote_pairs(part, indptr, indices)
    per_block = np.bincount(part[v], minlength=k)
    return int(per_block.max(initial=0)), int(per_block.sum()), per_block


def boundary_nodes(part: np.ndarray, indptr: np.ndarray, indices: np.ndarray,
                   k: int) -> tuple[int, np.ndarray]:
    """Returns (total, per_block) boundary-vertex counts.

    A vertex is a boundary node when at least one neighbor lives in a
    different block — exactly the vertices whose data a parallel solver
    ships every halo exchange (the comm volume counts how many *copies*
    go out; this counts the senders)."""
    v, _ = _distinct_remote_pairs(part, indptr, indices)
    boundary = np.unique(v)
    per_block = np.bincount(part[boundary], minlength=k)
    return int(per_block.sum()), per_block


def _bfs_ecc(indptr: np.ndarray, indices: np.ndarray, sub: np.ndarray,
             start: int) -> tuple[int, int, int]:
    """BFS inside vertex subset ``sub`` (bool mask). Returns
    (ecc, farthest, n_reached) — the reach count doubles as the
    connectivity check, so no separate sweep is needed."""
    n = len(indptr) - 1
    dist = np.full(n, -1, dtype=np.int64)
    dist[start] = 0
    frontier = np.array([start], dtype=np.int64)
    d = 0
    last = start
    reached = 1
    while frontier.size:
        nxt = []
        for u in frontier:
            nbrs = indices[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[sub[nbrs] & (dist[nbrs] < 0)]
            dist[nbrs] = d + 1
            nxt.append(nbrs)
        frontier = np.concatenate(nxt) if nxt else np.zeros(0, np.int64)
        if frontier.size:
            d += 1
            last = int(frontier[-1])
            reached += frontier.size
    return d, last, reached


def block_diameters(part: np.ndarray, indptr: np.ndarray, indices: np.ndarray,
                    k: int, rounds: int = 3) -> np.ndarray:
    """Double-sweep BFS lower bound on each block's diameter.

    Disconnected blocks get +inf (paper aggregates with harmonic mean to
    absorb these). Exactly ``rounds`` BFS sweeps per block: the first
    sweep (from the block's first member) supplies the eccentricity, the
    double-sweep restart vertex AND the reach count for the connectivity
    verdict in one O(V+E) pass."""
    n = len(indptr) - 1
    diams = np.zeros(k, dtype=np.float64)
    for b in range(k):
        members = np.where(part == b)[0]
        if members.size == 0:
            continue
        sub = np.zeros(n, dtype=bool)
        sub[members] = True
        start = int(members[0])
        best, cur, reached = _bfs_ecc(indptr, indices, sub, start)
        for _ in range(rounds - 1):
            ecc, far, _ = _bfs_ecc(indptr, indices, sub, cur)
            best = max(best, ecc)
            cur = far
        diams[b] = best if reached == members.size else np.inf
    return diams


def harmonic_mean(x: np.ndarray) -> float:
    x = np.asarray(x, dtype=np.float64)
    x = x[x > 0]
    if x.size == 0:
        return 0.0
    return float(x.size / np.sum(1.0 / x))


def evaluate_problem(problem, labels: np.ndarray,
                     with_diameter: bool = False) -> dict:
    """Metric set for a ``partition.PartitionProblem`` (duck-typed: needs
    .k/.weights and optionally .indptr/.indices). Graph metrics are
    included only when the problem carries a CSR adjacency — geometric
    problems without a graph still get balance metrics."""
    labels = np.asarray(labels)
    out = {
        "imbalance": imbalance(labels, problem.k, problem.weights),
        "n_blocks_used": int(len(np.unique(labels))),
    }
    if getattr(problem, "indptr", None) is not None:
        # one O(m log m) distinct-pair pass feeds both volume metrics
        v, _ = _distinct_remote_pairs(labels, problem.indptr,
                                      problem.indices)
        per_block = np.bincount(labels[v], minlength=problem.k)
        out["cut"] = edge_cut(labels, problem.indptr, problem.indices)
        out["maxCommVol"] = int(per_block.max(initial=0))
        out["totalCommVol"] = int(per_block.sum())
        out["boundaryNodes"] = int(np.unique(v).size)
        if with_diameter:
            d = block_diameters(labels, problem.indptr, problem.indices,
                                problem.k)
            out["diameter_harmonic_mean"] = harmonic_mean(d[np.isfinite(d)])
            out["n_disconnected"] = int(np.sum(~np.isfinite(d)))
    return out


def evaluate_partition(mesh, part: np.ndarray, k: int,
                       with_diameter: bool = False) -> dict:
    """Metric set for a ``meshes.Mesh`` + label array (legacy signature;
    delegates to ``evaluate_problem`` — a Mesh duck-types everything but
    ``k``)."""
    shim = types.SimpleNamespace(k=k, weights=mesh.weights,
                                 indptr=mesh.indptr, indices=mesh.indices)
    return evaluate_problem(shim, part, with_diameter=with_diameter)
