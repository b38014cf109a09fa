"""Hierarchical (k = k1 x k2) recursive partitioning (counterpart of
``repro/partition/hierarchical.py``).

A *coarse* pass cuts the points into k1 blocks, then every block is
refined into k2 sub-blocks; block b owns the final label range
[b*k2, (b+1)*k2). The coarse pass runs with the tighter budget eps1
(default epsilon/2, the full epsilon when k2 == 1), so every block's
weight is at most (1 + eps1) * W / k1; each refinement then balances
against the *global* target W / (k1*k2) with the full epsilon, which
keeps the global imbalance within epsilon.

With ``refine_method="geographer"`` the k1 subproblems go through
``batched_balanced_kmeans`` on the device (one lane after another); any
other registered method refines block by block on the host.

``devices=P`` runs the coarse cut on the sharded path over P ranks (the
global pass is where the data is big) and keeps the refinement on every
rank; ``devices=(P1, P2)`` shards the coarse cut over all P1*P2 ranks
(equal to ``devices=P1*P2`` bit for bit) and splits the refinement
blocks over the refine axis (``sharded_batched_balanced_kmeans``, equal
to ``batched_balanced_kmeans`` bit for bit), so the composition equals
the flat one label for label.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.sfc import sfc_initial_centers
from repro_torch.device import resolve_device
from repro_torch.dist import launch

from .batched import (batched_balanced_kmeans, build_refinement_batch,
                      sequential_balanced_kmeans,
                      sharded_batched_balanced_kmeans)
from .problem import PartitionProblem, PartitionResult
from .registry import get_algorithm, resolve_method, supports_devices

_KMEANS_METHODS = {"geographer"}


def factor_k(k: int) -> tuple[int, int]:
    """Split k into (k1, k2) with k1 the largest divisor <= sqrt(k)."""
    k1 = max(d for d in range(1, int(np.sqrt(k)) + 1) if k % d == 0)
    return k1, k // k1


def hierarchical_partition(problem: PartitionProblem,
                           k1: int | None = None, k2: int | None = None, *,
                           method: str = "geographer",
                           refine_method: str = "geographer",
                           batched: bool = True,
                           device: torch.device | str | None = None,
                           devices=None, chunk: int | None = None,
                           coarse_epsilon: float | None = None,
                           coarse_opts: dict | None = None,
                           refine_opts: dict | None = None
                           ) -> PartitionResult:
    """Two-level partition of ``problem`` into k = k1*k2 blocks.

    Args:
        problem: instance with ``problem.k == k1*k2``.
        k1, k2: hierarchy factors; None auto-factors via ``factor_k``.
        method: registry name for the coarse k1-way cut.
        refine_method: registry name refining each block into k2
            sub-blocks.
        batched: refine the k-means blocks through
            ``batched_balanced_kmeans`` (False: the one-lane-a-call
            ``sequential_balanced_kmeans``; the same bits).
        device: where the solves run; None means ``cuda``.
        devices: run the coarse cut on the sharded path over P ranks. An
            int P keeps the refinement whole on every rank; a
            ``(P1, P2)`` tuple shards the coarse cut over all P1*P2 ranks
            (bit-identical to ``devices=P1*P2``) and splits the k1
            refinement blocks over the refine axis (bit-identical to the
            unsplit refinement).
        chunk: the sharded deal's slice size; only with ``devices=``.
        coarse_epsilon: balance budget of the coarse pass (default
            epsilon/2).
        coarse_opts, refine_opts: per-level algorithm options.

    Returns:
        ``PartitionResult`` with k1*k2 blocks, block b owning label range
        [b*k2, (b+1)*k2), and per-level entries in ``stats["levels"]``.

    Raises:
        ValueError: k1*k2 != problem.k, a coarse block too small to
            refine, ``chunk=`` without ``devices=``, or ``devices=`` with
            a coarse method that has no multi-device path.
    """
    if k1 is None or k2 is None:
        k1, k2 = factor_k(problem.k)
    if k1 * k2 != problem.k:
        raise ValueError(f"k1*k2 = {k1}*{k2} != k = {problem.k}")
    coarse_name = resolve_method(method)
    refine_name = resolve_method(refine_method)
    if devices is not None:
        if not supports_devices(coarse_name):
            raise ValueError(
                f"coarse method {coarse_name!r} has no multi-device path; "
                "devices= requires a supports_devices method")
        coarse_opts = dict(coarse_opts or {}, devices=devices)
        if chunk is not None:
            coarse_opts.setdefault("chunk", chunk)
    elif chunk is not None:
        raise ValueError("chunk= streams the sharded deal and needs "
                         "devices=")
    dev = resolve_device(device)
    if launch.needed(devices):
        return launch.run(hierarchical_partition, devices, device, problem,
                          k1, k2, method=method, refine_method=refine_method,
                          batched=batched, device=device, devices=devices,
                          chunk=chunk, coarse_epsilon=coarse_epsilon,
                          coarse_opts=coarse_opts, refine_opts=refine_opts)
    # a (P1, P2) tuple also splits the refinement blocks over the refine
    # axis of the 2-D mesh (an int keeps the refinement whole)
    mesh2d = (tuple(int(d) for d in devices)
              if isinstance(devices, (tuple, list)) else None)
    dev_stat = list(mesh2d) if mesh2d is not None else devices
    eps = problem.epsilon
    # no refinement follows when k2 == 1, so the coarse pass gets the full
    # budget instead of the tightened split
    eps1 = (coarse_epsilon if coarse_epsilon is not None
            else (eps if k2 == 1 else eps / 2.0))

    # ---- level 1: coarse k1 blocks (tighter budget eps1)
    coarse_problem = problem.replace(k=k1, epsilon=eps1)
    t0 = time.perf_counter()
    coarse = get_algorithm(coarse_name)(coarse_problem, device=dev,
                                        **(coarse_opts or {}))
    clabels = np.asarray(coarse.labels)
    t1 = time.perf_counter()
    # "seconds": host clock of the level (the labels on the host end it)
    coarse_level = {"method": coarse_name, "k": k1, "epsilon": eps1,
                    "devices": dev_stat, "imbalance": coarse.imbalance(),
                    "seconds": t1 - t0}
    if k2 == 1:
        result = PartitionResult(
            labels=clabels, k=k1,
            method=f"hierarchical({coarse_name}x{refine_name})",
            problem=problem, centers=coarse.centers,
            influence=coarse.influence)
        result.stats = {
            "k1": k1, "k2": 1,
            "levels": [coarse_level,
                       {"method": refine_name, "k": 1, "epsilon": eps,
                        "batched": False, "dispatches": 0}],
            "final_imbalance": result.imbalance(),
        }
        return result

    # ---- level 2: refine every block against the GLOBAL target W/(k1*k2)
    labels = np.empty(problem.n, np.int64)
    refine_opts = dict(refine_opts or {})
    if refine_name in _KMEANS_METHODS:
        from .algorithms import make_bkm_config
        refine_opts.setdefault("warmup", False)
        cfg = make_bkm_config(problem, k=k2, **refine_opts)
        bpts, bw, gather, counts = build_refinement_batch(
            problem.points, problem.weights, clabels, k1)
        if counts.min() < k2:
            raise ValueError(
                f"coarse block with {int(counts.min())} points cannot be "
                f"refined into k2={k2} sub-blocks (n={problem.n} too small "
                f"for k={k1 * k2})")
        w_host = (np.ones(problem.n) if problem.weights is None
                  else np.asarray(problem.weights, np.float64))
        centers0 = np.stack([
            sfc_initial_centers(bpts[b, :counts[b]], k2,
                                w_host[gather[b, :counts[b]]])
            for b in range(k1)])
        target = problem.total_weight / (k1 * k2)
        t2 = time.perf_counter()
        if mesh2d is not None and batched:
            # blocks over the refine axis, bit for bit the unsplit solve
            sub, centers, infl, stats = sharded_batched_balanced_kmeans(
                bpts, bw, centers0, cfg, devices=mesh2d,
                target_weight=target, device=dev)
        else:
            runner = (batched_balanced_kmeans if batched
                      else sequential_balanced_kmeans)
            sub, centers, infl, stats = runner(bpts, bw, centers0, cfg,
                                               target_weight=target,
                                               device=dev)
        sub = sub.cpu().numpy()
        for b in range(k1):
            ids = gather[b, :counts[b]]
            labels[ids] = b * k2 + sub[b, :counts[b]]
        refine_stats = {
            "imbalance_vs_global_target":
                stats["final_imbalance"].cpu().numpy().tolist(),
            "iters": stats["iters"].cpu().numpy().tolist(),
            "batched": batched, "dispatches": 1 if batched else k1,
            "refine_devices": (list(mesh2d)
                               if mesh2d is not None and batched
                               else None),
            # host seconds of the refinement batch and the k1 bootstraps
            "prep_seconds": t2 - t1}
        centers_out = centers.cpu().numpy().reshape(k1 * k2, -1)
        infl_out = infl.cpu().numpy().reshape(k1 * k2)
    else:
        for b in range(k1):
            ids = np.where(clabels == b)[0]
            subp = PartitionProblem(
                points=problem.points[ids], k=k2,
                weights=None if problem.weights is None
                else problem.weights[ids],
                epsilon=eps, seed=problem.seed + b + 1,
                name=f"{problem.name}/block{b}")
            subres = get_algorithm(refine_name)(subp, device=dev)
            labels[ids] = b * k2 + np.asarray(subres.labels)
        refine_stats = {"batched": False, "dispatches": k1}
        centers_out = infl_out = None

    refine_stats["seconds"] = time.perf_counter() - t1
    result = PartitionResult(
        labels=labels, k=k1 * k2,
        method=f"hierarchical({coarse_name}x{refine_name})",
        problem=problem, centers=centers_out, influence=infl_out)
    result.stats = {
        "k1": k1, "k2": k2,
        "levels": [coarse_level,
                   {"method": refine_name, "k": k2, "epsilon": eps,
                    **refine_stats}],
        "final_imbalance": result.imbalance(),
    }
    return result
