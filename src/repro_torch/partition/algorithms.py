"""Registry adapters for the five flat partitioners (counterpart of
``repro/partition/algorithms.py``):

* ``geographer``        — SFC bootstrap + balanced k-means (the paper),
                          on ``device`` (default ``cuda``), sharded over
                          ``devices=P`` ranks (``distributed.py``);
* ``sfc``  (alias hsfc) — Hilbert-curve chunking;
* ``rcb``               — recursive coordinate bisection;
* ``rib``               — recursive inertial bisection;
* ``multijagged`` (mj)  — one-shot multisection.

The four baselines are host numpy algorithms in both packages; they take
``device`` only so every method shares the front door's signature.
``**opts`` for ``geographer`` go into ``BKMConfig``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import baselines
from repro_torch.core.balanced_kmeans import BKMConfig
from repro_torch.core.partitioner import geographer_partition

from .problem import PartitionProblem, PartitionResult
from .registry import register_algorithm

_BKM_FIELDS = {f.name for f in dataclasses.fields(BKMConfig)}


def make_bkm_config(problem: PartitionProblem, k: int | None = None,
                    **opts) -> BKMConfig:
    """BKMConfig for ``problem`` with per-call overrides (unknown keys are
    rejected so typos don't silently fall back to defaults)."""
    bad = set(opts) - _BKM_FIELDS
    if bad:
        raise TypeError(f"unknown BKMConfig options {sorted(bad)}")
    kw = {"k": k if k is not None else problem.k,
          "epsilon": problem.epsilon, **opts}
    return BKMConfig(**kw)


@register_algorithm("geographer", aliases=("balanced_kmeans", "bkm"),
                    supports_devices=True, supports_warm_start=True)
def _geographer(problem: PartitionProblem, device=None,
                devices: int | tuple[int, int] | None = None,
                bootstrap: str | None = None, chunk: int | None = None,
                **opts) -> PartitionResult:
    if devices is not None:
        from .distributed import partition_sharded
        return partition_sharded(problem, devices, device=device,
                                 bootstrap=bootstrap or "host",
                                 chunk=chunk, **opts)
    if bootstrap is not None:
        raise TypeError("bootstrap= only applies to the multi-device path "
                        "(pass devices=)")
    if chunk is not None:
        raise TypeError("chunk= streams the sharded deal and only applies "
                        "to the multi-device path (pass devices=)")
    cfg = make_bkm_config(problem, **opts)
    labels, centers, infl, stats = geographer_partition(
        problem.points, problem.k, weights=problem.weights, cfg=cfg,
        seed=problem.seed, return_state=True, device=device)
    # centers/influence ride on the result as the warm-start state
    return PartitionResult(
        labels=np.asarray(labels, np.int64), k=problem.k,
        method="geographer", problem=problem,
        centers=centers, influence=infl,
        stats={"levels": [dict(stats)],
               "final_imbalance": float(stats["final_imbalance"])})


def _baseline_result(problem, labels, method) -> PartitionResult:
    labels = np.asarray(labels, np.int64)
    res = PartitionResult(labels=labels, k=problem.k, method=method,
                          problem=problem)
    res.stats = {"levels": [{}],
                 "final_imbalance": res.imbalance()}
    return res


@register_algorithm("sfc", aliases=("hsfc", "hilbert"),
                    supports_devices=False, supports_warm_start=False)
def _sfc(problem: PartitionProblem, device=None, **opts) -> PartitionResult:
    if opts:
        raise TypeError(f"sfc takes no options, got {sorted(opts)}")
    labels = baselines.sfc_partition(problem.points, problem.k,
                                     problem.weights)
    return _baseline_result(problem, labels, "sfc")


@register_algorithm("rcb", supports_devices=False,
                    supports_warm_start=False)
def _rcb(problem: PartitionProblem, device=None, **opts) -> PartitionResult:
    labels = baselines.rcb(problem.points, problem.k, problem.weights,
                           **opts)
    return _baseline_result(problem, labels, "rcb")


@register_algorithm("rib", supports_devices=False,
                    supports_warm_start=False)
def _rib(problem: PartitionProblem, device=None, **opts) -> PartitionResult:
    if opts:
        raise TypeError(f"rib takes no options, got {sorted(opts)}")
    labels = baselines.rib(problem.points, problem.k, problem.weights)
    return _baseline_result(problem, labels, "rib")


@register_algorithm("multijagged", aliases=("mj",),
                    supports_devices=False, supports_warm_start=False)
def _multijagged(problem: PartitionProblem, device=None,
                 **opts) -> PartitionResult:
    if opts:
        raise TypeError(f"multijagged takes no options, got {sorted(opts)}")
    labels = baselines.multijagged(problem.points, problem.k,
                                   problem.weights)
    return _baseline_result(problem, labels, "multijagged")
