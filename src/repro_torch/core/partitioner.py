"""Geographer on one device: SFC bootstrap + balanced k-means (paper
Algorithm 2). Counterpart of ``repro/core/partitioner.py`` (the
single-device entry points; the distributed partitioner comes with the
multi-device slice).

The point array goes to the device once. The Hilbert keys, their stable
sort and the strided or weighted center picks run there (``sfc.
sfc_initial_centers_torch``); the warm-up permutation is drawn on the host
with ``np.random.default_rng(seed)``, as in the reference, so it is the
same permutation bit for bit, and applied on the device. Labels come back
in the original point order.
"""
from __future__ import annotations

import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.device import resolve_device

from .balanced_kmeans import BKMConfig, balanced_kmeans
from .sfc import sfc_initial_centers_torch


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
