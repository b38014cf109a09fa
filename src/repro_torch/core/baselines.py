"""Geometric partitioning baselines the paper compares against (Section
3.1). Counterpart of ``repro/core/baselines.py``: host numpy, labels
exactly equal to the reference's.

* RCB  — recursive coordinate bisection at the weighted median.
* RIB  — recursive inertial bisection along the principal axis.
* SFC  — Hilbert-curve chunking into k contiguous equal-weight pieces.
* MJ   — MultiJagged-lite one-shot multisection.
"""
from __future__ import annotations

import numpy as np

from .sfc import sfc_order


def _weighted_quantile_split(vals: np.ndarray, w: np.ndarray, frac: float) -> float:
    order = np.argsort(vals, kind="stable")
    cw = np.cumsum(w[order])
    total = cw[-1]
    pos = np.searchsorted(cw, frac * total)
    pos = min(pos, len(order) - 1)
    return vals[order[pos]]


def rcb(points: np.ndarray, k: int, weights: np.ndarray | None = None,
        axis_fn=None) -> np.ndarray:
    """Recursive bisection; ``axis_fn(points)`` picks the split direction
    (returns a unit vector). Default: widest coordinate axis."""
    n, d = points.shape
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    part = np.zeros(n, dtype=np.int64)

    def recurse(idx: np.ndarray, lo_blk: int, hi_blk: int):
        nblk = hi_blk - lo_blk
        if nblk <= 1 or idx.size == 0:
            part[idx] = lo_blk
            return
        k_left = nblk // 2
        frac = k_left / nblk
        pts = points[idx]
        if axis_fn is None:
            spans = pts.max(axis=0) - pts.min(axis=0)
            direction = np.zeros(d)
            direction[np.argmax(spans)] = 1.0
        else:
            direction = axis_fn(pts, w[idx])
        proj = pts @ direction
        # weighted median split with deterministic tie-break by index
        order = np.argsort(proj, kind="stable")
        cw = np.cumsum(w[idx][order])
        pos = int(np.searchsorted(cw, frac * cw[-1]))
        pos = min(max(pos, 1), idx.size - 1) if idx.size > 1 else 0
        left = idx[order[:pos]]
        right = idx[order[pos:]]
        recurse(left, lo_blk, lo_blk + k_left)
        recurse(right, lo_blk + k_left, hi_blk)

    recurse(np.arange(n), 0, k)
    return part


def _inertial_axis(pts: np.ndarray, w: np.ndarray) -> np.ndarray:
    mu = np.average(pts, axis=0, weights=w)
    x = (pts - mu) * np.sqrt(w)[:, None]
    cov = x.T @ x
    vals, vecs = np.linalg.eigh(cov)
    return vecs[:, -1]


def rib(points: np.ndarray, k: int, weights: np.ndarray | None = None) -> np.ndarray:
    """Recursive inertial bisection."""
    return rcb(points, k, weights, axis_fn=_inertial_axis)


def sfc_partition(points: np.ndarray, k: int,
                  weights: np.ndarray | None = None) -> np.ndarray:
    """Hilbert-curve chunking (zoltanSFC / ParMetis-SFC analogue)."""
    n = points.shape[0]
    order = sfc_order(points)
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    cw = np.cumsum(w[order])
    total = cw[-1]
    # block of point at cumulative weight c: floor(c / (total/k))
    blk = np.minimum((cw * k / total).astype(np.int64), k - 1)
    part = np.zeros(n, dtype=np.int64)
    part[order] = blk
    return part


def multijagged(points: np.ndarray, k: int,
                weights: np.ndarray | None = None) -> np.ndarray:
    """MultiJagged-lite: factor k = k1*k2(*k3), cut dim 0 into k1 weighted
    quantile slabs, each slab into k2 (then k3) — one-shot multisection."""
    n, d = points.shape
    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    # factor k into d roughly-equal factors
    factors = []
    rem = k
    for i in range(d - 1):
        f = int(round(rem ** (1.0 / (d - i))))
        f = max(1, min(f, rem))
        while rem % f != 0:
            f -= 1
        factors.append(f)
        rem //= f
    factors.append(rem)

    part = np.zeros(n, dtype=np.int64)

    def cut(idx: np.ndarray, dim: int, blk_base: int):
        f = factors[dim]
        vals = points[idx, dim]
        order = np.argsort(vals, kind="stable")
        cw = np.cumsum(w[idx][order])
        total = cw[-1]
        slab = np.minimum((cw * f / total).astype(np.int64), f - 1)
        stride = int(np.prod(factors[dim + 1:])) if dim + 1 < d else 1
        for s in range(f):
            sub = idx[order[slab == s]]
            if dim + 1 < d:
                cut(sub, dim + 1, blk_base + s * stride)
            else:
                part[sub] = blk_base + s

    cut(np.arange(n), 0, 0)
    return part


BASELINES = {
    "rcb": rcb,
    "rib": rib,
    "hsfc": sfc_partition,
    "mj": multijagged,
}
