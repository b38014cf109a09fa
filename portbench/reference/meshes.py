"""Frozen workload generators of the benchmark.

``grid_triangulation`` and ``_dedup_sym_edges`` are copied from
``src/repro_torch/core/meshes.py`` at commit 78792ac (the same numpy code
as ``src/repro/core/meshes.py``). ``DriftingHotspot`` is copied from the
same file at the same commit. They are frozen here so that a change to the
program cannot change what the benchmark asks of it.

``grid_csr`` and ``grid_points`` make the same mesh on a torch device, in
a few large calls: the CSR of ``grid_triangulation`` (held equal to it by
the benchmark's CPU tests) and the grid's points with uniform jitter drawn
from a ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _dedup_sym_edges(n: int, rows: np.ndarray, cols: np.ndarray):
    """Symmetrize + dedup an edge list, drop self loops, return CSR."""
    mask = rows != cols
    rows, cols = rows[mask], cols[mask]
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    key = r * np.int64(n) + c
    _, uniq = np.unique(key, return_index=True)
    r, c = r[uniq], c[uniq]
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, r + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, c.astype(np.int64)


def grid_triangulation(nx: int, ny: int, jitter: float = 0.0,
                       seed: int = 0):
    """Structured triangular mesh on an nx x ny grid (FEM-mesh analogue).
    Returns (points [n, 2] float64, indptr [n+1], indices [nnz])."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    if jitter > 0:
        pts += rng.uniform(-jitter, jitter, pts.shape)
    idx = np.arange(nx * ny).reshape(nx, ny)
    e = []
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1))
    edges = np.concatenate(e, axis=0)
    indptr, indices = _dedup_sym_edges(nx * ny, edges[:, 0], edges[:, 1])
    return pts, indptr, indices


# the six neighbours of node (i, j) in increasing node id i * ny + j
_OFFSETS = ((-1, -1), (-1, 0), (0, -1), (0, 1), (1, 0), (1, 1))


def grid_csr(nx: int, ny: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(indptr [n+1], indices [nnz]) int64 on ``device``: the CSR that
    ``grid_triangulation(nx, ny)`` builds, made directly. The right, up
    and diagonal edges of node (i, j), symmetrized, are the six offsets
    above; in that order the neighbours' ids increase, so the valid ones,
    row by row, are the sorted CSR rows."""
    i = torch.arange(nx, device=device).repeat_interleave(ny)
    j = torch.arange(ny, device=device).repeat(nx)
    nbr, ok = [], []
    for di, dj in _OFFSETS:
        ii, jj = i + di, j + dj
        ok.append((ii >= 0) & (ii < nx) & (jj >= 0) & (jj < ny))
        nbr.append(ii * ny + jj)
    nbr, ok = torch.stack(nbr, 1), torch.stack(ok, 1)
    indptr = torch.zeros(nx * ny + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(ok.sum(1), 0)
    return indptr, nbr[ok]


def grid_points(nx: int, ny: int, jitter: float, gen: torch.Generator,
                device) -> torch.Tensor:
    """[nx * ny, 2] float64 on ``device``: the grid of
    ``grid_triangulation`` with each coordinate moved by a uniform draw in
    [-jitter, jitter) from ``gen``."""
    xs = torch.arange(nx, dtype=torch.float64, device=device)
    ys = torch.arange(ny, dtype=torch.float64, device=device)
    pts = torch.stack(torch.meshgrid(xs, ys, indexing="ij"), -1).reshape(-1, 2)
    noise = torch.rand(pts.shape, dtype=torch.float64, generator=gen,
                       device=device)
    return pts + (2.0 * noise - 1.0) * jitter


def _const(x: torch.Tensor, value) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=x.device)


@dataclass(frozen=True)
class DriftingHotspot:
    """A Gaussian load hotspot whose center drifts linearly with time:
    ``w = base + amplitude * exp(-|x - c(t)|^2 / (2 sigma^2))`` with
    ``c(t) = start + t*velocity``, over the first ``len(start)``
    coordinates."""
    amplitude: float = 8.0
    sigma: float = 0.14
    start: tuple = (0.25, 0.25)
    velocity: tuple = (0.01, 0.008)
    base: float = 1.0

    def weights_at(self, points: torch.Tensor, t) -> torch.Tensor:
        """[n] float32 weights at step ``t`` on the points' device."""
        p = points.to(torch.float32)
        c = _const(p, self.start) + t * _const(p, self.velocity)
        d2 = torch.sum((p[:, :len(self.start)] - c) ** 2, dim=1)
        return self.base + self.amplitude * torch.exp(
            -d2 / _const(p, 2.0 * self.sigma ** 2))

