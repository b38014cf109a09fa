"""Mesh / point-set generators mirroring the paper's benchmark families
(the mesh zoo). Counterpart of ``repro/core/meshes.py``: the same numpy
generators, so a seed gives the same mesh in both packages.

The time-evolving workload fields of the reference (drifting hotspot,
rotating wave, moving refinement) belong to the repartitioning slice.

Graphs are returned in CSR form: (indptr [n+1], indices [nnz]) int64 numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """A geometric graph: points + CSR adjacency + optional node weights."""
    points: np.ndarray          # [n, d] float64
    indptr: np.ndarray          # [n+1] int64
    indices: np.ndarray         # [nnz] int64
    weights: np.ndarray | None = None   # [n] float64 (2.5D meshes)
    name: str = "mesh"

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def m(self) -> int:
        return self.indices.shape[0] // 2

    @property
    def dim(self) -> int:
        return self.points.shape[1]


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
                       seed: int = 0) -> Mesh:
    """Structured triangular mesh on an nx x ny grid (FEM-mesh analogue)."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx, dtype=np.float64),
                         np.arange(ny, dtype=np.float64), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    if jitter > 0:
        pts += rng.uniform(-jitter, jitter, pts.shape)
    idx = np.arange(nx * ny).reshape(nx, ny)
    e = []
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))     # right
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))     # up
    e.append(np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1))  # diag
    edges = np.concatenate(e, axis=0)
    indptr, indices = _dedup_sym_edges(nx * ny, edges[:, 0], edges[:, 1])
    return Mesh(pts, indptr, indices, name=f"tri{nx}x{ny}")


def _grid_hash_neighbors(pts: np.ndarray, radius: float):
    """All pairs within ``radius`` via uniform-grid hashing. Returns edge list."""
    n, d = pts.shape
    lo = pts.min(axis=0)
    cell = radius
    coords = np.floor((pts - lo) / cell).astype(np.int64)
    ncell = coords.max(axis=0) + 1
    # linear cell ids
    mult = np.ones(d, dtype=np.int64)
    for i in range(d - 1, 0, -1):
        mult[i - 1] = mult[i] * ncell[i]
    cid = coords @ mult
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    starts = np.searchsorted(sorted_cid, np.arange(int(ncell.prod()) + 1))
    # neighbor cell offsets
    offsets = np.array(np.meshgrid(*([[-1, 0, 1]] * d), indexing="ij")
                       ).reshape(d, -1).T
    rows_all, cols_all = [], []
    r2 = radius * radius
    for off in offsets:
        nb = coords + off
        valid = np.all((nb >= 0) & (nb < ncell), axis=1)
        nb_cid = nb @ mult
        s = starts[np.where(valid, nb_cid, 0)]
        t = starts[np.where(valid, nb_cid + 1, 0)]
        maxlen = int((t - s).max(initial=0))
        if maxlen == 0:
            continue
        # expand candidate lists per point, chunked to bound memory
        pidx = np.where(valid & (t > s))[0]
        for chunk in np.array_split(pidx, max(1, len(pidx) // 200_000)):
            if len(chunk) == 0:
                continue
            cs, ct = s[chunk], t[chunk]
            L = ct - cs
            maxL = int(L.max())
            grid_idx = cs[:, None] + np.arange(maxL)[None, :]
            ok = np.arange(maxL)[None, :] < L[:, None]
            cand = order[np.minimum(grid_idx, len(order) - 1)]
            src = np.broadcast_to(chunk[:, None], cand.shape)
            src, cand = src[ok], cand[ok]
            dd = ((pts[src] - pts[cand]) ** 2).sum(axis=1)
            keep = (dd <= r2) & (src < cand)
            rows_all.append(src[keep])
            cols_all.append(cand[keep])
    if not rows_all:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(rows_all), np.concatenate(cols_all)


def random_geometric_graph(n: int, dim: int = 2, avg_deg: float = 8.0,
                           seed: int = 0) -> Mesh:
    """rgg_n analogue: uniform points, edges within radius chosen for avg_deg."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 1.0, (n, dim))
    if dim == 2:
        radius = np.sqrt(avg_deg / (np.pi * n))
    else:
        radius = (avg_deg / (4.0 / 3.0 * np.pi * n)) ** (1.0 / 3.0)
    rows, cols = _grid_hash_neighbors(pts, radius)
    indptr, indices = _dedup_sym_edges(n, rows, cols)
    return Mesh(pts, indptr, indices, name=f"rgg{n}_{dim}d")


def knn_mesh(pts: np.ndarray, k: int = 6, name: str = "knn") -> Mesh:
    """k-nearest-neighbor graph (Delaunay-mesh proxy) via grid hashing."""
    n, d = pts.shape
    # choose a radius giving ~4k candidates on average, then take k nearest
    vol = np.prod(pts.max(0) - pts.min(0) + 1e-12)
    density = n / vol
    if d == 2:
        radius = np.sqrt(4.0 * k / (np.pi * density))
    else:
        radius = (4.0 * k / (4.0 / 3.0 * np.pi * density)) ** (1.0 / 3.0)
    rows, cols = _grid_hash_neighbors(pts, radius)
    # keep k nearest per node from the candidate set (both directions)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    dd = ((pts[r] - pts[c]) ** 2).sum(axis=1)
    order = np.lexsort((dd, r))
    r, c, dd = r[order], c[order], dd[order]
    starts = np.searchsorted(r, np.arange(n + 1))
    # rank of each candidate within its (distance-sorted) row; keep the k
    # nearest — vectorized, identical to slicing each row's first k
    keep = (np.arange(len(r)) - starts[r]) < k
    indptr, indices = _dedup_sym_edges(n, r[keep], c[keep])
    return Mesh(pts, indptr, indices, name=name)


def refined_mesh(n: int, seed: int = 0, dim: int = 2) -> Mesh:
    """Adaptively-refined mesh analogue (hugetric-like): point density is
    concentrated near a curved feature, graph is kNN."""
    rng = np.random.default_rng(seed)
    n_feat = n // 2
    # feature: a circle arc (2D) / spherical shell (3D)
    u = rng.uniform(0, 2 * np.pi, n_feat)
    rad = 0.3 + rng.normal(0, 0.02, n_feat)
    if dim == 2:
        feat = np.stack([0.5 + rad * np.cos(u), 0.5 + rad * np.sin(u)], 1)
    else:
        v = np.arccos(rng.uniform(-1, 1, n_feat))
        feat = np.stack([0.5 + rad * np.sin(v) * np.cos(u),
                         0.5 + rad * np.sin(v) * np.sin(u),
                         0.5 + rad * np.cos(v)], 1)
    bulk = rng.uniform(0, 1, (n - n_feat, dim))
    pts = np.concatenate([feat, bulk], axis=0)
    return knn_mesh(pts, k=6, name=f"refined{n}_{dim}d")


def stretched_grid(n: int, aspect: float = 6.0, jitter: float = 0.2,
                   seed: int = 0) -> Mesh:
    """Anisotropic stretched grid: a square triangulated grid whose x
    coordinates are scaled by ``aspect`` — isotropic topology, strongly
    anisotropic geometry. The stress case for geometric partitioners:
    compact-in-space blocks are elongated-in-graph, so axis-aligned cuts
    (RCB/MJ) and locality-preserving curves behave very differently here
    than on isotropic meshes."""
    side = max(int(np.sqrt(n)), 2)
    base = grid_triangulation(side, side, jitter=jitter, seed=seed)
    pts = base.points * np.array([aspect, 1.0])
    return Mesh(pts, base.indptr, base.indices,
                name=f"aniso{side * side}_a{aspect:g}")


def powerlaw_rgg(n: int, dim: int = 2, alpha: float = 2.0,
                 w_cap: float = 100.0, seed: int = 0) -> Mesh:
    """Random geometric graph with power-law node weights: Pareto(alpha)
    draws (clipped at ``w_cap`` so no single node exceeds a feasible block
    share) model particle-in-cell / n-body loads where a few cells carry
    most of the work. Weighted comm-volume balance is the §5 regime the
    2.5D climate mesh probes gently; this one probes it hard."""
    mesh = random_geometric_graph(n, dim, seed=seed)
    rng = np.random.default_rng(seed + 0x9E37)
    mesh.weights = np.minimum(rng.pareto(alpha, n) + 1.0, w_cap)
    mesh.name = f"rggpow{n}_{dim}d"
    return mesh


def climate_mesh_25d(n: int, seed: int = 0) -> Mesh:
    """2.5D weighted mesh analogue (fesom-like): 2D points with node weights
    representing vertical column depth; weight varies smoothly with a few
    deep basins."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 2))
    mesh = knn_mesh(pts, k=6, name=f"climate{n}")
    centers = rng.uniform(0.2, 0.8, (3, 2))
    w = np.ones(n)
    for c in centers:
        d2 = ((pts - c) ** 2).sum(axis=1)
        w += 40.0 * np.exp(-d2 / 0.02)
    mesh.weights = w
    return mesh


REGISTRY = {
    "tri": lambda n, seed=0: grid_triangulation(int(np.sqrt(n)), int(np.sqrt(n)), jitter=0.2, seed=seed),
    "rgg2d": lambda n, seed=0: random_geometric_graph(n, 2, seed=seed),
    "rgg3d": lambda n, seed=0: random_geometric_graph(n, 3, seed=seed),
    "delaunay2d": lambda n, seed=0: knn_mesh(np.random.default_rng(seed).uniform(0, 1, (n, 2)), 6, f"delaunay{n}_2d"),
    "delaunay3d": lambda n, seed=0: knn_mesh(np.random.default_rng(seed).uniform(0, 1, (n, 3)), 6, f"delaunay{n}_3d"),
    "refined2d": lambda n, seed=0: refined_mesh(n, seed, 2),
    "refined3d": lambda n, seed=0: refined_mesh(n, seed, 3),
    "aniso": lambda n, seed=0: stretched_grid(n, seed=seed),
    "rggpow": lambda n, seed=0: powerlaw_rgg(n, 2, seed=seed),
    "climate25d": lambda n, seed=0: climate_mesh_25d(n, seed),
}
