"""The CUDA sweep's center pruning and the Hilbert point layout, on the CPU.

``ops.point_layout`` is checked as a data structure; the kernel's per-tile
bounds (``assign_kernel.eff_bounds_plain``, the kernel's arithmetic in
plain PyTorch) are held against the effective distances the sweep
computes; the pruning rule (skip center c in a tile when its lower bound
exceeds the tile's threshold, run the update over the survivors in index
order) is emulated on those distances and must give idx / best / second
bit-equal to the unpruned sweep, ties included; and the entry points and
the solver must give the same bits with and without the layout. No
tolerance anywhere: every comparison is exact. Inputs are made with numpy
from a seed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import balanced_kmeans as bkm
from repro_torch.core.sfc import hilbert_index_torch, sfc_initial_centers
from repro_torch.kernels import assign_kernel as ak
from repro_torch.kernels import ops
from repro_torch.kernels import triton_assign as ta

torch.set_num_threads(1)


def _points(kind, n, d, seed):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        mu = rng.uniform(0, 1, (12, d))
        pts = mu[rng.integers(0, 12, n)] + rng.normal(0, 0.02, (n, d))
    elif kind == "lattice":
        side = int(np.ceil(n ** (1 / d)))
        grid = np.stack(np.meshgrid(*[np.arange(side)] * d), -1)
        pts = grid.reshape(-1, d)[rng.permutation(side ** d)[:n]] * 0.125
    elif kind == "far":
        pts = rng.uniform(0, 1, (n, d)) * 1e9
    else:
        pts = rng.uniform(0, 1, (n, d))
    return pts.astype(np.float32)


def _state(kind, n, k, d, seed, adapted=False):
    """Points in solver order, bootstrap centers (SFC picks; on the
    lattice, lattice points, so ties are exact) and influence."""
    pts = _points(kind, n, d, seed)
    ctr = sfc_initial_centers(pts.astype(np.float64), k).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    infl = (rng.uniform(0.8, 1.25, k) if adapted else np.ones(k))
    return (torch.from_numpy(pts), torch.from_numpy(ctr),
            torch.from_numpy(infl.astype(np.float32)))


CASES = [("uniform", 65536, 64, 3, 256, False, "f32"),
         ("uniform", 65536, 64, 3, 1024, True, "f32"),
         ("clustered", 6000, 24, 2, 256, True, "f32"),
         ("lattice", 4096, 16, 3, 256, False, "f32"),
         ("lattice", 4096, 16, 2, 512, False, "f32"),
         ("uniform", 777, 1, 2, 256, False, "f32"),
         ("uniform", 3001, 20, 3, 256, True, "f32"),
         ("far", 2048, 9, 2, 256, False, "f32"),
         ("uniform", 8192, 32, 3, 256, True, "bf16"),
         ("clustered", 6000, 24, 3, 256, False, "bf16")]
IDS = [f"{c[0]}-n{c[1]}-k{c[2]}-d{c[3]}-bp{c[4]}{'-adapted' * c[5]}-{c[6]}"
       for c in CASES]


@pytest.mark.parametrize("d,n,block_p", [(2, 1000, 256), (3, 2048, 1024),
                                         (3, 1500, 768)])
def test_point_layout_is_a_hilbert_permutation(d, n, block_p):
    pts = torch.from_numpy(_points("uniform", n, d, n))
    lay = ops.point_layout(pts, block_p)
    N = n + (-n) % block_p
    order = lay.order.long()
    assert lay.order.dtype == torch.int32 and lay.points.shape == (N, d)
    assert lay.n == n and lay.block_p == block_p
    assert torch.equal(torch.sort(order).values, torch.arange(N))
    assert torch.equal(order[n:], torch.arange(n, N))
    keys = hilbert_index_torch(pts.double())
    assert torch.equal(order[:n], torch.sort(keys, stable=True).indices)
    assert torch.equal(lay.points[:n], pts[order[:n]])
    assert torch.equal(lay.points[n:], pts[order[n - 1]].expand(N - n, d))
    assert torch.equal(lay.lo, pts.min(0).values)
    assert torch.equal(lay.hi, pts.max(0).values)


def _tile(block_p):
    """Rows of one kernel point tile."""
    return ak.THREADS * ak.points_per_thread(block_p)


def _tile_boxes(lay):
    """Each kernel point tile's box over the layout's rows (a ragged last
    tile edge-padded, which adds no new point), as the kernel reduces
    it: (lo, hi) [tiles, d]."""
    tile, pts = _tile(lay.block_p), lay.points
    pts = torch.cat([pts, pts[-1:].expand((-pts.shape[0]) % tile, -1)])
    boxes = pts.reshape(-1, tile, pts.shape[1])
    return torch.min(boxes, dim=1).values, torch.max(boxes, dim=1).values


def _dense_eff(p, ctr, inv2, precision):
    """The plain sweep's effective distances for every pair (the chunk
    math of ``ops._chunk_assign``)."""
    pn = torch.sum(p * p, dim=1, keepdim=True)
    cn = torch.sum(ctr * ctr, dim=1)
    if precision == "bf16":
        cross2 = 2.0 * (p.bfloat16().float() @ ctr.bfloat16().float().T)
    else:
        cross2 = 2.0 * p @ ctr.T
    return torch.clamp_min(pn + cn[None] - cross2, 0.0) * inv2[None]


def _fma_eff(p, ctr, inv2, precision):
    """The kernel's own rounding of eff: float32 fmaf chains for |p|^2,
    |c|^2 and p.c, one float32 add and a final fmaf, each emulated in
    float64 and rounded once."""
    f, dd = torch.float32, torch.float64

    def fma(a, b, c):
        return (a.to(dd) * b.to(dd) + c.to(dd)).to(f)

    def chain(x, y):
        s = torch.zeros(x.shape[:-1], dtype=f)
        for j in range(x.shape[-1]):
            s = fma(x[..., j], y[..., j], s)
        return s

    pd, cd = (p, ctr) if precision == "f32" else (
        p.bfloat16().float(), ctr.bfloat16().float())
    dot = chain(pd[:, None, :].expand(-1, ctr.shape[0], -1),
                cd[None].expand(p.shape[0], -1, -1))
    s = chain(p, p)[:, None] + chain(ctr, ctr)[None]
    sq = fma(torch.full_like(dot, -2.0), dot, s)
    return torch.clamp_min(sq, 0.0) * inv2[None]


def _triple(eff, cols):
    """idx / best / second of the sequential update over the columns
    ``cols`` (increasing): min, the lowest index attaining it, and the
    smallest value over every other column (+inf with one column)."""
    sub = eff[:, cols]
    best = torch.min(sub, dim=1).values
    first = torch.argmax((sub == best[:, None]).to(torch.int8), dim=1)
    mask = torch.zeros_like(sub, dtype=torch.bool)
    mask[torch.arange(sub.shape[0]), first] = True
    second = torch.min(torch.where(mask, float("inf"), sub), dim=1).values
    return cols[first].to(torch.int32), best, second


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bounds_and_pruning_rule_are_exact(case):
    """Per tile of the layout: lb <= eff <= ub for every pair, under both
    the plain sweep's and the kernel's rounding; the threshold is at
    least every point's second; and the survivors (lb <= threshold, in
    index order) give idx / best / second bit-equal to all centers."""
    kind, n, k, d, bp, adapted, precision = case
    pts, ctr, infl = _state(kind, n, k, d, n + k + d, adapted)
    inv2 = 1.0 / (infl * infl)
    lay = ops.point_layout(pts, bp)
    tile_lo, tile_hi = _tile_boxes(lay)
    lb, ub, thr = ak.eff_bounds_plain(tile_lo, tile_hi, ctr, inv2,
                                      precision)
    tile = _tile(bp)
    cols = torch.arange(k)
    kept = 0
    for t in range(tile_lo.shape[0]):
        p = lay.points[t * tile:(t + 1) * tile]
        for eff in (_dense_eff(p, ctr, inv2, precision),
                    _fma_eff(p, ctr, inv2, precision)):
            assert bool((lb[t][None] <= eff).all()), f"tile {t}: lb > eff"
            assert bool((eff <= ub[t][None]).all()), f"tile {t}: ub < eff"
            full = _triple(eff, cols)
            assert bool((full[2] <= thr[t]).all())
            surv = cols[~(lb[t] > thr[t])]
            for a, b in zip(_triple(eff, surv), full):
                assert torch.equal(a, b), f"tile {t}: pruning changed it"
        kept += int((~(lb[t] > thr[t])).sum())
    frac = kept / (k * tile_lo.shape[0])
    if kind == "uniform" and k >= 64:
        # 1024 points a center (the main shape has 4096, where ~2% of the
        # pairs are kept): a tile's box still meets several clusters
        assert frac < 0.5, f"pruning kept {frac:.3f} of the pairs"
    if k == 1:
        assert frac == 1.0


@pytest.mark.parametrize("d", [2, 3])
def test_bf16_slack_covers_the_worst_rounding(d):
    """Points and a center whose every coordinate rounds up to bfloat16
    by almost a full unit (2^-8 relative), all pointing the same way, so
    the kernel's p.c overshoots by almost (2^-7 + 2^-16) sum_j |p_j||c_j|
    and its sq falls short of the true distance by almost twice that.
    The worst point lies on the face of its tile's box nearest the
    center. The bound must stay at or below the kernel's eff there, with
    the slack about twice the shortfall, as assign.cu's header states."""
    x = np.float32(1 + 2.0 ** -8 + 2.0 ** -23)   # bf16 rounds it to 1+2^-7
    face = np.full(d, x, np.float32)
    rng = np.random.default_rng(d)
    inner = (face * rng.uniform(0.25, 1.0, (255, d))).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([face[None], inner]))
    ctr = torch.from_numpy(np.stack([face * np.float32(8),
                                     -face * np.float32(8)]))
    inv2 = torch.ones(2)
    lo, hi = pts.min(0, keepdim=True).values, pts.max(0, keepdim=True).values
    assert torch.equal(hi[0], pts[0])
    lb, _, _ = ak.eff_bounds_plain(lo, hi, ctr, inv2, "bf16")
    eff = _fma_eff(pts, ctr, inv2, "bf16")
    assert bool((lb[0][None] <= eff).all())
    true = torch.sum((pts[0].double() - ctr[0].double()) ** 2)
    m = float(torch.sum(hi[0].double() * ctr[0].double()))
    short = float(true) - float(eff[0, 0])
    assert short > 0.99 * 2.0 ** -6 * m, "not the worst rounding"
    gap2 = float(torch.sum((ctr[0].double() - hi[0].double()) ** 2))
    assert gap2 - float(lb[0, 0]) >= 1.9 * short


@pytest.mark.parametrize("case", CASES[2:], ids=IDS[2:])
def test_entry_points_equal_with_and_without_order(case):
    """The four entry points on the CPU: the layout copy with its order
    gives the same bits, in the solver's order, as the points in their
    own order."""
    kind, n, k, d, bp, adapted, precision = case
    pts, ctr, infl = _state(kind, n, k, d, 7 * n + k, adapted)
    w = torch.from_numpy(np.random.default_rng(n).uniform(0.5, 2.0, n)
                         .astype(np.float32))
    lay = ops.point_layout(pts, bp)
    iv = 1.0 / (infl * infl)
    cts, iv2 = ops._pad_rows(ctr, 8, ops._FAR), ops._pad_rows(iv, 8, 1.0)
    plain_pts = ops._pad_rows(pts, bp, 0.0)
    ww = ops._pad_rows(w, bp, 0.0)
    for fn in (ak.assign_reduce_cuda, ta.triton_assign_reduce_cuda):
        a = fn(lay.points, cts, iv2, ww, k, block_p=bp, block_c=8,
               precision=precision, order=lay.order)
        b = fn(plain_pts, cts, iv2, ww, k, block_p=bp, block_c=8,
               precision=precision)
        for x, y in zip(a[:3], b[:3]):
            assert torch.equal(x[:n], y[:n])
        assert torch.equal(a[3], b[3])
    for fn in (ak.assign_argmin_cuda, ta.triton_assign_cuda):
        a = fn(lay.points, cts, iv2, k, block_p=bp, block_c=8,
               precision=precision, order=lay.order)
        b = fn(plain_pts, cts, iv2, k, block_p=bp, block_c=8,
               precision=precision)
        for x, y in zip(a, b):
            assert torch.equal(x[:n], y[:n])


@pytest.mark.parametrize("backend", ["cuda", "cuda_flat"])
def test_backends_equal_with_and_without_layout(backend):
    pts, ctr, infl = _state("clustered", 3000, 20, 3, 5, True)
    w = torch.ones(3000)
    fn = ops.assign_backend(backend)
    lay = ops.point_layout(pts, 256)
    a = fn(pts, ctr, infl, block_p=256, block_c=8, weights=w,
           return_moments=True, layout=lay)
    b = fn(pts, ctr, infl, block_p=256, block_c=8, weights=w,
           return_moments=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="layout was built"):
        fn(pts, ctr, infl, block_p=1024, block_c=8, layout=lay)


def test_layout_is_taken_only_by_the_cuda_backends():
    assert ops.backend_supports_layout("cuda")
    assert ops.backend_supports_layout("cuda_flat")
    assert not ops.backend_supports_layout("torch")
    torch_fn = ops.assign_backend("torch")
    pts3, ctr3 = torch.rand(50, 3), torch.rand(4, 3)
    for x, y in zip(torch_fn(pts3, ctr3, torch.ones(4), layout=None),
                    torch_fn(pts3, ctr3, torch.ones(4))):
        assert torch.equal(x, y)
    pts = torch.rand(300, 3)
    assert bkm.solve_layout(pts, "torch", 256) is None
    assert bkm.solve_layout(torch.rand(300, 4), "cuda", 256) is None
    assert bkm.solve_layout(pts, "cuda", 256).n == 300
    with pytest.raises(ValueError, match="2 or 3 dimensions"):
        ops.point_layout(torch.rand(10, 5))


@pytest.mark.parametrize("backend,weighted", [("cuda", False),
                                              ("cuda_flat", True)])
def test_solver_results_unchanged_by_the_layout(backend, weighted,
                                                monkeypatch):
    """A whole solve with the layout (the default for the CUDA backends)
    and one with it switched off give bit-identical labels, centers,
    influence and stats on the CPU."""
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(0, 1, (3000, 3)).astype(np.float32))
    w = (torch.from_numpy(rng.lognormal(0, 0.5, 3000).astype(np.float32))
         if weighted else None)
    cfg = bkm.BKMConfig(k=12, backend=backend, block_p=256)
    with_layout = bkm.balanced_kmeans(pts, cfg, w)
    monkeypatch.setattr(bkm, "solve_layout", lambda *a: None)
    without = bkm.balanced_kmeans(pts, cfg, w)
    for x, y in zip(with_layout[:3], without[:3]):
        assert torch.equal(x, y)
    assert int(with_layout[3]["iters"]) == int(without[3]["iters"])
    for key, val in with_layout[3]["history"].items():
        assert torch.equal(val, without[3]["history"][key])
