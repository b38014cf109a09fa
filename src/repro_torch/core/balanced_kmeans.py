"""Weighted balanced k-means (paper Section 4, Algorithms 1 and 2).
Counterpart of ``repro/core/balanced_kmeans.py``.

Same algorithm, same corrections of the paper's two sign typos (Eq. 1:
``influence *= gamma^(1/d)``; Eqs. 4-5: relaxation widens the bounds),
same fused hot loop: every balance iteration is one assign+reduce sweep
through the backend registry in ``kernels.ops``, and the movement phase
takes its moments from the last sweep. For the CUDA backends the solve
builds the points' Hilbert-ordered layout once (``ops.point_layout``) and
hands it to every sweep; the solver itself keeps its own point order.
The reference's ``while_loop``s are Python loops with the same exit
predicates; each predicate reads one scalar from the device.

The reference runs under ``jit``, where XLA turns a division by a
constant into a multiplication by its float32 reciprocal. Where that
changes a result the port does the same: the warm-up sample size, the
balance target ``W/k`` and the mean of the cluster radii.

Single device only: the multi-device path (the reference's
``axis_name``) comes with a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

PRECISIONS = ("f32", "bf16")


@dataclass(frozen=True)
class BKMConfig:
    k: int
    epsilon: float = 0.03          # max imbalance (paper uses 0.03/0.05)
    max_iter: int = 30             # center-movement iterations (Alg. 2)
    max_balance_iter: int = 12     # balance iterations per movement (Alg. 1)
    influence_clip: float = 0.05   # max 5% influence change per step (paper)
    d_eff: int | None = None       # dimension in Eq. (1); default spatial d
    erosion: bool = True           # Eqs. (2)-(3)
    delta_tol: float = 5e-4        # movement threshold x bbox diagonal
    warmup: bool = True            # sampled warm-up rounds
    warmup_start: int = 100
    backend: str = "auto"          # kernels.ops backend: torch/cuda/cuda_flat
    fused: bool | None = None      # fused assign+reduce; None = auto
    block_p: int = 1024            # kernel point tile
    block_c: int = 128             # kernel center tile
    assign_chunk: int | None = None  # torch path point chunk; None = adaptive
    assign_precision: str = "f32"  # distance cross term: "f32" | "bf16"
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.max_balance_iter < 1:
            # the movement moments ride out of the last balance iteration
            raise ValueError("max_balance_iter must be >= 1")
        if self.assign_precision not in PRECISIONS:
            raise ValueError(
                f"assign_precision must be one of {PRECISIONS}, got "
                f"{self.assign_precision!r}")


def _f32_reciprocal(x: int | float) -> float:
    """``1/x`` rounded to float32, the constant XLA multiplies by."""
    return float(np.float32(1.0) / np.float32(x))


def warmup_sample_size(it: int, n: int, n_global: int,
                       warmup_start: int) -> int:
    """Points in warm-up round ``it``: ceil(min(start * 2^it / N, 1) * n),
    in float32 with the division by the constant N done as a multiply by
    its float32 reciprocal, as the reference computes it under jit."""
    f32 = np.float32
    grown = f32(warmup_start) * f32(2.0) ** f32(it)
    frac = np.minimum(grown * f32(_f32_reciprocal(n_global)), f32(1.0))
    return int(np.ceil(frac * f32(n)))


def solve_layout(points, backend, block_p):
    """The points' layout (``ops.point_layout``) when ``backend`` takes one
    and d is 2 or 3, else None. Built once per solve."""
    from repro_torch.kernels.ops import backend_supports_layout, point_layout
    if points.shape[1] not in (2, 3) or points.shape[0] == 0 or \
            not backend_supports_layout(backend, points.device):
        return None
    return point_layout(points, block_p)


def assign_effective(points, centers, influence, chunk=None,
                     backend="auto", block_p=1024, block_c=128,
                     precision="f32"):
    """(assignment [n] int32, best_eff [n], second_eff [n]) with
    best/second as true effective distances dist/influence."""
    from repro_torch.kernels.ops import assign_backend
    fn = assign_backend(backend, points.device)
    idx, b, s = fn(points, centers, influence, chunk=chunk,
                   block_p=block_p, block_c=block_c, precision=precision)
    # second is +inf when k == 1; keep bounds finite
    return idx, torch.sqrt(b), torch.sqrt(torch.where(torch.isfinite(s),
                                                      s, b))


def assign_reduce(points, weights, centers, influence, cfg, layout=None):
    """One hot-loop sweep: assignment + per-cluster weighted moments,
    fused when the backend supports it (and ``cfg.fused`` is not False),
    else the assignment followed by ``segment_moments``. ``layout`` is the
    solve's ``solve_layout`` (None for backends without one). Returns
    (idx, best_eff, second_eff, csum, cw, rad2raw) with best/second
    sqrt'd."""
    from repro_torch.kernels.ops import (assign_backend,
                                         backend_supports_moments,
                                         segment_moments)
    dev = points.device
    fused = cfg.fused
    if fused is None:
        fused = backend_supports_moments(cfg.backend, dev)
    elif fused and not backend_supports_moments(cfg.backend, dev):
        raise ValueError(
            f"fused=True but assign backend {cfg.backend!r} does not "
            "support return_moments; register it with "
            "supports_moments=True or pass fused=False/None")
    fn = assign_backend(cfg.backend, dev)
    if fused:
        idx, b, s, csum, cw, rad2 = fn(
            points, centers, influence, chunk=cfg.assign_chunk,
            block_p=cfg.block_p, block_c=cfg.block_c, weights=weights,
            return_moments=True, precision=cfg.assign_precision,
            layout=layout)
    else:
        idx, b, s = fn(points, centers, influence, chunk=cfg.assign_chunk,
                       block_p=cfg.block_p, block_c=cfg.block_c,
                       precision=cfg.assign_precision, layout=layout)
        csum, cw, rad2 = segment_moments(points, weights, idx, b, cfg.k,
                                         chunk=cfg.assign_chunk)
    return (idx, torch.sqrt(b),
            torch.sqrt(torch.where(torch.isfinite(s), s, b)),
            csum, cw, rad2)


def adapt_influence(influence, sizes, target, d_eff, clip):
    """Paper Eq. (1), sign-corrected; oversized clusters lose influence."""
    gamma = target / torch.clamp_min(sizes, 1e-12)
    factor = torch.clamp(gamma ** (1.0 / d_eff), 1.0 - clip, 1.0 + clip)
    return influence * factor, factor


def erode_influence(influence, delta, beta):
    """Paper Eqs. (2)-(3): sigmoid regression of influence toward 1."""
    alpha = 2.0 / (1.0 + torch.exp(-delta / torch.clamp_min(beta, 1e-12))) \
        - 1.0
    return torch.exp((1.0 - alpha)
                     * torch.log(torch.clamp_min(influence, 1e-12)))


def assign_and_balance(points, w_eff, centers, influence, A_old, ub, lb,
                       cfg, target_weight, valid=None, n_valid=None,
                       layout=None):
    """Algorithm 1. Returns (A, influence, ub, lb, sizes, csum, rad2sum,
    stats). Every balance iteration is one fused sweep; the sizes and the
    movement moments come out of it. ``valid`` and ``n_valid`` only shape
    the skip statistic; ``layout`` goes to every sweep."""
    n, d = points.shape
    d_eff = cfg.d_eff or d
    k = cfg.k
    dev = points.device
    A, infl = A_old, influence
    sizes = torch.zeros(k, dtype=cfg.dtype, device=dev)
    csum = torch.zeros(k, d, dtype=cfg.dtype, device=dev)
    rad2sum = torch.zeros(k, dtype=cfg.dtype, device=dev)
    skips = torch.zeros((), dtype=torch.float32, device=dev)
    i, done = 0, False
    while i < cfg.max_balance_iter and not done:
        idx, best, second, csum, cw, rad2raw = assign_reduce(
            points, w_eff, centers, infl, cfg, layout)
        skip = ub < lb                            # Hamerly test
        skip_stat = skip if valid is None else (skip & valid)
        A = idx
        ub_n = torch.where(skip, ub, best)
        lb_n = torch.where(skip, lb, second)
        sizes = cw
        # true-distance^2 radius numerator (invariant under later rescale)
        rad2sum = rad2raw * (infl * infl)
        imb = torch.max(sizes) / target_weight - 1.0
        done = bool(imb <= cfg.epsilon)
        if done:
            ub, lb = ub_n, lb_n
        else:
            infl_new, _ = adapt_influence(infl, sizes, target_weight,
                                          d_eff, cfg.influence_clip)
            # effdist scales exactly by I_old/I_new per cluster
            ratio = infl / infl_new
            ub = ub_n * ratio[A.long()]
            lb = lb_n * torch.min(ratio)
            infl = infl_new
        skips = skips + torch.sum(skip_stat.to(torch.float32))
        i += 1
    if n_valid is None:
        n_valid = n
    count = torch.tensor(float(max(i, 1) * n_valid), dtype=torch.float32,
                         device=dev)         # a true division, not a recip
    stats = {"balance_iters": i, "balanced": done,
             "skip_fraction": skips / count}
    return A, infl, ub, lb, sizes, csum, rad2sum, stats


def balanced_kmeans(points, cfg: BKMConfig, weights=None, centers0=None,
                    n_global=None, target_weight=None, influence0=None,
                    warm_start=False, prev_assignment=None):
    """Algorithm 2 (minus the SFC sort, done by the partitioner).

    ``points`` [n, d] on the solve's device, already randomly permuted if
    warm-up is on. ``warm_start=True`` resumes from ``(centers0,
    influence0)``: no sampled warm-up, and a pre-pass sweep seeds the
    bounds and measures the movement ``delta0``; below the threshold the
    movement loop never runs. ``prev_assignment`` (warm only) adds no-op
    detection: an unchanged, still balanced assignment is re-emitted.

    Returns (assignment, centers, influence, stats); stats holds tensors
    on the solve's device and ``history`` the per-iteration records.
    """
    n, d = points.shape
    k = cfg.k
    dtype = cfg.dtype
    dev = points.device
    points = points.to(dtype)
    w = (torch.ones(n, dtype=dtype, device=dev) if weights is None
         else weights.to(dtype))
    if centers0 is None:
        pick = torch.from_numpy(np.linspace(0, n - 1, k).astype(np.int32))
        centers0 = points[pick.to(dev).long()]
    if n_global is None:
        n_global = n
    valid = w > 0

    total_w = torch.clamp_min(torch.sum(w), 1e-12)
    base_target = (total_w * _f32_reciprocal(k) if target_weight is None
                   else torch.as_tensor(target_weight, dtype=dtype,
                                        device=dev))
    # the points enter the solve here: their layout is built once
    layout = solve_layout(points, cfg.backend, cfg.block_p)
    if layout is None:
        lo = torch.min(points, dim=0).values
        hi = torch.max(points, dim=0).values
    else:
        lo, hi = layout.lo, layout.hi
    diag = torch.sqrt(torch.sum((hi - lo) ** 2))
    delta_threshold = float(cfg.delta_tol * diag)

    if cfg.warmup and not warm_start:
        n_warm = int(np.ceil(np.log2(max(int(n_global) / cfg.warmup_start,
                                         1))))
    else:
        n_warm = 0
    sampling = cfg.warmup and not warm_start
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)

    hist = {name: torch.zeros(cfg.max_iter, dtype=torch.float32, device=dev)
            for name in ["skip_fraction", "balance_iters", "max_delta",
                         "imbalance"]}
    centers = centers0.to(dtype)
    infl = (torch.ones(k, dtype=dtype, device=dev) if influence0 is None
            else torch.as_tensor(influence0, dtype=dtype, device=dev))
    if warm_start:
        # convergence pre-pass under the previous (centers, influence)
        A, ub, lb, csum0, cw0, _ = assign_reduce(points, w, centers, infl,
                                                 cfg, layout)
        cand0 = torch.where(cw0[:, None] > 0,
                            csum0 / torch.clamp_min(cw0, 1e-12)[:, None],
                            centers)
        delta0 = float(torch.max(torch.sqrt(torch.sum((cand0 - centers)
                                                      ** 2, dim=1))))
        # an imbalanced previous state is never "converged"
        balanced0 = bool(torch.max(cw0) / base_target - 1.0 <= cfg.epsilon)
        if not balanced0:
            delta0 = float("inf")
        if prev_assignment is not None:
            same = bool(torch.all(A == prev_assignment.to(torch.int32)))
            if same and balanced0:
                delta0 = 0.0
        max_delta = float(np.float32(delta0))
    else:
        A = torch.zeros(n, dtype=torch.int32, device=dev)
        ub = torch.full((n,), float("inf"), dtype=dtype, device=dev)
        lb = torch.zeros(n, dtype=dtype, device=dev)
        max_delta = float("inf")

    it = 0
    while it < cfg.max_iter:
        keep_going = it < n_warm or max_delta > delta_threshold
        if warm_start and it > 0:
            # never converge while the last balance phase ended above eps
            keep_going = keep_going or float(
                hist["imbalance"][it - 1]) > cfg.epsilon
        if not keep_going:
            break
        if sampling:
            s_local = warmup_sample_size(it, n, n_global, cfg.warmup_start)
            w_eff = w * (arange_n < s_local).to(dtype)
        else:
            w_eff = w
        # the target scales with the sampled weight fraction
        w_round = torch.clamp_min(torch.sum(w_eff), 1e-12)
        target = base_target * (w_round / total_w)
        A, infl, ub, lb, sizes, csum, rad2_l, st = assign_and_balance(
            points, w_eff, centers, infl, A, ub, lb, cfg, target,
            valid=valid, n_valid=n_global, layout=layout)
        # movement phase (Alg. 2 lines 12-13) from the last sweep's moments
        cw = sizes
        new_centers = torch.where(
            cw[:, None] > 0, csum / torch.clamp_min(cw, 1e-12)[:, None],
            centers)
        delta = torch.sqrt(torch.sum((new_centers - centers) ** 2, dim=1))
        # influence erosion (Eqs. 2-3); beta = 2 * mean cluster radius
        rad2 = rad2_l / torch.clamp_min(cw, 1e-12)
        beta = 2.0 * (torch.sum(torch.sqrt(torch.clamp_min(rad2, 0.0)))
                      * _f32_reciprocal(k))
        infl_new = erode_influence(infl, delta, beta) if cfg.erosion \
            else infl
        # bound relaxation for movement + erosion (Eqs. 4-5, corrected)
        ratio = infl / infl_new
        Al = A.long()
        ub = ub * ratio[Al] + delta[Al] / infl_new[Al]
        lb = torch.clamp_min(lb * torch.min(ratio)
                             - torch.max(delta / infl_new), 0.0)
        max_delta_t = torch.max(delta)
        hist["skip_fraction"][it] = st["skip_fraction"]
        hist["balance_iters"][it] = float(st["balance_iters"])
        hist["max_delta"][it] = max_delta_t
        hist["imbalance"][it] = torch.max(sizes) / target - 1.0
        max_delta = float(max_delta_t)
        centers, infl = new_centers, infl_new
        it += 1

    # final full pass on all points (mask = 1) so the result is exact and
    # balanced even if warm-up dominated
    target = base_target
    A, infl, ub, lb, sizes, _, _, st = assign_and_balance(
        points, w, centers, infl, A,
        torch.full((n,), float("inf"), dtype=dtype, device=dev),
        torch.zeros(n, dtype=dtype, device=dev), cfg, target,
        valid=valid, n_valid=n_global, layout=layout)
    from repro_torch.kernels.ops import tile_prune_fraction
    frac = tile_prune_fraction(points, centers, infl, lb * lb,
                               cfg.block_p, cfg.block_c)
    stats = {"iters": torch.tensor(it, dtype=torch.int32),
             "final_sizes": sizes,
             "final_imbalance": torch.max(sizes) / target - 1.0,
             "final_balance_iters": torch.tensor(st["balance_iters"],
                                                 dtype=torch.int32),
             "skip_fraction_final": st["skip_fraction"],
             "tiles_pruned_frac": frac,
             "history": hist}
    return A, centers, infl, stats
