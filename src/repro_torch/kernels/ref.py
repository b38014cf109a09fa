"""Dense PyTorch oracles for the assignment kernels (reference:
``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch


def assign_argmin_ref(points, centers, influence):
    """Effective-distance argmin (paper Alg. 1 inner loop), dense oracle.

    Returns (idx [n] int32, best_eff_sq [n], second_eff_sq [n]) where
    eff_sq = squared distance / influence^2."""
    inv2 = 1.0 / (influence * influence)
    pn = torch.sum(points * points, dim=1, keepdim=True)
    cn = torch.sum(centers * centers, dim=1)
    sq = torch.clamp_min(pn + cn[None, :] - 2.0 * points @ centers.T, 0.0)
    eff = sq * inv2[None, :]
    idx = torch.argmin(eff, dim=1).to(torch.int32)
    rows = torch.arange(points.shape[0], device=points.device)
    best = eff[rows, idx.long()]
    masked = eff.clone()
    masked[rows, idx.long()] = float("inf")
    second = torch.min(masked, dim=1).values
    return idx, best, second


def center_update_ref(points, weights, assignment, k: int):
    """Weighted per-cluster sums (movement phase oracle). Returns (wsum
    [k, d], wcount [k])."""
    d = points.shape[1]
    wsum = torch.zeros(k, d, dtype=points.dtype, device=points.device)
    wsum.index_add_(0, assignment.long(), weights[:, None] * points)
    wcount = torch.zeros(k, dtype=weights.dtype, device=weights.device)
    wcount.index_add_(0, assignment.long(), weights)
    return wsum, wcount
