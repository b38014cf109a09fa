"""Plain checks of a balanced k-means partition: the effective-distance
assignment worked out again in float64, the balance and the migration.

The partitioner returns, beside its labels, the state that produced them:
the final centers and influence (paper Eq. 1). Its last step assigns every
point to the center of least effective distance ``|p - c|^2 /
influence_c^2``. This module works that step out again from the same
points and the returned state, in float64 and by explicit differences, and
measures by how much the program's label is worse than the best center:

    gap_p = (eff(p, label_p) - min_c eff(p, c)) / scale_p,
    scale_p = (|p|^2 + |c_label|^2) / infl_label^2

The denominator is the scale of the rounding of the kernel's float32
expansion ``|p|^2 + |c|^2 - 2 p.c``; a sound float32 sweep reads a few
units of 2^-24 there, a sweep whose cross term is rounded to bfloat16
reads a few units of 2^-9.

The centers are held too: balanced k-means moves each center to the
weighted mean of its block (Alg. 2's movement phase), and stops when no
center moves by more than a small share of the bounding box's diagonal;
its final pass assigns under the centers it returns. So a returned center
lies near the weighted mean of its block under the reference's labels,
at a small share of the blocks' radius:

    center_gap = max_b |c_b - mean_b| / mean_b radius_b

where ``radius_b`` is the root of the block's weighted mean squared
distance to its mean. Centers that never moved, as the bootstrap's or a
previous step's, read a large share of a radius.

Plain PyTorch on whatever device the tensors are on, chunked over the
points. Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch


def assignment(points: torch.Tensor, centers, influence, labels=None,
               chunk: int = 1 << 16):
    """(worst normalized gap of ``labels``, the reference's labels [n]
    int64) for ``points`` [n, d] (the float32 values the program solved
    on), ``centers`` [k, d] and ``influence`` [k]. With ``labels`` None
    the gap is 0."""
    dev = points.device
    p_all = points.to(torch.float64)
    c = torch.as_tensor(np.asarray(centers), device=dev).to(torch.float64)
    infl = torch.as_tensor(np.asarray(influence), device=dev).to(
        torch.float64)
    inv2 = 1.0 / (infl * infl)
    cn = torch.sum(c * c, dim=1)
    n, d = p_all.shape
    lab_all = (None if labels is None else
               torch.as_tensor(np.asarray(labels), device=dev).long())
    ref = torch.empty(n, dtype=torch.int64, device=dev)
    worst = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, n, chunk):
        p = p_all[s:s + chunk]
        d2 = torch.zeros(p.shape[0], c.shape[0], dtype=torch.float64,
                         device=dev)
        for j in range(d):
            d2 += (p[:, j, None] - c[None, :, j]) ** 2
        eff = d2 * inv2[None]
        best, arg = torch.min(eff, dim=1)
        ref[s:s + chunk] = arg
        if lab_all is not None:
            lab = lab_all[s:s + chunk]
            mine = eff.gather(1, lab[:, None])[:, 0]
            scale = (torch.sum(p * p, dim=1) + cn[lab]) * inv2[lab]
            gap = torch.where(mine > best, (mine - best) / scale, 0.0)
            worst = torch.maximum(worst, torch.max(gap))
    return float(worst), ref


def center_gap(points: torch.Tensor, labels, centers, weights=None,
               chunk: int = 1 << 20) -> float:
    """Worst distance of a returned center from the weighted mean of its
    block under ``labels``, over the mean radius of the blocks, in
    float64. Blocks of no weight are left out."""
    dev = points.device
    c = torch.as_tensor(centers, device=dev).to(torch.float64)
    k, d = c.shape
    lab_all = torch.as_tensor(labels, device=dev).long()
    w_all = (None if weights is None else
             torch.as_tensor(weights, device=dev).to(torch.float64))
    n = points.shape[0]
    cw = torch.zeros(k, dtype=torch.float64, device=dev)
    cs = torch.zeros(k, d, dtype=torch.float64, device=dev)
    for s in range(0, n, chunk):
        p = points[s:s + chunk].to(torch.float64)
        lab = lab_all[s:s + chunk]
        w = (torch.ones(p.shape[0], dtype=torch.float64, device=dev)
             if w_all is None else w_all[s:s + chunk])
        cw.index_add_(0, lab, w)
        cs.index_add_(0, lab, p * w[:, None])
    live = cw > 0
    mean = cs / torch.clamp_min(cw, 1e-300)[:, None]
    sq = torch.zeros(k, dtype=torch.float64, device=dev)
    for s in range(0, n, chunk):
        p = points[s:s + chunk].to(torch.float64)
        lab = lab_all[s:s + chunk]
        w = (torch.ones(p.shape[0], dtype=torch.float64, device=dev)
             if w_all is None else w_all[s:s + chunk])
        sq.index_add_(0, lab, w * torch.sum((p - mean[lab]) ** 2, dim=1))
    radius = torch.sqrt(sq[live] / cw[live])
    move = torch.sqrt(torch.sum((c[live] - mean[live]) ** 2, dim=1))
    return float(torch.max(move) / torch.mean(radius))


def imbalance(labels, k: int, weights=None) -> float:
    """``max_b W_b / (W / k) - 1`` in float64."""
    labels = np.asarray(labels)
    w = None if weights is None else np.asarray(weights, np.float64)
    sizes = np.bincount(labels, weights=w, minlength=k)
    total = labels.shape[0] if w is None else float(np.sum(w))
    return float(sizes.max() / (total / k) - 1.0)


def migration(prev, new, weights=None) -> float:
    """Share of the total weight whose block changed, in float64."""
    prev, new = np.asarray(prev), np.asarray(new)
    w = (np.ones(prev.shape[0]) if weights is None
         else np.asarray(weights, np.float64))
    return float(np.sum(w[prev != new]) / np.sum(w))
