"""Dense PyTorch oracles for the kernels: the assignment sweep, causal
attention and the MoE router (reference: ``repro/kernels/ref.py``)."""
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


def flash_attention_ref(q, k, v, softcap: float = 0.0):
    """Dense causal attention oracle. q: [BH, S, dh], k/v: [BKV, S, dh]
    with BH % BKV == 0 (GQA). Returns [BH, S, dh] in q.dtype."""
    BH, S, dh = q.shape
    G = BH // k.shape[0]
    kx = torch.repeat_interleave(k, G, dim=0).float()
    vx = torch.repeat_interleave(v, G, dim=0).float()
    s = torch.einsum("hqd,htd->hqt", q.float(), kx) * (dh ** -0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqt,htd->hqd", p, vx).to(q.dtype)


def row_relative_error(got, want) -> float:
    """Largest per-row relative error of an attention output: for each row
    (one query position of one head, the last dim), the largest |got -
    want| over the largest |want| of that row; the maximum over rows. A
    late query averages thousands of values down to a few hundredths, so
    an absolute tolerance that fits the early rows misses faults there."""
    g, w = got.float(), want.float()
    err = torch.amax(torch.abs(g - w), dim=-1)
    ref = torch.clamp_min(torch.amax(torch.abs(w), dim=-1), 1e-30)
    return float(torch.max(err / ref))


def router_eff_ref(x, centroids, inv2):
    """Dense effective squared distances of every token to every expert,
    ``max(|x|^2 + |c|^2 - 2 x.c, 0) * inv2``, float32 [T, E]."""
    xf = x.float()
    c = centroids.float()
    xn = torch.sum(xf * xf, dim=1, keepdim=True)
    cn = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(xn + cn - 2.0 * xf @ c.T, 0.0) * inv2[None, :]


def router_topk_ref(x, centroids, inv2, top_k: int):
    """Balanced-k-means router oracle: the top-k smallest effective
    squared distances, ascending, the lower expert index first on ties
    (a stable sort, as ``jax.lax.top_k`` orders ties). Returns (idx [T, k]
    int32, eff [T, k] float32)."""
    vals, idx = torch.sort(router_eff_ref(x, centroids, inv2), dim=1,
                           stable=True)
    return idx[:, :top_k].to(torch.int32), vals[:, :top_k]


def router_topk_disagreements(idx, eff, full, rtol: float = 1e-4,
                              atol: float = 1e-4) -> list[str]:
    """Where a router result ``(idx, eff)`` [T, K] departs from the dense
    effective distances ``full`` [T, E] of the same inputs; empty when it
    agrees. It agrees when every row names K distinct experts, each named
    expert's ``eff`` is its distance in ``full``, ``eff`` is the K smallest
    distances in order, and ``idx`` is their stable order except at a tie:
    a position whose distance lies within the tolerance of a neighbour's,
    the (K+1)-th smallest included. Closeness is ``allclose``'s,
    ``|a - b| <= atol + rtol |b|``."""
    T, K = idx.shape
    E = full.shape[1]
    i = idx.long()
    if not bool(((i >= 0) & (i < E)).all()):
        return [f"an expert index lies outside [0, {E})"]
    full, eff = full.double(), eff.double()

    def close(a, b):
        return (a - b).abs() <= atol + rtol * b.abs()

    out = []
    srt = torch.sort(i, dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        out.append("a row names one expert twice")
    named = torch.gather(full, 1, i)
    if not bool(close(eff, named).all()):
        err = float((eff - named).abs().max())
        out.append(f"eff is not the named experts' distance (max |err| "
                   f"{err:.3g})")
    vals, order = torch.sort(full, dim=1, stable=True)
    if not bool(close(eff, vals[:, :K]).all()):
        err = float((eff - vals[:, :K]).abs().max())
        out.append(f"eff is not the {K} smallest distances (max |err| "
                   f"{err:.3g})")
    n = min(K + 1, E)
    near = close(vals[:, 1:n], vals[:, :n - 1])   # position j ties j + 1
    tie = torch.zeros(T, K, dtype=torch.bool, device=full.device)
    tie[:, 1:] |= near[:, :K - 1]
    tie[:, :n - 1] |= near
    off = (i != order[:, :K]) & ~tie
    if bool(off.any()):
        out.append(f"{int(off.sum())} indices differ from the stable order "
                   f"off a tie")
    return out
