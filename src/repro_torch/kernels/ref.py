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


def _router_sq(x, centroids):
    """``max(|x|^2 + |c|^2 - 2 x.c, 0)`` of every token and expert, float32
    [T, E], in the reference model's order of operations."""
    xf = x.float()
    c = centroids.float()
    xn = torch.sum(xf * xf, dim=1, keepdim=True)
    cn = torch.sum(c * c, dim=1)[None, :]
    return torch.clamp_min(xn + cn - 2.0 * xf @ c.T, 0.0)


def router_eff_ref(x, centroids, inv2):
    """Dense effective squared distances of every token to every expert,
    ``max(|x|^2 + |c|^2 - 2 x.c, 0) * inv2``, float32 [T, E]."""
    return _router_sq(x, centroids) * inv2[None, :]


def router_eff_div_ref(x, centroids, influence=None):
    """The same divided by ``influence^2``, as the reference model's
    ``router_logits`` computes it; unscaled where ``influence`` is None."""
    sq = _router_sq(x, centroids)
    return sq if influence is None else sq / (influence * influence)[None, :]


def _topk_ascending(eff, top_k: int):
    # a stable sort: the lower expert index first on ties, as
    # jax.lax.top_k orders them
    vals, idx = torch.sort(eff, dim=1, stable=True)
    return idx[:, :top_k].to(torch.int32), vals[:, :top_k]


def router_topk_ref(x, centroids, inv2, top_k: int):
    """Balanced-k-means router oracle: the top-k smallest effective
    squared distances, ascending, the lower expert index first on ties.
    Returns (idx [T, k] int32, eff [T, k] float32)."""
    return _topk_ascending(router_eff_ref(x, centroids, inv2), top_k)


def router_topk_div_ref(x, centroids, influence, top_k: int):
    """``router_topk_ref`` in the divide form (``router_eff_div_ref``)."""
    return _topk_ascending(router_eff_div_ref(x, centroids, influence),
                           top_k)


def router_near_tie_case(n_tokens: int, n_experts: int, d: int, seed: int):
    """Integer-valued router inputs with planted near-ties: (x [n_tokens,
    d], centroids [n_experts, d], influence [n_experts]) float32 numpy
    arrays. Every dot product is exact in float32, so ``sq`` is the same
    integer on every backend and only the scale rounds.

    Planted token p (coordinates 4p .. 4p + 3, ``min(d // 4, n_experts //
    3)`` of them, repeated to fill ``n_tokens``) has three experts of its
    own: a near one (sq 1 or 2) and a pair a < b (sq 8-11 and sq_a + 1-3)
    whose influences make ``sq / influence^2`` tie exactly, so the
    divide form ranks a first, while ``sq * (1 / influence^2)`` ranks b
    strictly first. They are the token's ranks 0, 1, 2; every other
    expert lies at sq >= 64. At top_k = 2 the two forms pick different
    experts; at top_k >= 3 they order them differently."""
    import numpy as np
    f32 = np.float32
    rng = np.random.default_rng(seed)
    n_plant = min(d // 4, n_experts // 3)
    if n_plant < 1:
        raise ValueError("router_near_tie_case needs d >= 4, n_experts >= 3")
    x = np.zeros((n_plant, d), f32)
    c = np.zeros((n_experts, d), f32)
    infl = rng.uniform(0.8, 1.25, n_experts).astype(f32)

    def offset(sq):
        # an integer vector of 4 coordinates with squared norm sq
        for _ in range(10000):
            u = rng.integers(-3, 4, 4)
            if int(u @ u) == sq:
                return u
        raise RuntimeError(f"no 4-vector of squared norm {sq}")

    for p in range(n_plant):
        cols = slice(4 * p, 4 * p + 4)
        x[p, cols] = rng.choice([-6, -5, -4, 4, 5, 6], 4)
        near, a, b = 3 * p, 3 * p + 1, 3 * p + 2
        sq_a = int(rng.integers(8, 12))
        sq_b = sq_a + int(rng.integers(1, 4))
        c[near, cols] = x[p, cols] + offset(int(rng.integers(1, 3)))
        c[a, cols] = x[p, cols] + offset(sq_a)
        c[b, cols] = x[p, cols] + offset(sq_b)
        infl[near] = f32(1.0)
        for _ in range(1000):
            ia = f32(rng.uniform(0.9, 1.1))
            da = f32(sq_a) / (ia * ia)
            ma = f32(sq_a) * (f32(1.0) / (ia * ia))
            # float32 influences of b around the exact tie
            ib = f32(ia * np.sqrt(sq_b / sq_a))
            found = None
            for _ in range(200):
                db = f32(sq_b) / (ib * ib)
                mb = f32(sq_b) * (f32(1.0) / (ib * ib))
                if db == da and mb < ma:
                    found = ib
                    break
                ib = np.nextafter(ib, f32(2.0) if db > da else f32(0.0))
            if found is not None:
                infl[a], infl[b] = ia, found
                break
        else:
            raise RuntimeError("no planted near-tie found")
    reps = -(-n_tokens // n_plant)
    return np.tile(x, (reps, 1))[:n_tokens], c, infl


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
