"""Plain size-constrained label propagation, written from the algorithm's
statement (``partition/refine.py``'s docstring and DESIGN.md §11 of this
repository), for unit node weights.

One synchronous round:

1. the budget of block b is ``max(limit - W_b, 0)``, with ``limit =
   floor((1 + eps) * n / k)`` and ``W_b`` the nodes in b;
2. each node counts its neighbours in each block; its target is the block
   with the most neighbours among those whose budget is at least 1 (its
   own included), ties to the lowest block id, and its gain is that count
   minus the count in its own block when positive;
3. a node with a positive gain is a candidate unless a neighbour has a
   larger gain, or the same gain and a lower node id;
4. the candidates of each target block, by gain (largest first) and then
   node id, move while their running count fits the target's budget.

Rounds repeat until one moves nothing or ``max_rounds`` rounds ran. The
rounds run on canonical block ids: the rank of each block's lowest node
id (empty blocks last, by id), mapped back at the end, so the result does
not depend on how the input's blocks are numbered.

Plain PyTorch on whatever device the tensors are on. Imports nothing of
the program.
"""
from __future__ import annotations

import numpy as np
import torch

MAX_ROUNDS = 128
_I64_MAX = int(np.iinfo(np.int64).max)


def edge_cut(labels: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor) -> int:
    """Undirected edges whose ends lie in different blocks (each edge is
    stored in both directions)."""
    return int(torch.sum(labels[src] != labels[dst])) // 2


def edges(indptr: torch.Tensor, indices: torch.Tensor):
    """(src, dst) int64 of a CSR graph."""
    n = indptr.numel() - 1
    src = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                  indptr[1:] - indptr[:-1])
    return src, indices.long()


def refine(labels: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
           k: int, eps: float, max_rounds: int = MAX_ROUNDS):
    """(refined labels [n] int64, rounds) of ``labels`` [n] int64 over the
    graph's directed edges ``src`` -> ``dst`` (both directions)."""
    dev = labels.device
    n = labels.numel()
    limit = min(max(int(np.floor((1.0 + eps) * n / k)), 0), n)
    ids = torch.arange(n, device=dev)
    first = torch.full((k,), _I64_MAX, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, labels, ids, "amin")
    order = torch.sort(first, stable=True).indices      # canonical -> id
    canon = torch.empty(k, dtype=torch.int64, device=dev)
    canon[order] = torch.arange(k, device=dev)
    lab = canon[labels]
    lower = dst < src                    # the neighbour's id is lower
    span = int(torch.bincount(src, minlength=n).max()) + 2
    rounds = 0
    while rounds < max_rounds:
        rounds += 1
        budget = (limit - torch.bincount(lab, minlength=k)).clamp(min=0)
        pair, count = torch.unique(src * k + lab[dst], return_counts=True)
        v, b = pair // k, pair % k
        own = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce(
            0, v, torch.where(b == lab[v], count, 0), "amax")
        score = torch.where(budget[b] >= 1, count, -1)
        best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        best = best.scatter_reduce(0, v, score, "amax")
        tgt = torch.full((n,), k, dtype=torch.int64, device=dev)
        tgt = tgt.scatter_reduce(
            0, v, torch.where((score == best[v]) & (score > 0), b, k), "amin")
        gain = torch.where(best > own, best - own, 0)
        gs, gd = gain[src], gain[dst]
        beaten = (gd > gs) | ((gd == gs) & lower)
        dominated = torch.zeros(n, dtype=torch.int64, device=dev).index_add(
            0, src, beaten.long()) > 0
        cand = torch.nonzero((gain > 0) & ~dominated)[:, 0]   # by node id
        if cand.numel() == 0:
            break
        key = tgt[cand] * span + (span - 1 - gain[cand])
        ranked = cand[torch.sort(key, stable=True).indices]
        t = tgt[ranked]
        starts = torch.searchsorted(t, t, right=False)
        rank = torch.arange(ranked.numel(), device=dev) - starts
        take = rank < budget[t]
        if not bool(torch.any(take)):
            break
        lab[ranked[take]] = t[take]
    return order[lab], rounds
