"""``refine()`` — size-constrained label-propagation refinement
(counterpart of ``repro/partition/refine.py``)::

    from repro_torch.partition import PartitionProblem, partition, refine

    prob = PartitionProblem.from_mesh(mesh, k=32)
    res  = partition(prob, method="geographer")      # on the card
    ref  = refine(prob, res)                         # rounds on the card
    ref  = refine(prob, res, device="cpu")           # the same bits on the host
    ref  = refine(prob, res, devices=4)              # sharded over 4 ranks
    ref  = partition(prob, method="rcb", refine=True)   # composed

Geometric solvers lose to graph partitioners on cut and communication
volume; label propagation is the cheap post-pass that wins some of that
back. One synchronous round moves boundary nodes to their best admissible
neighbour block:

1.  Budgets: ``budget_b = max(limit - W_b, 0)`` over quantized integer
    block weights, ``limit = floor((1+eps) * W / k) - margin``.
2.  Every node picks the admissible block (``budget_b >= iw_v``) holding
    most of its neighbours, ties to the lowest block id; its gain is that
    count minus the count in its own block, when positive.
3.  A candidate moves only if no neighbouring candidate has strictly
    higher priority (gain, then lower node key): the accepted moves form
    an independent set, so each gain is exact and the edge cut falls by
    their sum.
4.  Survivors are taken per target block in (gain desc, key asc) order
    while the running quantized weight fits the budget.

Rounds repeat until one accepts no move or ``max_rounds``. Every step is
integer arithmetic, so the rounds here give the reference's host rounds
(``_lp_rounds_host``) bit for bit, on the card and on the host alike.
The reference builds a dense ``[n, k]`` neighbour-block histogram each
round; ``_lp_rounds`` builds the same function from the edges sorted by
(source, neighbour block), so its memory is that of the edge list, not
``n * k``. ``_lp_rounds_plain`` is the dense form, line for line, kept as
the reference the tests and the on-card checks hold the rounds against.

``devices=P`` runs the rounds over P ranks (``_lp_rounds_sharded``), each
holding its shard of an ``eval.sharded.ShardedGraph``. A round makes four
sum all-reduces (labels, block weights, gains, accepted targets) and
decides everything else from the replicated vectors, so every rank count
gives the single-card rounds' bits.

Determinism: block ids are canonicalized on entry (rank of each block's
minimum member key) and mapped back on exit, and every tie breaks on an
integer total order (block id for the target, the node key for the move
priority), so refinement is exactly equivariant under block relabelings
and, through ``node_order``, under point permutations.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.metrics import edge_cut, imbalance, quantize_weights
from repro_torch.device import resolve_device
from repro_torch.dist import launch
from repro_torch.dist.rules import comm_for, mesh_size

from .distributed import _devices_stat
from .problem import PartitionProblem, PartitionResult

#: rounds cap — the cut strictly decreases every effective round, so this
#: is a bound, not a tuning knob (convergence is usually O(10))
DEFAULT_MAX_ROUNDS = 128

_REFINERS: dict[str, Callable] = {}
_ALIASES: dict[str, str] = {}
_SHORT: dict[str, str] = {}

_I64 = torch.int64


class UnknownRefinerError(KeyError):
    pass


def register_refiner(name: str, aliases: tuple[str, ...] = (),
                     short: str | None = None):
    """Decorator: register a refinement pass under ``name`` (+ aliases),
    so ``partition(..., refine=...)`` resolves names the way the solver
    registry does (typos fail loudly, aliases resolve).

    Args:
        name: canonical registry key.
        aliases: extra names resolving to ``name``.
        short: suffix used in composed method names (default: the
            canonical name).
    """
    def deco(fn: Callable) -> Callable:
        if name in _REFINERS:
            raise ValueError(f"refiner {name!r} already registered")
        _REFINERS[name] = fn
        _SHORT[name] = short or name
        for a in aliases:
            _ALIASES[a] = name
        return fn
    return deco


def resolve_refiner(name) -> str:
    """Canonical refiner name (aliases resolve; True means the default)."""
    if name is True:
        name = "label_prop"
    name = _ALIASES.get(name, name)
    if name not in _REFINERS:
        raise UnknownRefinerError(
            f"unknown refinement method {name!r}; available: "
            f"{available_refiners()} (aliases: {sorted(_ALIASES)})")
    return name


def available_refiners() -> list[str]:
    """Sorted canonical names of every registered refinement pass."""
    return sorted(_REFINERS)


def refiner_short_name(name) -> str:
    """Suffix for composed method names, e.g. ``'lp'`` -> "geographer+lp"."""
    return _SHORT[resolve_refiner(name)]


# ---------------------------------------------------------------------------
# balance-budget protocol

def refinement_quantization(problem: PartitionProblem,
                            eps: float | None = None
                            ) -> tuple[np.ndarray, int]:
    """The fixed-point balance protocol of one refinement call.

    Args:
        problem: the partitioning instance.
        eps: balance slack (None = ``problem.epsilon``).

    Returns:
        (iw [n] int64 quantized node weights, limit int) — a block may
        never be filled past ``limit`` quantized units. ``limit`` shaves
        a margin of n units off ``floor((1+eps) * sum(iw) / k)`` for
        float weights (absorbing worst-case 0.5/node rounding drift so
        the real-weight imbalance stays <= eps too); unit weights
        quantize exactly, so their margin is 0.
    """
    eps = problem.epsilon if eps is None else float(eps)
    if eps < 0:
        raise ValueError(f"eps must be >= 0, got {eps}")
    iw = quantize_weights(problem.weights, problem.n)
    margin = 0 if problem.weights is None else problem.n
    W = int(iw.sum())
    limit = int(np.floor((1.0 + eps) * W / problem.k)) - margin
    # a block never holds more than the total weight: clamping at W
    # changes no decision and keeps every budget within int32
    return iw, min(max(limit, 0), W)


def refinement_budgets(problem: PartitionProblem, labels: np.ndarray,
                       eps: float | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Round-start admissibility budgets for ``labels``.

    Args:
        problem: the partitioning instance.
        labels: [n] block ids.
        eps: balance slack (None = ``problem.epsilon``).

    Returns:
        (iw [n] int64, budget [k] int64): a move of node v into block b
        is admissible iff ``iw[v] <= budget[b]``.
    """
    iw, limit = refinement_quantization(problem, eps)
    # an integer sum; the reference sums the same integers in float64
    # (np.bincount with weights=), which is exact below 2^53, so both give
    # the same block weights
    W = np.zeros(problem.k, np.int64)
    np.add.at(W, np.asarray(labels), iw)
    return iw, np.maximum(limit - W, 0)


def _canonicalize(labels: np.ndarray, keys: np.ndarray,
                  k: int) -> tuple[np.ndarray, np.ndarray]:
    """Map block ids to their canonical order (rank of each block's
    minimum member key; empty blocks trail). Returns (canonical labels,
    order) with ``order[canonical_id] = original_id`` — the inverse map.

    The canonical space depends only on which nodes share a block, never
    on the id values, so running the rounds in it makes refinement
    exactly equivariant under block relabelings. Empty blocks are never
    move targets (no node has a neighbour there), so where they trail
    changes no decision.
    """
    first = np.full(k, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, labels, keys.astype(np.int64))
    order = np.lexsort((np.arange(k), first))
    canon = np.empty(k, np.int64)
    canon[order] = np.arange(k)
    return canon[labels], order


# ---------------------------------------------------------------------------
# the rounds

def _edges(indptr, indices, dev: torch.device):
    """(src, dst) int64 [m] of the CSR graph on ``dev``."""
    indptr = torch.as_tensor(np.asarray(indptr, np.int64)).to(dev)
    dst = torch.as_tensor(np.asarray(indices, np.int64)).to(dev)
    n = indptr.numel() - 1
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  indptr[1:] - indptr[:-1],
                                  output_size=dst.numel())
    return src, dst


def _targets(labels, src, dst, iw, budget, k: int, glabels=None):
    """Each node's best admissible target and its gain, from the sparse
    neighbour-block histogram.

    The edges sorted by ``src * k + glabels[dst]`` put each (node, block)
    pair's edges in one run; the run's length is ``H[v, b]`` of the dense
    form, and only pairs with ``H >= 1`` exist. ``glabels`` is the label
    vector that ``dst`` indexes (None: ``labels``; a rank passes the
    global vector, its nodes being a slice of it). Returns (tgt, gain),
    [n] int64 each.

    The dense form also names a target for a node whose admissible
    blocks hold none of its neighbours (the lowest admissible block, at
    ``H = 0``); here such a node keeps ``tgt = k``. The two agree
    wherever ``tgt`` is read: the dense gain is positive only when the
    best admissible count exceeds ``own >= 0``, so it is at least 1 and
    sits at a pair that exists here, and every later use of ``tgt`` (the
    acceptance order, the move) is masked by ``gain > 0``.
    """
    n = labels.numel()
    nb = (labels if glabels is None else glabels)[dst]
    key, _ = torch.sort(src * k + nb)
    # every edge of a run carries the run's length; the reductions below
    # are max and min, so reading a run once or many times is the same
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    run = torch.cumsum(new, 0) - 1
    cnt = torch.zeros_like(key).index_add_(0, run, torch.ones_like(key))[run]
    v = torch.div(key, k, rounding_mode="floor")
    b = key - v * k
    own = torch.zeros(n, dtype=_I64, device=key.device).scatter_reduce_(
        0, v, torch.where(b == labels[v], cnt, 0), "amax")
    score = torch.where(budget[b] >= iw[v], cnt, -1)
    best = torch.full((n,), -1, dtype=_I64, device=key.device)
    best.scatter_reduce_(0, v, score, "amax")
    tgt = torch.full((n,), k, dtype=_I64, device=key.device)
    tgt.scatter_reduce_(0, v, torch.where((score == best[v]) & (score > 0),
                                          b, k), "amin")
    gain = torch.where(best > own, best - own, 0)
    return tgt, gain


def _dominated(gain, src, dst, key_lt, n: int, ggain=None) -> torch.Tensor:
    """[n] bool: some neighbour has strictly higher (gain, lower key)
    priority. ``key_lt[e]`` is ``keys[dst[e]] < keys[src[e]]``; ``ggain``
    is the gain vector that ``dst`` indexes (None: ``gain``)."""
    gs, gd = gain[src], (gain if ggain is None else ggain)[dst]
    dom_e = (gd > gs) | ((gd == gs) & key_lt)
    hits = torch.zeros(n, dtype=torch.int32, device=gain.device)
    return hits.index_add_(0, src, dom_e.to(torch.int32)) > 0


def _accept(acc0, tgt, gain, iw, by_key, budget, k: int, span: int):
    """[n] bool: the candidates ``acc0`` taken per target block, in
    (gain desc, key asc) order, while the running weight fits the budget.

    One stable sort of the exact int64 key ``tgt * span + (span - 1 -
    gain)`` (``span`` exceeds every gain) over the nodes in key order
    gives the reference's ``lexsort((keys, -gain, stgt))`` order of the
    candidates; the non-candidates all sort after them and accept
    nothing, as there.
    """
    c = torch.where(acc0, tgt * span + (span - 1 - gain), k * span)
    order = by_key[torch.sort(c[by_key], stable=True).indices]
    st = torch.where(acc0, tgt, k)[order]
    siw = torch.where(acc0, iw, 0)[order]
    csum = torch.cumsum(siw, 0)
    # the weight before each target's segment: the reference's running
    # maximum of the segment starts' ``csum - siw``, which (``siw >= 0``)
    # is the least ``csum - siw`` of the segment, keyed by the target
    before = csum - siw
    base = torch.full((k + 1,), int(np.iinfo(np.int64).max), dtype=_I64,
                      device=st.device).scatter_reduce_(0, st, before, "amin")
    ok = (st < k) & (csum - base[st] <= budget[st.clamp(max=k - 1)])
    accept = torch.zeros_like(acc0)
    accept[order] = ok
    return accept


def _lp_rounds(labels, indptr, indices, iw, keys, k: int, limit: int,
               max_rounds: int, device=None):
    """The synchronous rounds on ``device`` (None = ``cuda``), from the
    sparse histogram. Arguments as the reference's ``_lp_rounds_host``
    (host arrays). Returns (labels [n] int64 numpy, rounds, moves,
    last_moved, gain): the first four equal the reference's bit for bit;
    ``gain`` is the sum of the accepted moves' gains, which is the cut's
    decrease."""
    dev = resolve_device(device)
    n = labels.shape[0]
    lab = torch.as_tensor(np.asarray(labels, np.int64)).to(dev)
    iw_t = torch.as_tensor(np.asarray(iw, np.int64)).to(dev)
    keys_t = torch.as_tensor(np.asarray(keys, np.int64)).to(dev)
    src, dst = _edges(indptr, indices, dev)
    key_lt = keys_t[dst] < keys_t[src]
    by_key = torch.sort(keys_t, stable=True).indices
    span = int(np.diff(np.asarray(indptr)).max(initial=0)) + 1
    gain_total = torch.zeros((), dtype=_I64, device=dev)
    rounds, moves_total, moved = 0, 0, 1
    while rounds < max_rounds and moved > 0:
        W = torch.zeros(k, dtype=_I64, device=dev).index_add_(0, lab, iw_t)
        budget = (limit - W).clamp_(min=0)
        tgt, gain = _targets(lab, src, dst, iw_t, budget, k)
        acc0 = (gain > 0) & ~_dominated(gain, src, dst, key_lt, n)
        accept = _accept(acc0, tgt, gain, iw_t, by_key, budget, k, span)
        gain_total += torch.where(accept, gain, 0).sum()
        lab = torch.where(accept, tgt, lab)
        moved = int(accept.sum())      # the round's one read: the loop test
        rounds += 1
        moves_total += moved
    return (lab.cpu().numpy(), rounds, moves_total, moved,
            int(gain_total))


def _lp_rounds_plain(labels, indptr, indices, iw, keys, k: int, limit: int,
                     max_rounds: int, device=None):
    """The reference's dense host rounds, line for line in torch on
    ``device`` (None = ``cuda``): a dense ``[n, k]`` histogram each round
    and the lexsort as three stable sorts. The reference the tests and
    the on-card checks hold ``_lp_rounds`` against; no entry point runs
    it. Same arguments and returns as ``_lp_rounds``."""
    dev = resolve_device(device)
    n = labels.shape[0]
    labels = torch.as_tensor(np.asarray(labels, np.int64)).to(dev)
    iw = torch.as_tensor(np.asarray(iw, np.int64)).to(dev)
    keys = torch.as_tensor(np.asarray(keys, np.int64)).to(dev)
    src, indices = _edges(indptr, indices, dev)
    arange_n = torch.arange(n, device=dev)
    gain_total = 0
    rounds, moves_total, moved = 0, 0, 1
    while rounds < max_rounds and moved > 0:
        W = torch.zeros(k, dtype=_I64, device=dev).index_add_(0, labels, iw)
        budget = (limit - W).clamp(min=0)
        nb = labels[indices]
        H = torch.zeros((n, k), dtype=_I64, device=dev)
        H.index_put_((src, nb), torch.ones_like(nb), accumulate=True)
        own = H[arange_n, labels]
        adm = budget[None, :] >= iw[:, None]
        Hm = torch.where(adm, H, -1)
        tgt = torch.argmax(Hm, dim=1)
        gain = torch.where(Hm[arange_n, tgt] > own,
                           Hm[arange_n, tgt] - own, 0)
        myg, nbg = gain[src], gain[indices]
        myk, nbk = keys[src], keys[indices]
        dom_e = (nbg > myg) | ((nbg == myg) & (nbk < myk))
        dom = torch.zeros(n, dtype=_I64, device=dev).index_add_(
            0, src, dom_e.to(_I64)) > 0
        acc0 = (gain > 0) & ~dom
        stgt = torch.where(acc0, tgt, k)
        order = torch.argsort(keys, stable=True)
        order = order[torch.argsort(-gain[order], stable=True)]
        order = order[torch.argsort(stgt[order], stable=True)]
        st = stgt[order]
        siw = torch.where(acc0, iw, 0)[order]
        csum = torch.cumsum(siw, 0)
        is_start = torch.ones(n, dtype=torch.bool, device=dev)
        is_start[1:] = st[1:] != st[:-1]
        base = torch.cummax(torch.where(is_start, csum - siw, 0), 0).values
        ok = (st < k) & (csum - base <= budget[st.clamp(max=k - 1)])
        accept = torch.zeros(n, dtype=torch.bool, device=dev)
        accept[order] = ok
        moved = int(accept.sum())
        gain_total += int(torch.where(accept, gain, 0).sum())
        labels = torch.where(accept, tgt, labels)
        rounds += 1
        moves_total += moved
    return labels.cpu().numpy(), rounds, moves_total, moved, gain_total


# ---------------------------------------------------------------------------
# the sharded rounds (one rank's share)

def _lp_rounds_sharded(graph, labels, iw, keys, k: int, limit: int,
                       max_rounds: int, comm, device=None):
    """The synchronous rounds on the calling rank over its shard of
    ``graph`` (an ``eval.sharded.ShardedGraph``); ``comm`` is the rank's
    communicator over ``graph.devices`` ranks. Arguments and returns as
    ``_lp_rounds``, the same on every rank and bit for bit theirs.

    A rank holds its slots (``gather``, ``valid``) and their edges (local
    ``src``, global ``dst``). Each round makes the reference's four sum
    all-reduces and no other communication: the [n] label vector (each
    rank writes its valid slots into zeros), the [k] quantized block
    weights, the [n] gain vector, and the [n] packed words ``accepted ?
    target + 1 : 0``. A rank's targets and its dominance test read only
    its own edges and those global vectors, so they equal the single-card
    ``_targets`` and ``_dominated`` on its nodes; the acceptance runs on
    the replicated vectors, as the single card's does. The loop test is
    read from the replicated acceptance, so every rank takes the same
    rounds. Padded slots hold no edges, weigh 0, and follow the label of
    the point they copy (``ShardedPartitionProblem.deal``).

    The collectives carry int32, the reference's width: labels and packed
    words are below k + 1, gains below the largest degree, and the block
    weights sum quantized weights whose total is below 2^30
    (``quantize_weights``), so no sum overflows.
    """
    dev = launch.rank_device(resolve_device(device), comm.rank)
    sp = graph.sharded
    p, n = comm.shard_id, sp.problem.n
    i32 = torch.int32

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    gidx, lvalid = on(sp.gather[p]), on(sp.valid[p])
    mine = gidx[lvalid]
    ev = graph.edge_valid[p]
    src = on(graph.src[p][ev].astype(np.int64))
    dst = on(graph.dst[p][ev].astype(np.int64))
    giw = on(np.asarray(iw, np.int64))
    gkeys = on(np.asarray(keys, np.int64))
    lab = on(np.asarray(labels, np.int64)[sp.gather[p]])
    liw = torch.where(lvalid, giw[gidx], 0)
    key_lt = gkeys[dst] < gkeys[gidx][src]
    by_key = torch.sort(gkeys, stable=True).indices
    span = int(np.diff(np.asarray(sp.problem.indptr)).max(initial=0)) + 1

    def gsum(vals):
        """[n] int64: the ranks' [cap] values at their points' positions,
        through one int32 sum all-reduce (every point has one valid
        slot)."""
        full = torch.zeros(n, dtype=i32, device=dev)
        full[mine] = vals[lvalid].to(i32)
        return comm.all_reduce(full).long()

    gain_total = torch.zeros((), dtype=_I64, device=dev)
    rounds, moves_total, moved = 0, 0, 1
    while rounds < max_rounds and moved > 0:
        glab = gsum(lab)
        W = comm.all_reduce(torch.zeros(k, dtype=i32, device=dev).index_add_(
            0, lab, liw.to(i32))).long()
        budget = (limit - W).clamp_(min=0)
        tgt, gain = _targets(lab, src, dst, liw, budget, k, glabels=glab)
        ggain = gsum(gain)
        acc0 = (gain > 0) & ~_dominated(gain, src, dst, key_lt, lab.numel(),
                                        ggain=ggain)
        pack = gsum(torch.where(acc0, tgt + 1, 0))
        gtgt = pack - 1
        accept = _accept(pack > 0, gtgt, ggain, giw, by_key, budget, k, span)
        gain_total += torch.where(accept, ggain, 0).sum()
        glab = torch.where(accept, gtgt, glab)
        lab = torch.where(accept[gidx], gtgt[gidx], lab)
        moved = int(accept.sum())      # replicated: every rank reads the same
        rounds += 1
        moves_total += moved
    return (glab.cpu().numpy(), rounds, moves_total, moved,
            int(gain_total))


# ---------------------------------------------------------------------------
# front door

def _node_keys(problem: PartitionProblem, node_order) -> np.ndarray:
    if node_order is None:
        return np.arange(problem.n, dtype=np.int64)
    keys = np.asarray(node_order, np.int64)
    if keys.shape != (problem.n,):
        raise ValueError(f"node_order must be [{problem.n}] unique ints, "
                         f"got shape {keys.shape}")
    if np.unique(keys).size != problem.n:
        raise ValueError("node_order keys must be unique (they are the "
                         "deterministic move-priority tie-break)")
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if keys.min() < lo or keys.max() > hi:
        raise ValueError("node_order keys must fit int32 (the sharded "
                         "path compares them as int32)")
    return keys


@register_refiner("label_prop", aliases=("lp", "labelprop"), short="lp")
def label_prop_refine(problem: PartitionProblem, labels: np.ndarray, *,
                      device: torch.device | str | None = None,
                      devices=None, eps: float | None = None,
                      max_rounds: int = DEFAULT_MAX_ROUNDS,
                      node_order=None, graph=None
                      ) -> tuple[np.ndarray, dict]:
    """Size-constrained label-propagation rounds over ``labels``.

    Args:
        problem: the instance (must carry a CSR graph).
        labels: [n] block ids in original point order.
        device: where the rounds run; None means ``cuda`` and raises
            without a card. ``"cpu"`` gives the same bits on the host.
        devices: None runs the rounds on one device; P >= 1 (or a
            ``(P1, P2)`` mesh, run over its ``P1 * P2`` ranks) runs them
            sharded over P ranks, bit for bit equal. Outside a process
            group the call launches the ranks itself.
        eps: balance slack (None = ``problem.epsilon``).
        max_rounds: round cap.
        node_order: [n] unique int priority keys (None = point order).
        graph: a ``repro_torch.eval.ShardedGraph`` of ``problem`` over the
            same rank count to reuse (devices path only; None builds it).

    Returns:
        (labels [n] int64, info dict with ``rounds`` / ``moves`` /
        ``converged`` as the reference's, and ``gain``: the sum of the
        accepted gains, by which the edge cut fell).

    Raises:
        ValueError: ``graph`` was built for another problem or rank count.
    """
    if not problem.has_graph:
        raise ValueError(
            "problem carries no CSR graph (indptr/indices); label "
            "propagation moves boundary nodes along edges — build the "
            "PartitionProblem via from_mesh or pass indptr/indices")
    labels = np.asarray(labels)
    if labels.shape != (problem.n,):
        raise ValueError(f"labels must be [{problem.n}], "
                         f"got {labels.shape}")
    if max_rounds < 1:
        raise ValueError(f"max_rounds must be >= 1, got {max_rounds}")
    keys = _node_keys(problem, node_order)
    iw, limit = refinement_quantization(problem, eps)
    dev = resolve_device(device)
    if devices is not None:
        if graph is not None and (graph.problem is not problem
                                  or graph.devices != mesh_size(devices)):
            raise ValueError(
                "graph was built for a different problem/devices")
        if launch.needed(devices):
            return launch.run(label_prop_refine, devices, device, problem,
                              labels, device=device, devices=devices,
                              eps=eps, max_rounds=max_rounds,
                              node_order=node_order, graph=graph)
        if graph is None:
            from repro_torch.eval.sharded import ShardedGraph
            graph = ShardedGraph.from_problem(problem, mesh_size(devices))
    labels_c, order = _canonicalize(labels.astype(np.int64), keys,
                                    problem.k)
    if devices is None:
        out_c, rounds, moves, last, gain = _lp_rounds(
            labels_c, problem.indptr, problem.indices, iw, keys, problem.k,
            limit, max_rounds, device=dev)
    else:
        out_c, rounds, moves, last, gain = _lp_rounds_sharded(
            graph, labels_c, iw, keys, problem.k, limit, max_rounds,
            comm_for(devices), device=dev)
    info = {"rounds": rounds, "moves": moves,
            "converged": bool(last == 0), "gain": gain}
    return order[out_c], info


def refine(problem: PartitionProblem, result, method="label_prop", *,
           device: torch.device | str | None = None,
           devices=None, eps: float | None = None,
           evaluate: bool = False, **opts) -> PartitionResult:
    """Refine a partition — the quality-recovery front door next to
    ``partition()`` / ``repartition()``.

    Args:
        problem: the instance (must carry a CSR graph; the geometric
            solvers never read it, the refiner does).
        result: the ``PartitionResult`` to refine, or a raw [n] label
            array.
        method: refiner registry name (``available_refiners()``; aliases
            resolve, unknown names raise ``UnknownRefinerError``). True
            selects the default ``"label_prop"``.
        device: where the rounds run; None means ``cuda`` and raises
            without a card.
        devices: None = one device; P >= 1 = the rounds sharded over P
            ranks (bit for bit equal at every rank count), on the calling
            rank when the caller is one, else on P ranks the refiner
            launches (the cuts are then taken here). A ``(P1, P2)`` mesh
            runs over ``P1 * P2`` ranks and is recorded as ``[P1, P2]``
            (the reference raises there).
        eps: balance slack for the refinement budgets (None =
            ``problem.epsilon``). Refined block weights never exceed
            ``(1 + eps) * W / k``, so a balanced input stays balanced.
        evaluate: fill ``result.quality`` with the paper metric set.
        **opts: forwarded to the refiner (``max_rounds`` /
            ``node_order`` / ``graph`` for label_prop).

    Returns:
        A new ``PartitionResult``: refined labels, ``method`` suffixed
        with the refiner's short name (e.g. ``"geographer+lp"``), the
        base result's centers/influence carried over (still the warm
        state ``repartition()`` resumes from), and
        ``stats["refine"]`` = {method, rounds, moves, converged,
        cut_before, cut_after, devices, eps}, the reference's.
    """
    if not isinstance(problem, PartitionProblem):
        raise TypeError(
            f"refine() takes a PartitionProblem, got {type(problem)}")
    name = resolve_refiner(method)
    if isinstance(result, PartitionResult):
        base = result
        labels_in = np.asarray(base.labels)
    else:
        base = None
        labels_in = np.asarray(result)
    labels_out, info = _REFINERS[name](problem, labels_in, device=device,
                                       devices=devices, eps=eps, **opts)
    cut_before = edge_cut(labels_in, problem.indptr, problem.indices)
    cut_after = edge_cut(labels_out, problem.indptr, problem.indices)
    stats = dict(base.stats) if base is not None else {}
    stats["refine"] = {
        "method": name, "rounds": info["rounds"], "moves": info["moves"],
        "converged": info["converged"], "cut_before": cut_before,
        "cut_after": cut_after,
        "devices": None if devices is None else _devices_stat(devices),
        "eps": problem.epsilon if eps is None else float(eps)}
    stats["final_imbalance"] = imbalance(labels_out, problem.k,
                                         problem.weights)
    base_method = base.method if base is not None else "labels"
    out = PartitionResult(
        labels=labels_out, k=problem.k,
        method=f"{base_method}+{_SHORT[name]}", problem=problem,
        centers=None if base is None else base.centers,
        influence=None if base is None else base.influence,
        stats=stats)
    if evaluate:
        out.evaluate()
    return out
