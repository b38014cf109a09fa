"""Sharded quality metrics (counterpart of ``repro/eval/sharded.py``).

``core.metrics`` evaluates a partition with host numpy over the whole
CSR graph. This module computes the same three graph metrics (edge cut,
communication volume, boundary nodes) over the ranks of a mesh, from a
``ShardedGraph``: the CSR companion of ``ShardedPartitionProblem``.

Layout. ``ShardedGraph`` deals the CSR rows onto the same seed-permuted
round-robin layout the solver uses: the directed edges of the point at
(shard p, slot s) become ``(src=s, dst=global neighbour id)`` entries of
shard p's edge list, padded to a common per-shard cap ``ecap``. Padded
slots and padded edges are masked.

Communication: four all-reduces a metric pass. The labels a shard needs
from its neighbours come from one global vector sum (each rank writes
its labels into an [n] zero vector at its own positions; the sum is the
whole label vector): no all-gather, no halo exchange. The cut and the
per-block volume and boundary counts are sums of per-rank partials.

Exactness. All three metrics are integer counts and integer additions
commute, so the sharded metrics equal the host metrics exactly at every
rank count.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import launch
from repro_torch.dist.rules import comm_for
from repro_torch.partition.distributed import ShardedPartitionProblem
from repro_torch.partition.problem import PartitionProblem


@dataclass(frozen=True)
class ShardedGraph:
    """CSR adjacency dealt onto a ``ShardedPartitionProblem`` layout.

    Attributes:
        sharded: the point-layout companion (owns gather/valid and the
            source ``PartitionProblem``, which must carry a CSR graph).
        src: [P, ecap] int32 — local slot of each directed edge's source
            (a valid slot of that shard).
        dst: [P, ecap] int64 — global point id of the edge's target.
        edge_valid: [P, ecap] bool — False for padding entries.
    """
    sharded: ShardedPartitionProblem
    src: np.ndarray
    dst: np.ndarray
    edge_valid: np.ndarray

    @property
    def problem(self) -> PartitionProblem:
        return self.sharded.problem

    @property
    def devices(self) -> int:
        return self.sharded.devices

    @property
    def ecap(self) -> int:
        """Per-shard edge-slot count (max directed edges over shards)."""
        return self.src.shape[1]

    @classmethod
    def from_sharded(cls, sharded: ShardedPartitionProblem,
                     edge_cap: int | None = None) -> "ShardedGraph":
        """Deal the problem's CSR rows onto ``sharded``'s point layout.

        Args:
            sharded: a sharded view whose problem carries a CSR graph.
            edge_cap: per-shard edge-slot count ``ecap``; None sizes it to
                the largest per-shard directed-edge count. A smaller
                explicit cap is an error: it would drop edges.

        Returns:
            The static-shape sharded graph.

        Raises:
            ValueError: the problem has no CSR adjacency, or ``edge_cap``
                is smaller than some shard's edge count.
        """
        prob = sharded.problem
        if not prob.has_graph:
            raise ValueError(
                "problem carries no CSR graph (indptr/indices); sharded "
                "graph metrics need one — build the PartitionProblem via "
                "from_mesh or pass indptr/indices")
        indptr = np.asarray(prob.indptr, np.int64)
        indices = np.asarray(prob.indices, np.int64)
        deg = np.diff(indptr)
        P = sharded.devices
        srcs, dsts, counts = [], [], []
        for p in range(P):
            slots = np.nonzero(sharded.valid[p])[0]
            g = sharded.gather[p][slots]
            dg = deg[g]
            tot = int(dg.sum())
            counts.append(tot)
            row = np.repeat(np.arange(len(g)), dg)
            # offset within the row: position minus the row's start
            within = np.arange(tot) - np.repeat(
                np.concatenate([[0], np.cumsum(dg)[:-1]]), dg)
            dsts.append(indices[indptr[g][row] + within])
            srcs.append(slots[row].astype(np.int32))
        need = max(max(counts), 1)
        if edge_cap is None:
            ecap = need
        else:
            ecap = int(edge_cap)
            if ecap < need:
                raise ValueError(
                    f"edge_cap={ecap} is smaller than the largest "
                    f"per-shard directed-edge count {need}; a short edge "
                    "slab would silently truncate edges — pass "
                    f"edge_cap >= {need} (or None to size automatically)")
        src = np.zeros((P, ecap), np.int32)
        dst = np.zeros((P, ecap), np.int64)
        valid = np.zeros((P, ecap), bool)
        for p in range(P):
            src[p, :counts[p]] = srcs[p]
            dst[p, :counts[p]] = dsts[p]
            valid[p, :counts[p]] = True
        return cls(sharded=sharded, src=src, dst=dst, edge_valid=valid)

    @classmethod
    def from_problem(cls, problem: PartitionProblem, devices: int,
                     edge_cap: int | None = None) -> "ShardedGraph":
        """Shard ``problem``'s points and graph over ``devices`` shards."""
        return cls.from_sharded(
            ShardedPartitionProblem.from_problem(problem, devices),
            edge_cap=edge_cap)


def _metrics_on_rank(graph: ShardedGraph, labels: np.ndarray, device):
    """One rank's metric pass over its shard: (cut, comm_per_block [k],
    boundary_per_block [k]), the same on every rank. Four all-reduces:
    the label vector, the cut, the volumes, the boundary counts."""
    comm = comm_for(graph.devices)
    dev = launch.rank_device(resolve_device(device), comm.rank)
    sp = graph.sharded
    p, n, k = comm.shard_id, sp.problem.n, sp.problem.k

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    gidx, lvalid = on(sp.gather[p]), on(sp.valid[p])
    mine_labels = on(np.asarray(labels)[sp.gather[p]].astype(np.int64))
    src, dst = on(graph.src[p]).long(), on(graph.dst[p])
    evalid = on(graph.edge_valid[p])
    # the whole label vector as one global sum: every position is owned
    # by exactly one (rank, valid slot), every other rank adds 0
    partial = torch.zeros(n, dtype=torch.int64, device=dev)
    partial[gidx[lvalid]] = mine_labels[lvalid]
    glabels = comm.all_reduce(partial)
    nb = glabels[dst]
    is_cut = evalid & (nb != mine_labels[src])
    cut2 = comm.all_reduce(torch.sum(is_cut.to(torch.int64)))
    # distinct (local slot, remote block) pairs: the unique keys of the
    # cut edges, counted per slot
    keys = torch.unique(src[is_cut] * k + nb[is_cut])
    per_node = torch.bincount(keys // k, minlength=sp.cap)
    zeros = torch.zeros(k, dtype=torch.int64, device=dev)
    vol = comm.all_reduce(zeros.index_add(
        0, mine_labels, torch.where(lvalid, per_node, 0)))
    bnd = comm.all_reduce(zeros.index_add(
        0, mine_labels, (lvalid & (per_node > 0)).to(torch.int64)))
    return (int(cut2) // 2, vol.cpu().numpy().astype(np.int64),
            bnd.cpu().numpy().astype(np.int64))


def _run_metrics(graph: ShardedGraph, labels: np.ndarray, device=None):
    """(cut, comm_per_block, boundary_per_block) of ``labels``; on the
    calling rank, or on ranks launched for it. The last (labels, result)
    pair is kept on the graph, so the three metric functions called back
    to back on one labeling cost one pass."""
    sp = graph.sharded
    labels = np.asarray(labels)
    if labels.shape != (sp.problem.n,):
        raise ValueError(f"labels must be [{sp.problem.n}], "
                         f"got {labels.shape}")
    key = labels.astype(np.int32, copy=False).tobytes()
    cached = getattr(graph, "_memo", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    if launch.needed(graph.devices):
        result = launch.run(_metrics_on_rank, graph.devices, device, graph,
                            labels, device)
    else:
        result = _metrics_on_rank(graph, labels, device)
    object.__setattr__(graph, "_memo", (key, result))   # frozen dataclass
    return result


def edge_cut_sharded(graph: ShardedGraph, labels: np.ndarray, *,
                     device=None) -> int:
    """Sharded edge cut — equals ``metrics.edge_cut`` exactly.

    Args:
        graph: the sharded CSR view.
        labels: [n] block ids in original point order.
        device: the ranks' device (None: ``cuda``).

    Returns:
        Number of undirected edges with endpoints in different blocks.
    """
    return _run_metrics(graph, labels, device)[0]


def comm_volume_sharded(graph: ShardedGraph, labels: np.ndarray, *,
                        device=None) -> tuple[int, int, np.ndarray]:
    """Sharded communication volume — equals ``metrics.comm_volume``
    exactly: (max_comm, total_comm, per_block_comm [k])."""
    _, vol, _ = _run_metrics(graph, labels, device)
    return int(vol.max(initial=0)), int(vol.sum()), vol


def boundary_nodes_sharded(graph: ShardedGraph, labels: np.ndarray, *,
                           device=None) -> tuple[int, np.ndarray]:
    """Sharded boundary-node count — equals ``metrics.boundary_nodes``
    exactly: (total, per_block [k])."""
    _, _, bnd = _run_metrics(graph, labels, device)
    return int(bnd.sum()), bnd


def evaluate_sharded(problem: PartitionProblem, labels: np.ndarray,
                     devices: int, graph: ShardedGraph | None = None, *,
                     device=None) -> dict:
    """The paper's §2 metric set with the graph metrics computed over
    ``devices`` ranks: the keys and values of ``metrics.evaluate_problem``
    for a problem with a CSR graph (the balance metrics stay host numpy).

    Args:
        problem: the instance (must carry indptr/indices).
        labels: [n] block ids in original point order.
        devices: rank count P (1 <= P <= n).
        graph: a ``ShardedGraph`` built for ``problem`` and ``devices``,
            to reuse across calls; None builds it (on every rank).
        device: the ranks' device; None means ``cuda``.

    Returns:
        dict with ``imbalance`` / ``n_blocks_used`` / ``cut`` /
        ``maxCommVol`` / ``totalCommVol`` / ``boundaryNodes``.

    Raises:
        ValueError: ``graph`` was built for another problem or devices.
    """
    from repro_torch.core import metrics
    if graph is not None and (graph.problem is not problem
                              or graph.devices != devices):
        raise ValueError("graph was built for a different problem/devices")
    resolve_device(device)
    if launch.needed(devices):
        return launch.run(evaluate_sharded, devices, device, problem,
                          labels, devices, graph, device=device)
    if graph is None:
        graph = ShardedGraph.from_problem(problem, devices)
    labels = np.asarray(labels)
    cut, vol, bnd = _run_metrics(graph, labels, device)
    return {
        "imbalance": metrics.imbalance(labels, problem.k, problem.weights),
        "n_blocks_used": int(len(np.unique(labels))),
        "cut": cut,
        "maxCommVol": int(vol.max(initial=0)),
        "totalCommVol": int(vol.sum()),
        "boundaryNodes": int(bnd.sum()),
    }
