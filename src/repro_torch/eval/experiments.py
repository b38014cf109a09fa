"""The paper's §5 comparison matrix (counterpart of
``repro/eval/experiments.py``).

The paper's headline claims are comparative: Geographer beats geometric
Zoltan partitioners on cut and communication volume across a zoo of
meshes. This module runs that method-vs-method matrix end to end: every
registered partitioning method × the mesh zoo, each cell evaluated with
the sharded metrics (``eval.sharded``, equal to the host metrics) and
refined with the sharded label-propagation rounds (equal to the
single-device rounds)::

    from repro_torch.eval.experiments import run_matrix

    out = run_matrix(n=1 << 17, k=256, eval_devices=4)   # one launch
    out["summary"]["geo_over_tool"]["rcb"]["totalCommVol"]

Ranks. The reference is one controller over its devices. Here the ranks
are processes, and every ``evaluate_sharded`` or ``refine(devices=)``
called from outside a rank launches its own. ``run_matrix`` called from
outside a rank therefore launches its ranks once and runs the whole
matrix on every rank: each rank builds the meshes and their
``ShardedGraph`` itself (deterministic host numpy), and rank 0's result
comes home. Inside the ranks, ``run_cell`` solves each cell on rank 0
only, single-device as the reference does, and the labels reach the other
ranks in one sum all-reduce (the others add zeros): one solve instead of
P solves contending for one card, rank 0's ``time_partition_s`` is the
solve's own time, and the ranks cannot diverge. The timing fields are
rank 0's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import meshes as MESH
from repro_torch.device import resolve_device
from repro_torch.dist import launch
from repro_torch.dist.rules import comm_for
from repro_torch.partition import (PartitionProblem, PartitionResult,
                                   available_methods, factor_k, partition,
                                   refine, refiner_short_name)

from .sharded import ShardedGraph, evaluate_sharded

# The §5 zoo: FEM grid, adaptively-refined 2D + larger 3D, anisotropic
# stretched grid, power-law-weighted rgg, 2.5D weighted climate mesh.
# Values are per-family point-count multipliers (the 3D refined family
# runs larger, as in the paper's hugetric-vs-delaunay3d size split).
EXPERIMENT_FAMILIES: dict[str, float] = {
    "tri": 1.0,
    "refined2d": 1.0,
    "refined3d": 2.0,
    "aniso": 1.0,
    "rggpow": 1.0,
    "climate25d": 1.0,
}

#: metrics gated / summarized per cell (lower is better for all three)
CELL_METRICS = ("cut", "maxCommVol", "totalCommVol")


def experiment_methods() -> list[str]:
    """Every registered flat method plus the hierarchical k1xk2 mode."""
    return available_methods() + ["hierarchical"]


def _default_eval_devices(device=None) -> int:
    """The rank count ``run_matrix`` evaluates over when given none: up to
    4 cards on the card (the reference's ``min(4, len(jax.devices()))``),
    1 on the CPU."""
    if resolve_device(device).type == "cuda":
        return min(4, torch.cuda.device_count())
    return 1


def _geomean(xs) -> float:
    xs = np.asarray([x for x in xs if x > 0], dtype=np.float64)
    if xs.size == 0:
        return 0.0
    return float(np.exp(np.mean(np.log(xs))))


def _solve(problem: PartitionProblem, method: str, comm, device):
    """The cell's single-device solve. On a rank (``comm`` not None),
    rank 0 solves and its labels reach every rank in one int32 sum
    all-reduce; the other ranks get a result holding those labels only."""
    if comm is None or comm.rank == 0:
        if method == "hierarchical":
            res = partition(problem, hierarchy=factor_k(problem.k),
                            device=device)
        else:
            res = partition(problem, method=method, device=device)
    else:
        res = None
    if comm is None or comm.size == 1:
        return res
    dev = launch.rank_device(resolve_device(device), comm.rank)
    mine = (torch.zeros(problem.n, dtype=torch.int32, device=dev)
            if res is None else torch.from_numpy(
                np.asarray(res.labels, np.int32)).to(dev))
    labels = comm.all_reduce(mine).cpu().numpy().astype(np.int64)
    if res is None:
        res = PartitionResult(labels=labels, k=problem.k, method=method,
                              problem=problem)
    return res


def run_cell(problem: PartitionProblem, method: str, eval_devices: int,
             graph: ShardedGraph | None = None,
             refiner: str | None = None, *, device=None) -> list[dict]:
    """One (mesh, method) cell: partition + sharded evaluation, plus —
    when ``refiner`` is set — the refined sibling row over the same
    solve (the post-pass runs sharded over ``eval_devices``, reusing the
    evaluation graph's layout; bit for bit the single-device rounds).

    Args:
        problem: the instance to cut (must carry a CSR graph).
        method: a registry name, or ``"hierarchical"`` for the k1xk2 mode.
        eval_devices: rank count for the metric evaluation (and the
            refinement pass). Called on a rank, the group must have that
            many ranks; called from outside, each sharded step launches
            its own ranks.
        graph: optional pre-built ``ShardedGraph`` (reuse across the
            methods sharing one mesh).
        refiner: refinement registry name (e.g. ``"label_prop"``), or
            None for the base row only.
        device: where the solve, the evaluation and the rounds run; None
            means ``cuda``.

    Returns:
        Row dicts: the base row, then (if ``refiner``) the refined row —
        ``tool`` suffixed (``"sfc+lp"``), ``refined=True``,
        ``base_tool`` naming the sibling.
    """
    comm = comm_for(eval_devices)
    t0 = time.perf_counter()
    res = _solve(problem, method, comm, device)
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = evaluate_sharded(problem, res.labels, eval_devices, graph=graph,
                          device=device)
    t_eval = time.perf_counter() - t0
    row = dict(ev)
    row.update(tool=method, graph=problem.name, n=problem.n, k=problem.k,
               balanced=bool(ev["imbalance"] <= problem.epsilon + 1e-6),
               refined=False, base_tool=method, time_refine_s=0.0,
               time_partition_s=t_part, time_eval_s=t_eval)
    rows = [row]
    if refiner is not None:
        t0 = time.perf_counter()
        ref = refine(problem, res, refiner, device=device,
                     devices=eval_devices, graph=graph)
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        ev_r = evaluate_sharded(problem, ref.labels, eval_devices,
                                graph=graph, device=device)
        t_eval_r = time.perf_counter() - t0
        rrow = dict(ev_r)
        st = ref.stats["refine"]
        rrow.update(tool=f"{method}+{refiner_short_name(refiner)}",
                    graph=problem.name, n=problem.n, k=problem.k,
                    balanced=bool(
                        ev_r["imbalance"] <= problem.epsilon + 1e-6),
                    refined=True, base_tool=method,
                    refine_rounds=st["rounds"], refine_moves=st["moves"],
                    refine_converged=st["converged"],
                    time_refine_s=t_ref, time_partition_s=t_part,
                    time_eval_s=t_eval_r)
        rows.append(rrow)
    return rows


def run_matrix(n: int, k: int, families=None, methods=None,
               eval_devices: int | None = None, seed: int = 0,
               epsilon: float = 0.03, quick: bool = False,
               refiner: str | None = "label_prop", *,
               device=None) -> dict:
    """The full method × mesh-zoo comparison matrix (each cell with its
    label-propagation-refined sibling row).

    Args:
        n: base point count (scaled per family by ``EXPERIMENT_FAMILIES``).
        k: block count.
        families: mesh-family subset (default: the whole zoo).
        methods: method subset (default: every registered method +
            hierarchical).
        eval_devices: rank count for the metric evaluation and the
            refinement; None picks ``_default_eval_devices(device)``.
            Called from outside a rank, the matrix runs on that many
            ranks launched once.
        seed: mesh + permutation seed.
        epsilon: balance slack for every cell.
        quick: recorded in the output (CI commensurability check).
        refiner: refinement pass for the sibling rows (None skips them —
            rows then halve, and the refined summaries are empty).
        device: where every cell runs; None means ``cuda``.

    Returns:
        dict with ``rows`` (two per cell: base + refined), ``summary``
        (``geo_over_tool`` per-tool geomean ratios of geographer's
        metrics over the tool's — < 1 means geographer wins —
        ``geo_refined_over_tool`` with refined geographer in the
        numerator, and ``refined_over_unrefined`` per-tool refinement
        gains) and the config echo, the reference's schema.
    """
    if eval_devices is None:
        eval_devices = _default_eval_devices(device)
    resolve_device(device)
    if launch.needed(eval_devices):
        return launch.run(run_matrix, eval_devices, device, n, k, families,
                          methods, eval_devices, seed, epsilon, quick,
                          refiner, device=device)
    families = dict(EXPERIMENT_FAMILIES) if families is None else {
        f: EXPERIMENT_FAMILIES.get(f, 1.0) for f in families}
    methods = experiment_methods() if methods is None else list(methods)

    rows = []
    for fam, scale in families.items():
        mesh = MESH.REGISTRY[fam](int(n * scale), seed=seed)
        problem = PartitionProblem.from_mesh(mesh, k, epsilon=epsilon,
                                             seed=seed)
        graph = ShardedGraph.from_problem(problem, eval_devices)
        for method in methods:
            for row in run_cell(problem, method, eval_devices,
                                graph=graph, refiner=refiner,
                                device=device):
                row["family"] = fam
                rows.append(row)

    # paper-trend summary: geographer's metric / tool's metric, geomean
    # over the zoo (< 1.0 = geographer better, the §5 claim for comm
    # volume vs the Zoltan-style geometric baselines)
    by_cell = {(r["family"], r["tool"]): r for r in rows}
    suffix = "" if refiner is None else f"+{refiner_short_name(refiner)}"

    def _tool_ratios(num_tool: str, den_tool: str) -> dict:
        ratios = {}
        for met in CELL_METRICS:
            rs = []
            for fam in families:
                num = by_cell.get((fam, num_tool))
                den = by_cell.get((fam, den_tool))
                if num and den and den[met] > 0:
                    rs.append(num[met] / den[met])
            ratios[met] = _geomean(rs)
        return ratios

    summary: dict[str, dict] = {"geo_over_tool": {},
                                "geo_refined_over_tool": {},
                                "refined_over_unrefined": {}}
    for tool in methods:
        if tool != "geographer":
            summary["geo_over_tool"][tool] = _tool_ratios("geographer",
                                                          tool)
            if refiner is not None:
                # refined geographer vs the *unrefined* baselines
                summary["geo_refined_over_tool"][tool] = _tool_ratios(
                    f"geographer{suffix}", tool)
        if refiner is not None:
            summary["refined_over_unrefined"][tool] = _tool_ratios(
                f"{tool}{suffix}", tool)
    summary["all_balanced"] = bool(all(r["balanced"] for r in rows))
    # baseline tools may bust epsilon on stress families (e.g.
    # quantile-cut sfc on power-law weights); geographer must not —
    # refined or not
    summary["geographer_all_balanced"] = bool(all(
        r["balanced"] for r in rows if r["base_tool"] == "geographer"))
    # refinement must never worsen balance: every refined row stays
    # within max(its sibling's imbalance, epsilon)
    summary["refined_imbalance_ok"] = bool(all(
        r["imbalance"] <= max(
            by_cell[(r["family"], r["base_tool"])]["imbalance"],
            epsilon) + 1e-9
        for r in rows if r["refined"]))

    return {"schema": 2, "quick": bool(quick), "n": n, "k": k,
            "epsilon": epsilon, "seed": seed,
            "eval_devices": int(eval_devices),
            "refiner": refiner,
            "families": sorted(families), "methods": sorted(methods),
            "rows": rows, "summary": summary}
