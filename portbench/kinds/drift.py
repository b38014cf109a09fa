"""``"kind": "drift"``: a simulation's dynamic load balancing.

Set-up makes one mesh from the mix's ``"mesh_seed"`` (the same in every
run), the weights of steps 0..``"steps"`` (the configuration's weights
times the mix's ``"field"``, a module of ``weights/``), and the step-0
cold partition; the run's seed then deals the points to the caller in an
order of its own. A unit of the window is an episode of warm
``repartition(problem_t, previous)`` for t = 1..steps, starting again
from the saved step-0 result, so every run sees the same work.

The check follows a sampled episode step by step: every point assigned
again under each step's returned centers and influence (``assign_gap``),
the centers against the weighted means of their blocks (``center_gap``),
the balance (``imbalance``) and the migration against that of the
reference's own labels (``migration_gap``).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.inputs import Inputs, generator_module, stream_seed
from portbench.reference import assign as ref_assign

KEYS = ("mesh_seed", "steps", "field")


def setup(cell) -> None:
    tr = cell.traffic
    mesh = Inputs(cell.config, tr["mesh_seed"], cell.dev)
    pts = mesh.points(0)
    base = mesh.weights(pts, 0)
    fld = generator_module("weights", tr["field"], "drift field")
    w = []
    for t in range(tr["steps"] + 1):
        wt = fld.weights(tr["field"], pts, t, None)
        w.append(wt if base is None else wt * base)
    fixed = stream_seed(tr["mesh_seed"], 0) % 2**32
    res0, _, _ = cell.partition(cell.problem(
        points=pts.cpu().numpy(), weights=w[0].cpu().numpy(), seed=fixed))
    order = torch.randperm(pts.shape[0], device=cell.dev,
                           generator=cell.inputs.generator(0))
    cell.points = pts[order]
    points = cell.points.cpu().numpy()
    cell.step_problems = [cell.problem(points=points,
                                       weights=wt[order].cpu().numpy(),
                                       seed=fixed) for wt in w]
    order = order.cpu().numpy()
    cell.start = cell.Result(
        labels=res0.labels[order], k=res0.k, method=res0.method,
        problem=cell.step_problems[0], centers=res0.centers,
        influence=res0.influence, stats=res0.stats)
    if not cell.warm:
        for t in range(1, tr.get("warmup", 1) + 1):
            cell.repartition(cell.step_problems[t], cell.start)


def faults(traffic: dict) -> list:
    """The faults of ``faults.FAULTS`` that a cell of this mix can have."""
    return ["altered", "half", "frozen"]


def unit(cell, index: int):
    prev, recs, answers = cell.start, [], []
    for t in range(1, cell.traffic["steps"] + 1):
        res, wall, sweeps = cell.repartition(cell.step_problems[t], prev)
        recs.append({"step": t, "wall": wall, "sweeps": sweeps,
                     "iters": int(res.stats["iters"]),
                     "balance_retries": int(res.stats["balance_retries"])})
        answers.append({"step": t, "labels": np.asarray(res.labels),
                        "centers": res.centers, "influence": res.influence,
                        "migration": float(
                            res.stats["migration"]["fraction"])})
        prev = res
    return recs, answers


def check(cell, episode) -> list:
    pts = cell.points.to(torch.float32)
    k = cell.config["k"]
    _, ref_prev = ref_assign.assignment(pts, cell.start.centers,
                                        cell.start.influence)
    ref_prev = ref_prev.cpu().numpy()
    rows = []
    for a in episode:
        w = cell.step_problems[a["step"]].weights
        gap, ref = ref_assign.assignment(pts, a["centers"], a["influence"],
                                         a["labels"])
        center = ref_assign.center_gap(pts, ref, a["centers"], w)
        ref = ref.cpu().numpy()
        rows.append({"assign_gap": gap, "center_gap": center,
                     "imbalance": ref_assign.imbalance(a["labels"], k, w),
                     "migration_gap": abs(
                         a["migration"] - ref_assign.migration(ref_prev, ref,
                                                               w))})
        ref_prev = ref
    return rows
