"""``"kind": "closed_loop"``: one caller in a closed loop, as a simulation
code calls the partitioner before a run. Each call gets a new input from
``Inputs.problem_arrays`` (made outside the timed call) and runs
``partition(problem, method, refine=...)``.

Parameters: ``"refine"`` (true: ``partition(refine=True)`` on the
configuration's graph). The check assigns every point again under the
returned centers and influence (``assign_gap``), holds the centers
against the weighted means of their blocks (``center_gap``) and the
labels against epsilon (``imbalance``); with ``refine``, whose solve
labels are not returned, it refines the reference's own assignment with
its own label propagation and compares labels (``label_diff``) and cuts
(``cut_gap``).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.driver import solver_stats
from portbench.reference import assign as ref_assign
from portbench.reference import label_prop as ref_lp

KEYS = ("refine",)


def setup(cell) -> None:
    if cell.traffic.get("refine") and cell.config["weights"]["kind"] != "unit":
        raise ValueError("the reference's label propagation is written "
                         "for unit node weights")
    if not cell.warm:
        for w in range(cell.traffic.get("warmup", 1)):
            unit(cell, -1 - w)


def faults(traffic: dict) -> list:
    """The faults of ``faults.FAULTS`` that a cell of this mix can have."""
    names = ["altered", "half", "frozen"]
    return names + ["unchanged"] if traffic.get("refine") else names


def unit(cell, index: int):
    problem = cell.problem(**cell.inputs.problem_arrays(index))
    res, wall, sweeps = cell.partition(problem,
                                       bool(cell.traffic.get("refine")))
    rec = {"index": index, "wall": wall, "sweeps": sweeps}
    rec.update(solver_stats(res.stats))
    if "refine" in res.stats:
        rec["refine_rounds"] = int(res.stats["refine"]["rounds"])
    answer = {"index": index, "labels": np.asarray(res.labels),
              "centers": res.centers, "influence": res.influence}
    return [rec], answer


def check(cell, answer) -> list:
    pts64 = cell.inputs.points(answer["index"])
    w = cell.inputs.weights(pts64, answer["index"])
    pts = pts64.to(torch.float32)
    k = cell.config["k"]
    labels = answer["labels"]
    gap, ref = ref_assign.assignment(pts, answer["centers"],
                                     answer["influence"],
                                     None if cell.traffic.get("refine")
                                     else labels)
    row = {"center_gap": ref_assign.center_gap(pts, ref, answer["centers"],
                                               w),
           "imbalance": ref_assign.imbalance(
               labels, k, None if w is None else w.cpu().numpy())}
    if not cell.traffic.get("refine"):
        row["assign_gap"] = gap
        return [row]
    # the solve's labels are not returned with refine=True: the reference
    # refines its own assignment under the returned state
    indptr, indices = cell.inputs.graph()
    src, dst = ref_lp.edges(torch.as_tensor(indptr, device=cell.dev),
                            torch.as_tensor(indices, device=cell.dev))
    mine, _ = ref_lp.refine(ref, src, dst, k, cell.config["epsilon"])
    theirs = torch.as_tensor(labels, device=cell.dev)
    cut_ref = ref_lp.edge_cut(mine, src, dst)
    cut = ref_lp.edge_cut(theirs, src, dst)
    row["label_diff"] = float(torch.mean((mine != theirs).double()))
    row["cut_gap"] = abs(cut - cut_ref) / max(cut_ref, 1)
    return [row]
