"""The port's §5 experiment harness (``repro_torch.eval.experiments``)
against the reference's, on the CPU.

Contracts:
- the host-numpy baselines (sfc, rcb, rib, multijagged): every row equal
  to the reference's, timing keys excepted, the refined sibling too;
- geographer and hierarchical: the contract of
  ``tests/test_torch_partition.py`` (at least ``AGREE`` of the labels
  equal, cut and totalCommVol within ``METRIC_RTOL``); their refined rows
  equal the port's single-device refinement of the port's own labels;
- the matrix: the reference's schema (``validate_schema``, a copy of
  ``tests/test_experiments_harness.py``'s), a baseline-only matrix equal
  to the reference's rows and summary, rows deterministic for a seed.

The ranks are threads over gloo (``dist.launch.launch(..., threads=True)``);
the reference's sharded calls run with its ``DeprecationWarning`` of the
``shard_map`` import silenced (``reference_calls``; ROADMAP.md, queue 3
item 3).
"""

import numpy as np
import pytest
import torch
from reference_calls import reference as _reference

from repro.core import meshes as ref_meshes
from repro.eval import experiments as ref_x
from repro.partition import PartitionProblem as RefProblem
from repro.partition import factor_k as ref_factor_k
from repro.partition import partition as ref_partition
from repro_torch.core import metrics
from repro_torch.dist import launch, rules
from repro_torch.eval import experiments as x
from repro_torch.partition import (PartitionProblem, factor_k, partition,
                                   refine)

torch.set_num_threads(1)

CPU = "cpu"
DEADLINE = 300.0
AGREE = 0.99
METRIC_RTOL = 0.02
TIMING = ("time_partition_s", "time_refine_s", "time_eval_s")
BASELINES = ["multijagged", "rcb", "rib", "sfc"]

ROW_INT_METRICS = ("cut", "maxCommVol", "totalCommVol", "boundaryNodes",
                   "n_blocks_used")
ROW_KEYS = set(ROW_INT_METRICS) | {
    "family", "graph", "tool", "n", "k", "imbalance", "balanced",
    "refined", "base_tool", "time_partition_s", "time_refine_s",
    "time_eval_s"}


def validate_schema(out: dict) -> None:
    """The ``BENCH_experiments.json`` contract (the reference's test)."""
    for key in ("schema", "quick", "n", "k", "epsilon", "seed",
                "eval_devices", "refiner", "families", "methods", "rows",
                "summary"):
        assert key in out, f"missing top-level key {key!r}"
    assert out["schema"] == 2
    families, methods = out["families"], out["methods"]
    per_cell = 2 if out["refiner"] else 1
    assert len(out["rows"]) == len(families) * len(methods) * per_cell
    seen = set()
    for r in out["rows"]:
        assert ROW_KEYS <= set(r), ROW_KEYS - set(r)
        assert r["family"] in families and r["base_tool"] in methods
        seen.add((r["family"], r["tool"]))
        for met in ROW_INT_METRICS:
            assert int(r[met]) >= 0
        assert r["totalCommVol"] >= r["maxCommVol"]
        assert r["imbalance"] >= 0.0
        if r["refined"]:
            assert r["tool"] != r["base_tool"]
            assert r["tool"].startswith(r["base_tool"] + "+")
            assert {"refine_rounds", "refine_moves",
                    "refine_converged"} <= set(r)
        else:
            assert r["tool"] == r["base_tool"]
    assert len(seen) == len(out["rows"]), "duplicate (family, tool) cell"
    trend = out["summary"]["geo_over_tool"]
    assert set(trend) == set(methods) - {"geographer"}
    for ratios in trend.values():
        assert {"cut", "maxCommVol", "totalCommVol"} <= set(ratios)
        assert all(v > 0 for v in ratios.values())
    if out["refiner"]:
        assert set(out["summary"]["geo_refined_over_tool"]) == \
            set(methods) - {"geographer"}
        assert set(out["summary"]["refined_over_unrefined"]) == \
            set(methods)
        assert isinstance(out["summary"]["refined_imbalance_ok"], bool)
    assert isinstance(out["summary"]["geographer_all_balanced"], bool)


def _ranks(fn, nranks, *args, **kwargs):
    return launch.launch(fn, nranks, args=args, kwargs=kwargs, device=CPU,
                         threads=True, timeout=DEADLINE)


def _untimed(rows):
    return [{key: v for key, v in r.items() if key not in TIMING}
            for r in rows]


def _problems(family, n, k, seed):
    mesh = ref_meshes.REGISTRY[family](n, seed=seed)
    return (PartitionProblem.from_mesh(mesh, k, seed=seed),
            RefProblem.from_mesh(mesh, k, seed=seed))


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", x.experiment_methods())
@pytest.mark.parametrize("family", ["delaunay2d", "climate25d"])
def test_run_cell_equals_reference(family, method):
    prob, rp = _problems(family, 700, 6, seed=2)
    got = _ranks(x.run_cell, 2, prob, method, 2, refiner="label_prop",
                 device=CPU)
    want = _reference(ref_x.run_cell, rp, method, 2, refiner="label_prop")
    assert [r["tool"] for r in got] == [r["tool"] for r in want]
    if method in BASELINES:
        assert _untimed(got) == _untimed(want)
        return
    hier = method == "hierarchical"
    assert factor_k(prob.k) == ref_factor_k(rp.k)
    opts = {"hierarchy": factor_k(prob.k)} if hier else {"method": method}
    base = partition(prob, device=CPU, **opts)
    ref_base = ref_partition(rp, **opts)
    assert np.mean(base.labels == ref_base.labels) >= AGREE
    for key in ("cut", "totalCommVol"):
        assert got[0][key] == pytest.approx(want[0][key], rel=METRIC_RTOL)
    # the rows are the metrics of the port's own labels
    assert {key: got[0][key] for key in metrics.evaluate_problem(
        prob, base.labels)} == metrics.evaluate_problem(prob, base.labels)
    refined = refine(prob, base, device=CPU)
    st = refined.stats["refine"]
    assert {key: got[1][key] for key in metrics.evaluate_problem(
        prob, refined.labels)} == metrics.evaluate_problem(
            prob, refined.labels)
    assert (got[1]["refine_rounds"], got[1]["refine_moves"],
            got[1]["refine_converged"]) == (st["rounds"], st["moves"],
                                            st["converged"])


def test_run_cell_from_outside_a_rank(monkeypatch):
    """Called from outside a rank, the cell solves here and every sharded
    step launches its own ranks (the reference's single-controller call):
    the same rows as the cell run inside the ranks."""
    calls = []

    def run(fn, devices, device, /, *args, **kwargs):
        calls.append(fn.__name__)
        return launch.launch(fn, rules.mesh_size(devices), args=args,
                             kwargs=kwargs, device=device, threads=True,
                             timeout=DEADLINE)

    prob, _ = _problems("tri", 400, 4, seed=0)
    inside = _ranks(x.run_cell, 2, prob, "rcb", 2, refiner="lp", device=CPU)
    monkeypatch.setattr(launch, "run", run)
    outside = x.run_cell(prob, "rcb", 2, refiner="lp", device=CPU)
    assert _untimed(outside) == _untimed(inside)
    assert calls == ["evaluate_sharded", "label_prop_refine",
                     "evaluate_sharded"]


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------

def test_full_matrix_toy_sizes():
    """The reference test's toy matrix: every method × every family, the
    reference's schema, and the same rows and summary as the
    reference's."""
    got = _ranks(x.run_matrix, 2, n=400, k=4, eval_devices=2, device=CPU)
    validate_schema(got)
    assert set(got["families"]) == set(x.EXPERIMENT_FAMILIES)
    assert set(got["methods"]) == set(x.experiment_methods())
    assert x.experiment_methods() == ref_x.experiment_methods()
    assert x.EXPERIMENT_FAMILIES == ref_x.EXPERIMENT_FAMILIES
    assert x.CELL_METRICS == ref_x.CELL_METRICS
    want = _reference(ref_x.run_matrix, n=400, k=4, eval_devices=2, seed=0)
    validate_schema(want)
    rows = {(r["family"], r["tool"]): r for r in _untimed(want["rows"])}
    for r in _untimed(got["rows"]):
        if r["base_tool"] in BASELINES:
            assert r == rows[(r["family"], r["tool"])]
    assert {key: v for key, v in got.items() if key not in ("rows",)} \
        .keys() == {key: v for key, v in want.items()
                    if key not in ("rows",)}.keys()


def test_baseline_matrix_equals_reference():
    """A matrix of the host-numpy baselines: rows (timing excepted) and
    summary equal to the reference's."""
    kw = dict(n=600, k=6, methods=BASELINES, eval_devices=2, seed=3)
    got = _ranks(x.run_matrix, 2, device=CPU, **kw)
    want = _reference(ref_x.run_matrix, **kw)
    assert _untimed(got["rows"]) == _untimed(want["rows"])
    assert got["summary"] == want["summary"]
    assert {key: v for key, v in got.items() if key != "rows"} == \
        {key: v for key, v in want.items() if key != "rows"}


def test_rows_are_deterministic_for_a_seed():
    kw = dict(n=500, k=4, families=["tri", "aniso"],
              methods=["geographer", "sfc", "hierarchical"], eval_devices=2,
              seed=5, device=CPU)
    a = _ranks(x.run_matrix, 2, **kw)
    b = _ranks(x.run_matrix, 2, **kw)
    assert _untimed(a["rows"]) == _untimed(b["rows"])
    assert a["summary"] == b["summary"]
    c = _ranks(x.run_matrix, 2, **dict(kw, seed=6))
    assert _untimed(c["rows"]) != _untimed(a["rows"])


def test_eval_devices_default(monkeypatch):
    """None picks 1 on the CPU and ``min(4, cards)`` on the card (the
    reference's ``min(4, len(jax.devices()))``)."""
    assert x._default_eval_devices(CPU) == 1
    out = _ranks(x.run_matrix, 1, n=300, k=4, families=["tri"],
                 methods=["geographer", "sfc"], device=CPU)
    assert out["eval_devices"] == 1
    validate_schema(out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for cards, want in ((1, 1), (2, 2), (8, 4)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert x._default_eval_devices() == want
        assert x._default_eval_devices("cuda") == want


def test_run_matrix_launches_once(monkeypatch):
    """From outside a rank the whole matrix runs in one launch; inside the
    ranks no call launches again."""
    calls = []

    def run(fn, devices, device, /, *args, **kwargs):
        calls.append(fn.__name__)
        return launch.launch(fn, rules.mesh_size(devices), args=args,
                             kwargs=kwargs, device=device, threads=True,
                             timeout=DEADLINE)

    monkeypatch.setattr(launch, "run", run)
    kw = dict(n=400, k=4, families=["tri", "climate25d"],
              methods=["geographer", "rib"], eval_devices=2, device=CPU)
    got = x.run_matrix(**kw)
    assert calls == ["run_matrix"]
    monkeypatch.undo()
    assert _untimed(got["rows"]) == _untimed(
        _ranks(x.run_matrix, 2, **kw)["rows"])


def test_ranks_hold_the_same_labels():
    """Inside the ranks only rank 0 solves; every rank then holds its
    labels, so every rank returns the same rows."""
    prob, _ = _problems("rggpow", 500, 5, seed=1)

    def every_rank():
        from repro_torch.dist import current
        rows = x.run_cell(prob, "geographer", 3, refiner="lp", device=CPU)
        comm = current()
        out = torch.tensor([r[key] for r in rows for key in ROW_INT_METRICS],
                           dtype=torch.int64)
        lo, hi = comm.all_reduce(out, "min"), comm.all_reduce(out, "max")
        return bool(torch.equal(lo, hi)), rows

    same, rows = _ranks(every_rank, 3)
    assert same
    assert rows[0]["balanced"] and rows[1]["refined"]
