"""The port's sharded label-propagation rounds against the reference's, on
the CPU.

Contract: exact equality, no tolerance. The rounds are integer arithmetic
and every decision is made from vectors assembled by integer sums, so the
port's sharded rounds (``refine(devices=P)``, ranks as threads over gloo,
``dist.launch.launch(..., threads=True)``) give the reference's
``refine(devices=P)`` bit for bit at P = 1, 2, 4 (labels and every
``stats["refine"]`` field), and the port's own single-device rounds
(``_lp_rounds``, ``_lp_rounds_plain``), the accepted gains included. A
``(P1, P2)`` mesh equals ``P1 * P2``; the reference raises there (a
deliberate departure, ROADMAP.md queue 3 item 14). The front doors
(``partition(devices=, refine=)``, ``repartition(devices=, refine=)``,
``PartitionResult.refine(devices=)``) refine exactly what the reference's
``refine(devices=)`` does to the same base labels.

The reference's sharded calls run with its ``DeprecationWarning`` of the
``shard_map`` import silenced (``reference_calls``; ROADMAP.md, queue 3
item 3).
"""
import importlib
import multiprocessing

import numpy as np
import pytest
import torch
from reference_calls import reference as _reference

from repro.core import meshes as ref_meshes
from repro.eval.sharded import ShardedGraph as RefGraph
from repro.partition import PartitionProblem as RefProblem
from repro.partition import partition as ref_partition
from repro.partition import refine as ref_refine
from repro_torch.core import meshes
from repro_torch.dist import launch
from repro_torch.dist.rules import comm_for, mesh_size
from repro_torch.eval import ShardedGraph
from repro_torch.partition import (PartitionProblem, partition, refine,
                                   repartition)

lp = importlib.import_module("repro_torch.partition.refine")
ref_lp = importlib.import_module("repro.partition.refine")

torch.set_num_threads(1)

CPU = "cpu"
DEADLINE = 120.0
FAMILIES = ["tri", "delaunay2d", "aniso", "rggpow", "climate25d"]


def _ranks(fn, mesh, *args, **kwargs):
    """``fn(*args, **kwargs)`` on the thread ranks of ``mesh`` (P or
    (P1, P2); gloo, CPU), rank 0's value, within ``DEADLINE`` seconds."""
    return launch.launch(fn, mesh_size(mesh), args=args, kwargs=kwargs,
                         device=CPU, threads=True, timeout=DEADLINE)


def _problems(family, n, k, seed, weighted=False, eps=0.03):
    """The same instance as a port and a reference problem; ``weighted``
    adds lognormal weights (seeded) where the family has none."""
    mesh = ref_meshes.REGISTRY[family](n, seed=seed)
    w = mesh.weights
    if weighted and w is None:
        w = np.random.default_rng(seed + 3).lognormal(0.0, 0.5, mesh.n)
    kw = dict(points=mesh.points, k=k, weights=w, epsilon=eps,
              indptr=mesh.indptr, indices=mesh.indices, seed=seed)
    return PartitionProblem(**kw), RefProblem(**kw)


def _labels(n, k, seed):
    return np.random.default_rng(seed + 1).integers(0, k, n).astype(np.int64)


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got.labels),
                                  np.asarray(want.labels))
    assert got.method == want.method
    assert got.stats["refine"] == want.stats["refine"]
    assert got.stats["final_imbalance"] == want.stats["final_imbalance"]


# ---------------------------------------------------------------------------
# the sharded rounds against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [1, 2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_rounds_equal_reference(family, devices):
    prob, rp = _problems(family, 500, 8, seed=devices)
    labels = _labels(prob.n, 8, seed=devices)
    got = _ranks(refine, devices, prob, labels, device=CPU,
                 devices=devices)
    want = _reference(ref_refine, rp, labels, devices=devices)
    _assert_same(got, want)
    assert got.stats["refine"]["devices"] == devices
    assert got.stats["refine"]["moves"] > 0


@pytest.mark.parametrize("eps", [0.0, 0.03, 0.1])
@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_options_equal_reference(weighted, ordered, eps):
    """Lognormal weights (float budgets with a margin), a permuted
    ``node_order`` and the balance slack, at P = 2 and 4."""
    devices = 2 if ordered else 4
    prob, rp = _problems("delaunay2d", 450, 6, seed=11, weighted=weighted,
                         eps=eps)
    labels = _labels(prob.n, 6, seed=5)
    order = (np.random.default_rng(4).permutation(prob.n) if ordered
             else None)
    got = _ranks(refine, devices, prob, labels, device=CPU,
                 devices=devices, node_order=order)
    want = _reference(ref_refine, rp, labels, devices=devices,
                      node_order=order)
    _assert_same(got, want)


def _rounds_on_rank(prob, devices, args):
    graph = ShardedGraph.from_problem(prob, mesh_size(devices))
    return lp._lp_rounds_sharded(graph, *args, comm_for(devices),
                                 device=CPU)


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_rounds_equal_single_device_rounds(family):
    """``_lp_rounds_sharded`` at P = 1, 2, 4 and (2, 2) against the
    single-device sparse rounds and the dense plain version: labels,
    rounds, moves, the last round's moves and the accepted gains."""
    prob, rp = _problems(family, 500, 7, seed=3, weighted=True)
    labels = _labels(prob.n, 7, seed=3)
    keys = np.random.default_rng(8).permutation(prob.n)
    iw, limit = lp.refinement_quantization(prob)
    lc, _ = lp._canonicalize(labels, keys, prob.k)
    args = (lc, iw, keys, prob.k, limit, lp.DEFAULT_MAX_ROUNDS)
    single_args = (lc, prob.indptr, prob.indices, iw, keys, prob.k, limit,
                   lp.DEFAULT_MAX_ROUNDS)
    want = lp._lp_rounds(*single_args, device=CPU)
    plain = lp._lp_rounds_plain(*single_args, device=CPU)
    np.testing.assert_array_equal(plain[0], want[0])
    assert plain[1:] == want[1:]
    for devices in (1, 2, 4, (2, 2)):
        got = _ranks(_rounds_on_rank, devices, prob, devices, args)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:], devices


def test_collectives_per_round():
    """Four all-reduces a round and nothing else: three [n] int32 vectors
    and the [k] block weights."""
    prob, _ = _problems("tri", 400, 5, seed=0)
    labels = _labels(prob.n, 5, seed=0)

    def body():
        from repro_torch.dist import current
        comm = current()
        before = comm.counters()
        _, info = lp.label_prop_refine(prob, labels, device=CPU, devices=2)
        after = comm.counters()
        return info["rounds"], {key: after[key] - before[key]
                                for key in ("all_reduces", "bytes")}

    rounds, got = _ranks(body, 2)
    assert got["all_reduces"] == 4 * rounds
    assert got["bytes"] == rounds * 4 * (3 * prob.n + prob.k)


# ---------------------------------------------------------------------------
# the front doors
# ---------------------------------------------------------------------------

def test_graph_reuse_and_its_mismatch_errors():
    prob, rp = _problems("tri", 400, 4, seed=2)
    labels = _labels(prob.n, 4, seed=2)
    other, rother = _problems("tri", 400, 4, seed=6)
    graph = ShardedGraph.from_problem(prob, 2)
    reused = _ranks(refine, 2, prob, labels, device=CPU, devices=2,
                    graph=graph)
    built = _ranks(refine, 2, prob, labels, device=CPU, devices=2)
    _assert_same(reused, built)
    # a graph of 4 ranks serves the (2, 2) mesh
    mesh = _ranks(refine, (2, 2), prob, labels, device=CPU, devices=(2, 2),
                  graph=ShardedGraph.from_problem(prob, 4))
    flat = _ranks(refine, 4, prob, labels, device=CPU, devices=4)
    np.testing.assert_array_equal(mesh.labels, flat.labels)
    assert mesh.stats["refine"] == dict(flat.stats["refine"],
                                        devices=[2, 2])
    rgraph = RefGraph.from_problem(rp, 2)
    cases = {
        "problem": (ShardedGraph.from_problem(other, 2),
                    RefGraph.from_problem(rother, 2), 2),
        "devices": (graph, rgraph, 4),
    }
    for name, (pg, rg, devices) in cases.items():
        with pytest.raises(ValueError) as want:
            _reference(ref_refine, rp, labels, devices=devices, graph=rg)
        # raised before any rank is launched
        with pytest.raises(ValueError) as got:
            refine(prob, labels, device=CPU, devices=devices, graph=pg)
        assert str(got.value) == str(want.value), name


@pytest.mark.parametrize("hierarchy", [None, (2, 2)])
def test_partition_with_devices_and_refine(hierarchy):
    prob, rp = _problems("delaunay2d", 600, 4, seed=1)
    got = _ranks(partition, 2, prob, device=CPU, devices=2,
                 hierarchy=hierarchy, refine=True)
    base = _ranks(partition, 2, prob, device=CPU, devices=2,
                  hierarchy=hierarchy)
    want = _reference(ref_refine, rp, base.labels, devices=2)
    assert got.method == base.method + "+lp"
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.stats["refine"] == want.stats["refine"]
    assert got.stats["refine"]["devices"] == 2
    # the reference composes the same way on its own solve
    ref = _reference(ref_partition, rp, devices=2, hierarchy=hierarchy,
                     refine=True)
    again = _reference(ref_refine, rp, _reference(
        ref_partition, rp, devices=2, hierarchy=hierarchy).labels,
        devices=2)
    np.testing.assert_array_equal(ref.labels, again.labels)
    assert ref.stats["refine"] == again.stats["refine"]


def test_repartition_with_devices_and_refine():
    """A warm step over 2 ranks refined over them: the refinement of the
    unrefined warm step's labels, migration counted over the refined
    labels."""
    prob, rp = _problems("delaunay2d", 600, 4, seed=4)
    prev = partition(prob, device=CPU)
    w = np.random.default_rng(2).lognormal(0.0, 0.3, prob.n)
    prob1, rp1 = prob.replace(weights=w), rp.replace(weights=w)
    got = _ranks(repartition, 2, prob1, prev, device=CPU, devices=2,
                 refine=True)
    base = _ranks(repartition, 2, prob1, prev, device=CPU, devices=2)
    want = _reference(ref_refine, rp1, base.labels, devices=2)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.stats["refine"] == want.stats["refine"]
    assert got.stats["warm_start"] and got.method == base.method + "+lp"
    from repro.partition.repartition import \
        _migration_stats as ref_migration
    assert got.stats["migration"] == ref_migration(prev, got.labels, w)


def test_result_refine_with_devices():
    prob, rp = _problems("rggpow", 500, 6, seed=7)
    res = partition(prob, method="rcb", device=CPU)
    got = _ranks(res.refine, 4, device=CPU, devices=4)
    want = _reference(ref_refine, rp, res.labels, devices=4)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.method == "rcb+lp"
    assert got.stats["refine"] == want.stats["refine"]


def test_mesh_2d_is_a_deliberate_departure():
    """The reference runs the rounds over (2, 2) and then raises
    ``TypeError`` on ``int(devices)`` (its ``refine.py:525``); the port
    gives the labels and stats of devices=4, with ``devices`` recorded as
    ``[2, 2]``."""
    prob, rp = _problems("tri", 400, 6, seed=5)
    labels = _labels(prob.n, 6, seed=5)
    with pytest.raises(TypeError):
        _reference(ref_refine, rp, labels, devices=(2, 2))
    with pytest.raises(TypeError):
        _reference(ref_partition, rp, devices=(2, 2), refine=True)
    got = _ranks(refine, (2, 2), prob, labels, device=CPU, devices=(2, 2))
    flat = _reference(ref_refine, rp, labels, devices=4)
    np.testing.assert_array_equal(got.labels, flat.labels)
    assert got.stats["refine"] == dict(flat.stats["refine"], devices=[2, 2])
    res = _ranks(partition, (2, 2), prob, device=CPU, devices=(2, 2),
                 refine=True)
    four = _ranks(partition, 4, prob, device=CPU, devices=4, refine=True)
    np.testing.assert_array_equal(res.labels, four.labels)
    assert res.stats["refine"]["devices"] == [2, 2]


def test_default_device_raises_before_any_launch(monkeypatch):
    prob, _ = _problems("tri", 200, 4, seed=0)
    labels = _labels(prob.n, 4, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "run", lambda *a, **k: pytest.fail(
        "launched without a device"))
    for call in (lambda: refine(prob, labels, devices=2),
                 lambda: lp.label_prop_refine(prob, labels, devices=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_spawned_ranks_from_the_front_door(monkeypatch):
    """Outside a process group ``refine(devices=2)`` spawns its ranks; the
    result equals the thread ranks' and the single-device rounds'."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", DEADLINE)
    prob, _ = _problems("tri", 400, 4, seed=3)
    labels = _labels(prob.n, 4, seed=3)
    spawned = refine(prob, labels, device=CPU, devices=2)
    threads = _ranks(refine, 2, prob, labels, device=CPU, devices=2)
    single = refine(prob, labels, device=CPU)
    _assert_same(spawned, threads)
    np.testing.assert_array_equal(spawned.labels, single.labels)
    assert spawned.problem is prob
    assert not multiprocessing.active_children()


def test_sharded_refine_on_the_port_mesh_zoo():
    """The port's own meshes (``repro_torch.core.meshes``) through the
    sharded path: the same graph as the reference's meshes, so the same
    bits."""
    mesh = meshes.REGISTRY["climate25d"](500, seed=9)
    prob = PartitionProblem.from_mesh(mesh, k=5, seed=9)
    rp = RefProblem.from_mesh(ref_meshes.REGISTRY["climate25d"](500, seed=9),
                              k=5, seed=9)
    labels = _labels(prob.n, 5, seed=9)
    _assert_same(_ranks(refine, 4, prob, labels, device=CPU, devices=4),
                 _reference(ref_refine, rp, labels, devices=4))
