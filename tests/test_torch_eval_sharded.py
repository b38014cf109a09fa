"""The port's sharded evaluation against the reference's and the host
metrics, on the CPU (thread ranks over gloo, as in
tests/test_torch_sharded.py).

Contract: every metric is an integer count, so the sharded ``ShardedGraph``
arrays, ``edge_cut_sharded``, ``comm_volume_sharded``,
``boundary_nodes_sharded``, ``evaluate_sharded`` and
``PartitionResult.evaluate(devices=)`` equal the reference's sharded
metrics and the host metrics exactly, at every rank count. Every
multi-rank run has a deadline of ``DEADLINE`` seconds.
"""

import numpy as np
import pytest
import torch
from reference_calls import reference

from repro.core import meshes as ref_meshes
from repro.eval import evaluate_sharded as ref_evaluate_sharded
from repro.eval.sharded import ShardedGraph as RefGraph
from repro.partition import PartitionProblem as RefProblem
from repro_torch.core import meshes, metrics
from repro_torch.dist import launch
from repro_torch.eval import (ShardedGraph, boundary_nodes_sharded,
                              comm_volume_sharded, edge_cut_sharded,
                              evaluate_sharded)
from repro_torch.partition import PartitionProblem, partition

torch.set_num_threads(1)

CPU = "cpu"
DEADLINE = 120.0


def _ranks(fn, nranks, *args, **kwargs):
    return launch.launch(fn, nranks, args=args, kwargs=kwargs, device=CPU,
                         threads=True, timeout=DEADLINE)


def _problems(family, n, k, seed=0):
    port = PartitionProblem.from_mesh(meshes.REGISTRY[family](n, seed=seed),
                                      k=k)
    ref = RefProblem.from_mesh(ref_meshes.REGISTRY[family](n, seed=seed),
                               k=k)
    return port, ref


def _labels(n, k, seed):
    return np.random.default_rng(seed).integers(0, k, n)


@pytest.mark.parametrize("devices", [1, 2, 3])
def test_sharded_graph_equals_reference(devices):
    prob, rprob = _problems("delaunay2d", 500, 4)
    got = ShardedGraph.from_problem(prob, devices)
    want = RefGraph.from_problem(rprob, devices)
    assert got.ecap == want.ecap and got.devices == want.devices
    for name in ("src", "dst", "edge_valid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="edge_cap"):
        ShardedGraph.from_sharded(got.sharded, edge_cap=got.ecap - 1)
    roomy = ShardedGraph.from_sharded(got.sharded, edge_cap=got.ecap + 3)
    assert roomy.ecap == got.ecap + 3
    with pytest.raises(ValueError, match="CSR"):
        ShardedGraph.from_problem(PartitionProblem(points=prob.points, k=4),
                                  devices)


@pytest.mark.parametrize("family", ["delaunay2d", "rgg3d", "tri"])
@pytest.mark.parametrize("devices", [1, 2, 4])
def test_metrics_equal_reference_and_host(family, devices):
    prob, rprob = _problems(family, 700, 6, seed=2)
    for labels in (_labels(prob.n, prob.k, devices),
                   partition(prob, method="rcb", device=CPU).labels):
        got = _ranks(evaluate_sharded, devices, prob, labels, devices,
                     device=CPU)
        want = reference(ref_evaluate_sharded, rprob, labels, devices)
        host = metrics.evaluate_problem(prob, labels)
        assert got == want == host


def _three_metrics(graph, labels):
    return (edge_cut_sharded(graph, labels, device=CPU),
            comm_volume_sharded(graph, labels, device=CPU),
            boundary_nodes_sharded(graph, labels, device=CPU))


def test_metric_functions_and_their_memo():
    prob, _ = _problems("refined2d", 600, 5, seed=4)
    labels = _labels(prob.n, prob.k, 9)
    graph = prob.to_sharded_graph(3)
    cut, (vmax, vtot, vol), (btot, bnd) = _ranks(_three_metrics, 3, graph,
                                                 labels)
    assert cut == metrics.edge_cut(labels, prob.indptr, prob.indices)
    hmax, htot, hvol = metrics.comm_volume(labels, prob.indptr,
                                           prob.indices, prob.k)
    assert (vmax, vtot) == (hmax, htot)
    np.testing.assert_array_equal(vol, hvol)
    htot_b, hbnd = metrics.boundary_nodes(labels, prob.indptr, prob.indices,
                                          prob.k)
    assert btot == htot_b
    np.testing.assert_array_equal(bnd, hbnd)
    with pytest.raises(ValueError, match="labels must be"):
        edge_cut_sharded(graph, labels[:-1], device=CPU)
    with pytest.raises(ValueError, match="different problem"):
        evaluate_sharded(prob, labels, 2, graph=graph, device=CPU)


def test_result_evaluate_with_devices():
    prob, _ = _problems("delaunay3d", 800, 8, seed=1)
    res = partition(prob, device=CPU)
    host = dict(res.evaluate())

    def sharded(result):
        return result.evaluate(devices=2, device=CPU)

    assert _ranks(sharded, 2, res) == host
    with pytest.raises(ValueError, match="with_diameter"):
        res.evaluate(with_diameter=True, devices=2)


def test_evaluate_sharded_spawns_its_ranks(monkeypatch):
    """Outside a process group the call launches its own ranks."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", DEADLINE)
    prob, _ = _problems("tri", 400, 4, seed=3)
    labels = _labels(prob.n, prob.k, 1)
    assert evaluate_sharded(prob, labels, 2, device=CPU) == \
        metrics.evaluate_problem(prob, labels)
