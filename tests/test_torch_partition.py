"""The port's front door, metrics, baselines and mesh zoo against the
reference, on the CPU, across ``meshes.REGISTRY``.

Contracts: meshes, metrics and baselines exactly equal (host numpy in
both packages); ``partition(method="geographer", device="cpu")`` balanced
wherever the reference is, with at least 99% label agreement and cut and
total comm volume within 2% of the reference's on these instances; the
reference's known unbalanced instance reproduced, not asserted balanced.
"""
import numpy as np
import pytest
import torch

from repro.core import baselines as ref_baselines
from repro.core import meshes as ref_meshes
from repro.core import metrics as ref_metrics
from repro.partition import PartitionProblem as RefProblem
from repro.partition import partition as ref_partition
from repro_torch.core import baselines, meshes, metrics
from repro_torch.partition import (NotYetPortedError, PartitionProblem,
                                   available_methods, partition)

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)

FAMILIES = sorted(ref_meshes.REGISTRY)


def _mesh(family, n=600, seed=1):
    return meshes.REGISTRY[family](n, seed=seed)


def test_registry_has_the_same_families():
    assert sorted(meshes.REGISTRY) == FAMILIES
    assert available_methods() == ["geographer", "multijagged", "rcb",
                                   "rib", "sfc"]


@pytest.mark.parametrize("family", FAMILIES)
def test_meshes_equal(family):
    a = _mesh(family, 500, seed=4)
    b = ref_meshes.REGISTRY[family](500, seed=4)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        np.testing.assert_array_equal(a.weights, b.weights)
    assert a.name == b.name


@pytest.mark.parametrize("family", FAMILIES)
def test_baselines_equal(family):
    m = _mesh(family, 700, seed=2)
    for name in ("rcb", "rib", "hsfc", "mj"):
        np.testing.assert_array_equal(
            baselines.BASELINES[name](m.points, 12, m.weights),
            ref_baselines.BASELINES[name](m.points, 12, m.weights))


@pytest.mark.parametrize("family", FAMILIES)
def test_metrics_equal(family):
    m = _mesh(family, 500, seed=3)
    k = 7
    part = ref_baselines.rcb(m.points, k, m.weights)
    other = ref_baselines.sfc_partition(m.points, k, m.weights)
    assert metrics.imbalance(part, k, m.weights) == \
        ref_metrics.imbalance(part, k, m.weights)
    np.testing.assert_array_equal(metrics.block_sizes(part, k, m.weights),
                                  ref_metrics.block_sizes(part, k, m.weights))
    assert metrics.edge_cut(part, m.indptr, m.indices) == \
        ref_metrics.edge_cut(part, m.indptr, m.indices)
    a = metrics.comm_volume(part, m.indptr, m.indices, k)
    b = ref_metrics.comm_volume(part, m.indptr, m.indices, k)
    assert a[:2] == b[:2]
    np.testing.assert_array_equal(a[2], b[2])
    a = metrics.boundary_nodes(part, m.indptr, m.indices, k)
    b = ref_metrics.boundary_nodes(part, m.indptr, m.indices, k)
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(
        metrics.block_diameters(part, m.indptr, m.indices, k),
        ref_metrics.block_diameters(part, m.indptr, m.indices, k))
    assert metrics.evaluate_partition(m, part, k, with_diameter=True) == \
        ref_metrics.evaluate_partition(m, part, k, with_diameter=True)
    for fn in ("migration_volume", "migration_fraction",
               "retained_fraction"):
        assert getattr(metrics, fn)(part, other, m.weights) == \
            getattr(ref_metrics, fn)(part, other, m.weights)
        # torch tensors are moved to the host first
        assert getattr(metrics, fn)(torch.from_numpy(part),
                                    torch.from_numpy(other), m.weights) == \
            getattr(ref_metrics, fn)(part, other, m.weights)
    np.testing.assert_array_equal(
        metrics.quantize_weights(m.weights, m.n),
        ref_metrics.quantize_weights(m.weights, m.n))


def test_batch_metrics_equal():
    rng = np.random.default_rng(0)
    lab = rng.integers(0, 5, (4, 50))
    new = rng.integers(0, 5, (4, 50))
    w = rng.uniform(0, 2, (4, 50))
    w[:, 40:] = 0.0
    np.testing.assert_array_equal(metrics.batch_imbalance(lab, 5, w),
                                  ref_metrics.batch_imbalance(lab, 5, w))
    np.testing.assert_array_equal(
        metrics.batch_migration_fraction(lab, new, w),
        ref_metrics.batch_migration_fraction(lab, new, w))
    assert metrics.harmonic_mean(np.array([1.0, 2.0, 0.0])) == \
        ref_metrics.harmonic_mean(np.array([1.0, 2.0, 0.0]))


@pytest.mark.parametrize("family", FAMILIES)
def test_geographer_matches_reference_across_zoo(family):
    m = _mesh(family)
    ref = ref_partition(RefProblem.from_mesh(m, k=8), evaluate=True)
    got = partition(PartitionProblem.from_mesh(m, k=8), device="cpu",
                    evaluate=True)
    q, rq = got.quality, ref.quality
    if rq["imbalance"] <= 0.03 + 1e-9:
        assert q["imbalance"] <= 0.03 + 1e-9
    assert np.mean(got.labels == ref.labels) >= 0.99
    assert abs(q["cut"] / rq["cut"] - 1.0) <= 0.02
    assert abs(q["totalCommVol"] / rq["totalCommVol"] - 1.0) <= 0.02
    assert got.labels.dtype == np.int64
    assert got.centers.shape == (8, m.points.shape[1])
    np.testing.assert_allclose(got.centers, ref.centers, rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("method", ["sfc", "rcb", "rib", "multijagged"])
def test_baseline_methods_match_reference(method):
    m = _mesh("climate25d", 800, seed=5)
    got = partition(PartitionProblem.from_mesh(m, k=10), method=method,
                    device="cpu", evaluate=True)
    ref = ref_partition(RefProblem.from_mesh(m, k=10), method=method,
                        evaluate=True)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.quality == ref.quality
    assert got.stats["final_imbalance"] == ref.stats["final_imbalance"]


@pytest.mark.parametrize("backend", ["cuda", "cuda_flat"])
def test_kernel_backends_through_front_door(backend):
    """The CUDA backends' wrappers on CPU tensors (the plain versions)
    give the dense backend's partition."""
    m = _mesh("delaunay3d", 900, seed=6)
    prob = PartitionProblem.from_mesh(m, k=12)
    base = partition(prob, device="cpu")
    for fused in (None, False):
        got = partition(prob, device="cpu", backend=backend, fused=fused)
        assert np.mean(got.labels == base.labels) >= 0.99
        assert got.imbalance() <= prob.epsilon + 1e-9


def test_known_unbalanced_reference_instance_is_reproduced():
    """aniso n=400 seed=278670 k=6: the reference ends at imbalance 0.065
    (> eps); the port reproduces its final_imbalance, labels and
    iteration count instead of claiming balance."""
    m = meshes.REGISTRY["aniso"](400, seed=278670)
    ref = ref_partition(RefProblem.from_mesh(m, k=6, seed=278670))
    got = partition(PartitionProblem.from_mesh(m, k=6, seed=278670),
                    device="cpu")
    assert ref.stats["final_imbalance"] > 0.03
    assert got.stats["final_imbalance"] == pytest.approx(
        ref.stats["final_imbalance"], abs=1e-5)
    assert got.imbalance() == ref.imbalance()
    np.testing.assert_array_equal(got.labels, ref.labels)


def test_unported_options_raise():
    prob = PartitionProblem.from_mesh(_mesh("tri", 400), k=4)
    for kw in ({"hierarchy": (2, 2)}, {"devices": 2}, {"refine": True},
               {"refine_eps": 0.05}):
        with pytest.raises(NotImplementedError, match="slice"):
            partition(prob, device="cpu", **kw)
    res = partition(prob, method="sfc", device="cpu")
    with pytest.raises(NotYetPortedError, match="refinement"):
        res.refine()
    with pytest.raises(NotYetPortedError):
        res.evaluate(devices=2)
    with pytest.raises(NotYetPortedError):
        prob.to_sharded(2)
    with pytest.raises(NotYetPortedError):
        prob.to_sharded_graph(2)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = PartitionProblem(points=np.random.default_rng(0).uniform(
        0, 1, (200, 2)), k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition(prob)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        partition(prob, device="cuda")
    assert partition(prob, device="cpu").imbalance() <= prob.epsilon


def test_front_door_rejects_bad_input():
    prob = PartitionProblem(points=np.zeros((10, 2)), k=2)
    with pytest.raises(TypeError, match="PartitionProblem"):
        partition(np.zeros((10, 2)), device="cpu")
    with pytest.raises(KeyError, match="unknown partition method"):
        partition(prob, method="metis", device="cpu")
    with pytest.raises(TypeError, match="unknown BKMConfig options"):
        partition(prob, device="cpu", max_iters=3)
