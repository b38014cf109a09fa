"""Dynamic repartitioning in the port against the reference, on the CPU:
the workloads, ``repartition()``, and the two load-balance drivers.

Contracts:
- workload weights (float32) against the reference's, in ulps of the
  weight: against its eager evaluation (the host loop's) DriftingHotspot
  within ``EAGER_ULPS`` (1: torch's and XLA's exp differ by an ulp),
  MovingRefinement exactly, RotatingWave within 32 (atan2 and cos each
  differ by an ulp; the cancellations in ``lobes*theta - omega*t`` and
  ``1 + cos`` amplify it); against its jitted evaluation (the scan's)
  within ``JIT_ULPS``, because under jit XLA multiplies by the
  reciprocal of ``2 sigma^2`` and contracts multiply-adds into FMAs
  (``test_reference_rounding_eager_and_jit`` pins both);
- one warm step from the same previous state (carried over by
  ``convert.result_from_numpy``) on the same weights: >= 0.99 label
  agreement (these instances agree on every label), equal ``iters``,
  migration fraction within 1e-6;
- the scan-semantics loop against the host loop: equal ``iters``,
  migration within rtol 1e-5 (float32 on the device against float64);
- an unchanged problem is a strict fixed point (0 iterations, 0
  migration); the reference's error paths raise the same exception
  types; the acceptance ratios of the reference's test hold.
"""
import numpy as np
import pytest
import torch

from repro.core import meshes as ref_meshes
from repro.core.timeseries import simulate_loadbalance as ref_simulate
from repro.partition import PartitionProblem as RefProblem
from repro.partition import greedy_center_match as ref_match
from repro.partition import partition as ref_partition
from repro.partition import repartition as ref_repartition
from repro.partition import weighted_centroids as ref_centroids
from repro_torch.convert import result_from_numpy
from repro_torch.core import meshes, metrics
from repro_torch.core.balanced_kmeans import BKMConfig
from repro_torch.core.timeseries import (simulate_loadbalance,
                                         simulate_loadbalance_scan)
from repro_torch.dist import launch
from repro_torch.partition import (PartitionProblem, WarmState,
                                   greedy_center_match, partition, refine,
                                   repartition,
                                   supports_warm_start, warm_start_methods,
                                   weighted_centroids)
from repro_torch.partition.repartition import (MAX_BALANCE_RETRIES,
                                               WARM_DELTA_TOL)

torch.set_num_threads(1)

EPS = 0.03
CPU = "cpu"
EAGER_ULPS = {"drifting_hotspot": 1, "rotating_wave": 32, "amr_refine": 0}
JIT_ULPS = {"drifting_hotspot": 16, "rotating_wave": 32, "amr_refine": 0}


def _ulps(a, b) -> int:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ai - bi)))


def _points(n, seed, d=2):
    return np.random.default_rng(seed).uniform(0, 1, (n, d))


def _problem(n=2000, k=8, seed=0, t=0):
    pts = _points(n, seed)
    w = np.asarray(ref_meshes.WORKLOADS["drifting_hotspot"]()
                   .weights_at(pts, t))
    return PartitionProblem(points=pts, k=k, weights=w, epsilon=EPS,
                            seed=seed)


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def test_workload_registry_and_defaults_match():
    assert sorted(meshes.WORKLOADS) == sorted(ref_meshes.WORKLOADS)
    for name, cls in meshes.WORKLOADS.items():
        ref = ref_meshes.WORKLOADS[name]()
        assert cls().__dict__ == ref.__dict__
        assert hash(cls()) == hash(cls())          # frozen, hashable


@pytest.mark.parametrize("name", sorted(EAGER_ULPS))
def test_workload_weights_match_reference(name):
    """Both of the reference's evaluations, at t = 0..12, d = 2 and 3."""
    import jax
    import jax.numpy as jnp
    wl, ref = meshes.WORKLOADS[name](), ref_meshes.WORKLOADS[name]()
    jit = jax.jit(lambda p, t: ref.weights_at(p, t))
    for d in (2, 3):
        pts = _points(20000, d, d)
        for t in range(13):
            got = wl.weights_at(pts, t)
            assert got.dtype == torch.float32 and got.shape == (20000,)
            eager = np.asarray(ref.weights_at(pts, t))
            assert _ulps(got.numpy(), eager) <= EAGER_ULPS[name], (d, t)
            traced = np.asarray(jit(jnp.asarray(pts, jnp.float32),
                                    jnp.float32(t)))
            assert _ulps(got.numpy(), traced) <= JIT_ULPS[name], (d, t)


def test_workload_weights_keep_the_tensor_device():
    pts = torch.from_numpy(_points(100, 1))
    for cls in meshes.WORKLOADS.values():
        w = cls().weights_at(pts, 3)
        assert w.device == pts.device and w.dtype == torch.float32


def test_reference_rounding_eager_and_jit():
    """The reference's hotspot exponent ``-d2 / (2 sigma^2)`` on the same
    d2: eagerly a true float32 division (what the port computes), under
    jit a multiplication by the float32 reciprocal of the constant."""
    import jax
    import jax.numpy as jnp
    sigma = ref_meshes.WORKLOADS["drifting_hotspot"]().sigma
    d2 = np.random.default_rng(0).uniform(0, 2, 50000).astype(np.float32)
    c = np.float32(2.0 * sigma ** 2)
    divide = -d2 / c
    multiply = -d2 * (np.float32(1.0) / c)
    assert not np.array_equal(divide, multiply)     # the input tells
    eager = np.asarray(-jnp.asarray(d2) / (2.0 * sigma ** 2))
    traced = np.asarray(jax.jit(lambda x: -x / (2.0 * sigma ** 2))(d2))
    np.testing.assert_array_equal(eager, divide)
    np.testing.assert_array_equal(traced, multiply)
    port = -torch.from_numpy(d2) / meshes._const(torch.from_numpy(d2),
                                                 2.0 * sigma ** 2)
    np.testing.assert_array_equal(port.numpy(), divide)


# ---------------------------------------------------------------------------
# repartition()
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_warm_step_matches_reference(seed):
    """One warm step of both packages from the reference's cold result,
    on the reference's weights."""
    wl = ref_meshes.WORKLOADS["drifting_hotspot"]()
    pts = _points(2000, seed)
    w0, w1 = (np.asarray(wl.weights_at(pts, t)) for t in (0, 1))
    rprob = RefProblem(points=pts, k=8, weights=w0, seed=seed)
    rprev = ref_partition(rprob)
    want = ref_repartition(rprob.replace(weights=w1), rprev)
    prob = PartitionProblem(points=pts, k=8, weights=w0, seed=seed)
    prev = result_from_numpy(prob, rprev.labels, rprev.centers,
                             rprev.influence)
    got = repartition(prob.replace(weights=w1), prev, device=CPU)
    assert np.mean(got.labels == np.asarray(want.labels)) >= 0.99
    assert got.stats["iters"] == want.stats["iters"]
    assert got.stats["warm_start"] is True
    assert got.stats["balance_retries"] == want.stats["balance_retries"]
    assert got.stats["migration"]["fraction"] == pytest.approx(
        want.stats["migration"]["fraction"], abs=1e-6)
    assert got.imbalance() <= EPS + 1e-6


def test_unchanged_problem_is_fixed_point():
    prob = _problem(n=1500, k=8, seed=5)
    prev = partition(prob, device=CPU)
    res = repartition(prob, prev, device=CPU)
    assert res.stats["iters"] == 0
    assert res.stats["migration"]["volume"] == 0.0
    np.testing.assert_array_equal(res.labels, prev.labels)


def test_cold_relabel_recovers_identical_labels():
    prob = _problem(n=1000, k=8)
    prev = partition(prob, method="rcb", device=CPU)
    res = repartition(prob, prev, method="rcb", device=CPU)
    assert res.stats["warm_start"] is False
    assert res.stats["relabel_matched"] is True
    np.testing.assert_array_equal(res.labels, prev.labels)
    auto = repartition(prob, prev, method="geographer", device=CPU)
    assert auto.stats["warm_start"] is False and "migration" in auto.stats


def test_matching_and_centroids_equal_reference():
    rng = np.random.default_rng(3)
    new, prev = rng.uniform(0, 1, (9, 2)), rng.uniform(0, 1, (9, 2))
    np.testing.assert_array_equal(greedy_center_match(new, prev),
                                  ref_match(new, prev))
    pts = rng.uniform(0, 1, (300, 3))
    lab = rng.integers(0, 7, 300)
    w = rng.uniform(0.5, 2.0, 300)
    for weights in (None, w):
        np.testing.assert_array_equal(
            weighted_centroids(pts, lab, 8, weights),
            ref_centroids(pts, lab, 8, weights))


def test_registry_flags_and_constants():
    assert supports_warm_start("geographer") and supports_warm_start("bkm")
    assert not supports_warm_start("rcb")
    assert warm_start_methods() == ["geographer"]
    from repro.partition import repartition as ref_mod
    assert WARM_DELTA_TOL == ref_mod.__globals__["WARM_DELTA_TOL"]
    assert MAX_BALANCE_RETRIES == ref_mod.__globals__["MAX_BALANCE_RETRIES"]


def test_warm_state_and_its_conversion():
    prob = _problem(n=300, k=4, seed=4)
    rres = ref_partition(RefProblem(points=prob.points, k=4,
                                    weights=prob.weights, seed=4))
    state = WarmState.capture(result_from_numpy(
        prob, rres.labels, rres.centers, rres.influence))
    assert (state.n, state.k, state.dim) == (300, 4, 2)
    assert state.compatible_with(300, 4)
    assert not state.compatible_with(300, 8)
    np.testing.assert_array_equal(state.labels, np.asarray(rres.labels))
    np.testing.assert_array_equal(state.influence_or_ones(),
                                  np.asarray(rres.influence))
    with pytest.raises(ValueError, match="no centers"):
        WarmState.capture(partition(prob, method="sfc", device=CPU))
    with pytest.raises(ValueError, match="does not match"):
        WarmState(centers=np.zeros((4, 2)), influence=np.ones(3),
                  labels=np.zeros(10))


@pytest.mark.parametrize("case", ["k", "n", "warm_rcb", "no_centers",
                                  "problem", "previous"])
def test_error_paths_raise_the_reference_types(case):
    """Each case raises in the port what it raises in the reference."""
    pts = _points(400, 0)

    def run(problem_cls, part, repart, **kw):
        prob = problem_cls(points=pts, k=4, epsilon=EPS)
        geo = part(prob, method="geographer", **kw)
        rcb = part(prob, method="rcb", **kw)
        calls = {
            "k": lambda: repart(prob.replace(k=8), geo, **kw),
            "n": lambda: repart(problem_cls(points=pts[:200], k=4), geo,
                                **kw),
            "warm_rcb": lambda: repart(prob, rcb, method="rcb", warm=True,
                                       **kw),
            "no_centers": lambda: repart(prob, rcb, method="geographer",
                                         warm=True, **kw),
            "problem": lambda: repart(pts, geo, **kw),
            "previous": lambda: repart(prob, geo.labels, **kw),
        }
        try:
            calls[case]()
        except Exception as e:          # noqa: BLE001 - the type is the test
            return type(e)
        return None

    want = run(RefProblem, ref_partition, ref_repartition)
    got = run(PartitionProblem, partition, repartition, device=CPU)
    assert want is not None and got is want


def test_unported_options_and_the_default_device(monkeypatch):
    prob = _problem(n=300, k=4)
    prev = partition(prob, device=CPU)
    # devices= is ported (tests/test_torch_sharded.py holds it), and so
    # are the sharded refinement rounds after the solve
    # (tests/test_torch_refine_sharded.py holds them against the reference)
    mesh = meshes.REGISTRY["delaunay2d"](300, seed=0)
    mprev = partition(PartitionProblem.from_mesh(mesh, k=4, epsilon=EPS),
                      device=CPU)
    mprob = mprev.problem.replace(weights=np.random.default_rng(1).lognormal(
        0.0, 0.3, mesh.n))
    got, base = (launch.launch(
        repartition, 2, args=(mprob, mprev),
        kwargs=dict(device=CPU, devices=2, **kw), device=CPU, threads=True,
        timeout=120) for kw in ({"refine": True}, {}))
    want = refine(mprob, base, device=CPU)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.stats["refine"] == dict(want.stats["refine"], devices=2)
    assert got.stats["migration"]["fraction"] == float(
        metrics.migration_fraction(mprev.labels, got.labels, mprob.weights))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = meshes.DriftingHotspot()
    for call in (lambda: repartition(prob, prev),
                 lambda: simulate_loadbalance(prob, wl, 1),
                 lambda: simulate_loadbalance_scan(
                     prob.points, prev.centers, prev.influence, prev.labels,
                     wl, 1, BKMConfig(k=4))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def test_host_loop_matches_reference():
    """Warm and cold host loops of both packages, T = 3, on weights the
    port computes within an ulp of the reference's."""
    pts = _points(2000, 7)
    ref_wl = ref_meshes.WORKLOADS["drifting_hotspot"]()
    w0 = np.asarray(ref_wl.weights_at(pts, 0))
    rprob = RefProblem(points=pts, k=8, weights=w0, epsilon=EPS, seed=7)
    prob = PartitionProblem(points=pts, k=8, weights=w0, epsilon=EPS,
                            seed=7)
    for mode in ("warm", "cold"):
        want = ref_simulate(rprob, ref_wl, steps=3, mode=mode)
        got = simulate_loadbalance(prob, meshes.DriftingHotspot(), steps=3,
                                   mode=mode, device=CPU)
        assert [r["iters"] for r in got["per_step"]] == \
            [r["iters"] for r in want["per_step"]]
        np.testing.assert_allclose(
            [r["migration_fraction"] for r in got["per_step"]],
            [r["migration_fraction"] for r in want["per_step"]],
            rtol=1e-5, atol=1e-6)
        assert got["summary"]["all_balanced"]
        assert np.mean(got["final_result"].labels ==
                       np.asarray(want["final_result"].labels)) >= 0.99
        assert set(got["per_step"][0]) >= set(want["per_step"][0])


def test_scan_semantics_equals_host_loop():
    prob = _problem(n=1500, k=8, seed=2)
    wl = meshes.DriftingHotspot()
    host = simulate_loadbalance(prob, wl, steps=4, mode="warm", device=CPU)
    prev = partition(prob.replace(weights=wl.weights_at(prob.points, 0)
                                  .numpy()), device=CPU)
    perm = np.random.default_rng(prob.seed).permutation(prob.n)
    cfg = BKMConfig(k=prob.k, warmup=False, delta_tol=WARM_DELTA_TOL)
    (c, i, lab), recs = simulate_loadbalance_scan(
        prob.points[perm], prev.centers, prev.influence,
        prev.labels[perm], wl, 4, cfg, device=CPU)
    assert recs["iters"].tolist() == [r["iters"] for r in host["per_step"]]
    np.testing.assert_allclose(
        recs["migration_fraction"].numpy(),
        [r["migration_fraction"] for r in host["per_step"]],
        rtol=1e-5, atol=1e-7)
    final = host["final_result"]
    np.testing.assert_array_equal(lab.numpy(), final.labels[perm])
    np.testing.assert_array_equal(c.numpy(), final.centers)
    assert all(0 <= r <= MAX_BALANCE_RETRIES
               for r in recs["balance_retries"].tolist())
    assert recs["retained_fraction"].numpy() == pytest.approx(
        1.0 - recs["migration_fraction"].numpy())


def test_acceptance_ratios_and_balance():
    """The claims of the reference's acceptance test (n = 3000, k = 16)
    at T = 4: cold/warm mean iterations >= 3, warm/cold migration <=
    0.30, every step balanced."""
    pts = _points(3000, 0)
    wl = meshes.DriftingHotspot()
    prob = PartitionProblem(points=pts, k=16, epsilon=EPS, seed=0)
    warm = simulate_loadbalance(prob, wl, steps=4, mode="warm", device=CPU)
    cold = simulate_loadbalance(prob, wl, steps=4, mode="cold", device=CPU)
    assert cold["summary"]["mean_iters"] >= \
        3.0 * warm["summary"]["mean_iters"]
    assert warm["summary"]["mean_migration_fraction"] <= \
        0.30 * cold["summary"]["mean_migration_fraction"]
    for run in (warm, cold):
        assert run["summary"]["all_balanced"], run["summary"]


@pytest.mark.parametrize("name", ["rotating_wave", "amr_refine"])
def test_other_workloads_run_balanced(name):
    prob = _problem(n=1200, k=8, seed=3)
    sim = simulate_loadbalance(prob, meshes.WORKLOADS[name](), steps=2,
                               mode="warm", device=CPU)
    assert sim["summary"]["all_balanced"], sim["summary"]
    assert sim["workload"] == meshes.WORKLOADS[name].__name__


def test_driver_argument_errors():
    prob = _problem(n=300, k=4)
    with pytest.raises(ValueError, match="mode"):
        simulate_loadbalance(prob, meshes.DriftingHotspot(), 2,
                             mode="lukewarm", device=CPU)
    with pytest.raises(ValueError, match="steps"):
        simulate_loadbalance(prob, meshes.DriftingHotspot(), 0, device=CPU)
