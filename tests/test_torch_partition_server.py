"""The port's ``PartitionServer`` on the CPU: admission, the warm cache,
per-request results against the port's own front doors, and against the
reference's server.

Contracts:
- inside the port, bit for bit: a cold request at n == cap equals
  ``partition()``; a warm hit equals ``repartition()`` from the same
  previous result, with equal ``iters`` (imbalance within 1e-12 and
  migration within 1e-6: the server sums the slot in its permuted
  order); a stream gives the same
  labels however its requests are interleaved;
- against the reference's server on the same stream: >= 0.99 label
  agreement per response (these agree on every label), equal ``iters``,
  ``warm`` and counters, imbalance within 1e-6 (the reference measures
  it in float32 in-graph, the port on the host in float64), migration
  within 1e-6;
- ``_prep_slot`` equals the reference's exactly; ``request_stream``'s
  weights are the workload's (within its ulps of the reference, see
  tests/test_torch_repartition.py);
- the reference's error paths raise the same exception types.
"""
import numpy as np
import pytest
import torch

from repro.core import meshes as ref_meshes
from repro.partition import PartitionProblem as RefProblem
from repro.serve import PartitionRequest as RefRequest
from repro.serve import PartitionServer as RefServer
from repro.serve import request_stream as ref_request_stream
from repro_torch.core import meshes
from repro_torch.partition import PartitionProblem, partition, repartition
from repro_torch.serve import (DEFAULT_TIERS, PartitionRequest,
                               PartitionServer, request_stream)

torch.set_num_threads(1)

CPU = "cpu"
TIERS = (256,)
K = 4


def _pts(n, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 2))


def _server(**kw):
    kw.setdefault("tiers", TIERS)
    kw.setdefault("slots", 2)
    kw.setdefault("cache_slots", 8)
    kw.setdefault("device", CPU)
    return PartitionServer(**kw)


def _req(tenant, n=256, k=K, seed=0, weights=None):
    return PartitionRequest(tenant=tenant, points=_pts(n, seed), k=k,
                            weights=weights, seed=seed)


def test_defaults_and_tier_router_match_reference():
    from repro.serve import DEFAULT_TIERS as REF_TIERS
    assert DEFAULT_TIERS == REF_TIERS
    server = _server(tiers=(256, 512, 1024))
    ref = RefServer(tiers=(256, 512, 1024))
    for n in (1, 200, 256, 257, 1024):
        assert server.tier_for(n) == ref.tier_for(n)
    assert server.step() == [] and server.stats["dispatches"] == 0


@pytest.mark.parametrize("case", ["oversized", "points", "k", "weights",
                                  "option", "per_request", "tiers",
                                  "slots", "cache", "submit"])
def test_error_paths_raise_the_reference_types(case):
    def run(server_cls, request_cls, **kw):
        calls = {
            "oversized": lambda: server_cls(tiers=TIERS, **kw).submit(
                request_cls(tenant="a", points=_pts(300), k=2)),
            "points": lambda: request_cls(tenant="a", points=np.zeros(5),
                                          k=2),
            "k": lambda: request_cls(tenant="a", points=_pts(8), k=9),
            "weights": lambda: request_cls(tenant="a", points=_pts(8), k=2,
                                           weights=np.ones(7)),
            "option": lambda: server_cls(tiers=TIERS, nonsense=1, **kw),
            "per_request": lambda: server_cls(tiers=TIERS, epsilon=0.1,
                                              **kw),
            "tiers": lambda: server_cls(tiers=(100,), **kw),
            "slots": lambda: server_cls(tiers=TIERS, slots=0, **kw),
            "cache": lambda: server_cls(tiers=TIERS, cache_slots=-1, **kw),
            "submit": lambda: server_cls(tiers=TIERS, **kw).submit("a"),
        }
        try:
            calls[case]()
        except Exception as e:          # noqa: BLE001 - the type is the test
            return type(e), str(e).split(" ")[:3]
        return None

    want = run(RefServer, RefRequest)
    assert want is not None
    assert run(PartitionServer, PartitionRequest, device=CPU) == want


def test_prep_slot_equals_reference():
    pts = _pts(50, seed=7)
    w = np.random.default_rng(1).uniform(1, 2, 50)
    req = PartitionRequest(tenant="x", points=pts, k=4, weights=w, seed=9)
    ref_req = RefRequest(tenant="x", points=pts, k=4, weights=w, seed=9)
    got = _server(tiers=(64,))._prep_slot(req, 64, None)
    want = RefServer(tiers=(64,))._prep_slot(ref_req, 64, None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_cold_solve_at_cap_equals_partition():
    pts = _pts(256, seed=3)
    w = np.random.default_rng(3).uniform(1, 3, 256)
    [resp] = _server().serve(
        [PartitionRequest(tenant="t", points=pts, k=K, weights=w, seed=3)])
    ref = partition(PartitionProblem(points=pts, k=K, weights=w, seed=3),
                    device=CPU)
    np.testing.assert_array_equal(resp.labels, ref.labels)
    np.testing.assert_array_equal(resp.centers, ref.centers)
    np.testing.assert_array_equal(resp.influence, ref.influence)
    assert resp.iters == int(ref.stats["levels"][0]["iters"])
    assert not resp.warm and resp.balanced
    assert resp.imbalance == pytest.approx(ref.imbalance(), abs=1e-12)


def test_warm_hit_equals_repartition():
    pts = _pts(256, seed=3)
    w = 1.0 + 6 * np.exp(-np.sum((pts - 0.3) ** 2, axis=1) / 0.03)
    server = _server()
    [r0] = server.serve(
        [PartitionRequest(tenant="t", points=pts, k=K, seed=3)])
    [r1] = server.serve(
        [PartitionRequest(tenant="t", points=pts, k=K, weights=w, seed=3)])
    assert r1.warm and server.stats["warm_hits"] == 1
    prob0 = PartitionProblem(points=pts, k=K, seed=3)
    prev = partition(prob0, device=CPU)
    np.testing.assert_array_equal(r0.labels, prev.labels)
    ref = repartition(prob0.replace(weights=w), prev, device=CPU)
    np.testing.assert_array_equal(r1.labels, ref.labels)
    np.testing.assert_array_equal(r1.centers, ref.centers)
    assert r1.iters == ref.stats["iters"]
    assert r1.migration_fraction == pytest.approx(
        ref.stats["migration"]["fraction"], abs=1e-6)


def _stream(server, request_cls, order, steps=2):
    """Four tenants of different n, the same weights field each step,
    served in ``order`` at step 0 and the reverse after."""
    out = {}
    for t in range(steps):
        reqs = [request_cls(tenant=c, points=_pts(200 + 10 * i, seed=i),
                            k=K, seed=i,
                            weights=1.0 + np.linspace(0, 5 * t,
                                                      200 + 10 * i))
                for i, c in enumerate("abcd")]
        seq = order if t % 2 == 0 else order[::-1]
        for r in server.serve([reqs[i] for i in seq]):
            out[(t, r.tenant)] = r
    return out


def test_stream_determinism_under_interleaving():
    a = _stream(_server(), PartitionRequest, [0, 1, 2, 3], steps=3)
    b = _stream(_server(), PartitionRequest, [2, 0, 3, 1], steps=3)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key].labels, b[key].labels)
        assert a[key].iters == b[key].iters


def test_stream_matches_reference_server():
    port, ref = _server(), RefServer(tiers=TIERS, slots=2, cache_slots=8)
    got = _stream(port, PartitionRequest, [0, 1, 2, 3])
    want = _stream(ref, RefRequest, [0, 1, 2, 3])
    assert got.keys() == want.keys()
    for key, r in want.items():
        g = got[key]
        assert np.mean(g.labels == r.labels) >= 0.99
        assert (g.iters, g.warm, g.tier, g.balanced) == \
            (r.iters, r.warm, r.tier, r.balanced)
        assert g.imbalance == pytest.approx(r.imbalance, abs=1e-6)
        if r.migration_fraction is None:
            assert g.migration_fraction is None
        else:
            assert g.migration_fraction == pytest.approx(
                r.migration_fraction, abs=1e-6)
        assert sorted(g.stats) == sorted(r.stats)
    assert port.stats == ref.stats


def test_padded_slot_is_balanced_and_valid():
    [resp] = _server().serve([_req("small", n=180)])
    assert resp.labels.shape == (180,)
    assert set(np.unique(resp.labels)) <= set(range(K))
    assert resp.balanced and resp.tier == 256


def test_heterogeneous_batch_one_step():
    server = _server(slots=4)
    reqs = [_req("a", n=256, seed=1), _req("b", n=200, seed=2),
            _req("c", n=180, seed=3)]
    out = server.serve(reqs)
    assert [r.tenant for r in out] == ["a", "b", "c"]
    assert server.stats["dispatches"] == 1
    assert server.stats["filler_slots"] == 1
    for r, req in zip(out, reqs):
        assert r.labels.shape == (req.n,) and r.balanced


def test_warm_cache_semantics():
    server = _server()
    server.serve([_req("t", n=200, seed=1)])
    [resp] = server.serve([_req("t", n=210, seed=1)])     # n changed
    assert not resp.warm and server.stats["invalidations"] == 1
    assert server.serve([_req("t", n=210, seed=1)])[0].warm
    [resp] = server.serve([_req("t", n=210, k=8, seed=1)])  # k changed
    assert not resp.warm and server.stats["invalidations"] == 2
    lru = _server(cache_slots=2)
    lru.serve([_req("a"), _req("b")])
    assert lru.cached_tenants() == ["a", "b"]
    lru.serve([_req("a")])
    assert lru.cached_tenants() == ["b", "a"]
    lru.serve([_req("c")])
    assert lru.cached_tenants() == ["a", "c"] and lru.stats["evictions"] == 1
    cold = _server(cache_slots=0)
    cold.serve([_req("t")])
    assert not cold.serve([_req("t")])[0].warm
    assert cold.cached_tenants() == [] and cold.stats["warm_hits"] == 0


def test_request_stream_matches_reference():
    probs = [PartitionProblem(points=_pts(100 + i, i), k=4, seed=i)
             for i in range(3)]
    ref_probs = [RefProblem(points=p.points, k=4, seed=p.seed)
                 for p in probs]
    wl, ref_wl = meshes.DriftingHotspot(), ref_meshes.DriftingHotspot()
    for got, want in zip(request_stream(probs, wl, 3, device=CPU),
                         ref_request_stream(ref_probs, ref_wl, 3)):
        for g, r in zip(got, want):
            assert (g.tenant, g.k, g.seed, g.epsilon) == \
                (r.tenant, r.k, r.seed, r.epsilon)
            np.testing.assert_array_equal(g.points, r.points)
            np.testing.assert_allclose(g.weights, r.weights, rtol=2.4e-7)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PartitionServer(tiers=TIERS)
    probs = [PartitionProblem(points=_pts(50), k=2)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(request_stream(probs, meshes.DriftingHotspot(), 1))
