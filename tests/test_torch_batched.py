"""Batched, bucket and hierarchical solves of the port against the
reference, on the CPU.

Contracts:
- ``batched_balanced_kmeans`` equals ``sequential_balanced_kmeans`` bit
  for bit (labels, centers, influence, every stat);
- against the reference's vmap: per lane >= 0.99 label agreement (these
  instances agree on every label), equal ``iters``, ``final_imbalance``
  within 1e-6, and ``history`` of the same shape [B, max_iter] with the
  same values (rtol 1e-3, atol 1e-5, those of
  tests/test_torch_balanced_kmeans.py) up to the first movement
  iteration whose balance phase took another number of sweeps. Float32
  sums in another order than XLA's can put the imbalance on the other
  side of epsilon inside a balance phase: lane 1 of
  ``test_batched_matches_reference_vmap`` takes 9 sweeps in the port and
  10 in the reference at movement iteration 1, and the two trajectories
  part there, to end at the same labels and iteration count;
- ``_prep``'s default target is a true float32 division ``sum(w) / k``
  (the reference computes it outside jit), held bit for bit against the
  reference on sums that are exact in float32;
- ``bucket_balanced_kmeans`` stats equal the host metrics of each slot's
  real entries bit for bit; a filler lane equals solving it;
- ``build_refinement_batch`` and ``factor_k`` equal the reference's;
  ``partition(hierarchy=)``: >= 0.99 label agreement, the same
  per-block iterations, final imbalance within 1e-9; with host methods
  at both levels, equal labels;
- the reference's error paths raise the same exception types.
"""
import numpy as np
import pytest
import torch

from repro.core import meshes as ref_meshes
from repro.core.balanced_kmeans import BKMConfig as RefConfig
from repro.partition import PartitionProblem as RefProblem
from repro.partition import batched as ref_batched
from repro.partition import factor_k as ref_factor_k
from repro.partition import hierarchical_partition as ref_hierarchical
from repro.partition import partition as ref_partition
from repro_torch.core import metrics
from repro_torch.core.balanced_kmeans import BKMConfig, _f32_reciprocal
from repro_torch.core.sfc import sfc_initial_centers
from repro_torch.partition import (PartitionProblem,
                                   batched_balanced_kmeans,
                                   bucket_balanced_kmeans,
                                   build_refinement_batch, factor_k,
                                   hierarchical_partition, partition,
                                   sequential_balanced_kmeans)
from repro_torch.partition import batched as port_batched

torch.set_num_threads(1)

CPU = "cpu"


def _lanes(B=3, n=400, real=350, k=6, seed=0):
    """B lanes of n slots, the first ``real`` of each real (random
    weights), the rest zero-weight copies of real points."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (B, real, 2))[:, np.arange(n) % real]
    w = np.concatenate([1 + rng.random((B, real)), np.zeros((B, n - real))],
                       axis=1)
    c0 = np.stack([sfc_initial_centers(pts[b, :real], k) for b in range(B)])
    return pts, w, c0


def _equal_outputs(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert a[3].keys() == b[3].keys()
    for key, val in a[3].items():
        if isinstance(val, dict):
            for name in val:
                assert torch.equal(val[name], b[3][key][name]), (key, name)
        else:
            assert torch.equal(val, b[3][key]), key


def test_batched_equals_sequential_bit_for_bit():
    pts, w, c0 = _lanes()
    cfg = BKMConfig(k=6)
    for tw in (None, 120.0):
        _equal_outputs(
            batched_balanced_kmeans(pts, w, c0, cfg, tw, device=CPU),
            sequential_balanced_kmeans(pts, w, c0, cfg, tw, device=CPU))


def test_batched_matches_reference_vmap():
    pts, w, c0 = _lanes(seed=1)
    A, C, infl, st = batched_balanced_kmeans(pts, w, c0, BKMConfig(k=6),
                                             device=CPU)
    rA, rC, rinfl, rst = ref_batched.batched_balanced_kmeans(
        pts, w, c0, RefConfig(k=6))
    assert A.shape == tuple(rA.shape) and A.dtype == torch.int32
    assert C.shape == tuple(rC.shape) and infl.shape == tuple(rinfl.shape)
    assert sorted(st) == sorted(rst)
    for b in range(3):
        assert np.mean(A[b].numpy() == np.asarray(rA[b])) >= 0.99
    np.testing.assert_array_equal(st["iters"].numpy(),
                                  np.asarray(rst["iters"]))
    np.testing.assert_allclose(st["final_imbalance"].numpy(),
                               np.asarray(rst["final_imbalance"]), atol=1e-6)
    for name, val in rst["history"].items():
        assert tuple(st["history"][name].shape) == val.shape == (3, 30)
    parted = []
    for b in range(3):
        sweeps = (st["history"]["balance_iters"][b].numpy(),
                  np.asarray(rst["history"]["balance_iters"][b]))
        differ = np.flatnonzero(sweeps[0] != sweeps[1])
        upto = int(differ[0]) if len(differ) else 30
        if upto < 30:
            parted.append((b, upto))
        for name, val in rst["history"].items():
            np.testing.assert_allclose(
                st["history"][name][b, :upto].numpy(),
                np.asarray(val[b, :upto]), rtol=1e-3, atol=1e-5)
    assert parted == [(1, 1)]


def test_prep_target_is_a_true_division():
    """Integer weights make every sum exact, so only the last step can
    differ: ``sum / k`` divides (as the reference does outside jit), it
    does not multiply by ``_f32_reciprocal(k)``."""
    k = 3
    w = np.zeros((4, 64), np.float32)
    w[:, 0] = [5, 7, 11, 13]
    sums = w.sum(axis=1)
    divide = sums / np.float32(k)
    multiply = sums * np.float32(_f32_reciprocal(k))
    assert not np.array_equal(divide, multiply)     # the input tells
    pts = np.zeros((4, 64, 2))
    c0 = np.zeros((4, k, 2))
    ref = np.asarray(ref_batched._prep(pts, w, c0, RefConfig(k=k), None)[3])
    port = port_batched._prep(pts, w, c0, BKMConfig(k=k), None,
                              torch.device(CPU))[3].numpy()
    np.testing.assert_array_equal(ref, divide)
    np.testing.assert_array_equal(port, divide)
    tw = port_batched._prep(pts, w, c0, BKMConfig(k=k), 2.5,
                            torch.device(CPU))[3]
    assert tw.tolist() == [2.5] * 4


def test_bucket_stats_match_host_metrics_bit_for_bit():
    pts, w, c0 = _lanes(B=2, n=64, real=50, k=4, seed=2)
    cfg = BKMConfig(k=4)
    A, C, infl, stats = bucket_balanced_kmeans(
        pts, w, c0, cfg, counts=[50, 50], valid=[True, True], device=CPU)
    np.testing.assert_array_equal(stats["counts"], [50, 50])
    for s in range(2):
        assert stats["imbalance"][s] == metrics.imbalance(
            A[s, :50].numpy(), 4, w[s, :50])
    A2, _, _, st2 = bucket_balanced_kmeans(
        pts, w, C, cfg, counts=[50, 50], warm=True, influence0=infl,
        prev_assignment=A, device=CPU)
    for s in range(2):
        assert st2["migration_fraction"][s] == float(
            metrics.migration_fraction(A[s, :50].numpy(),
                                       A2[s, :50].numpy(), w[s, :50]))
    # the reference's in-graph float32 metric agrees within its tolerance
    rA, _, _, rst = ref_batched.bucket_balanced_kmeans(
        pts, w, c0, RefConfig(k=4), counts=[50, 50], valid=[True, True])
    np.testing.assert_array_equal(np.asarray(rA), A.numpy())
    np.testing.assert_allclose(stats["imbalance"], np.asarray(
        rst["imbalance"]), atol=1e-5)


def test_bucket_filler_lane_equals_its_solve():
    pts, w, c0 = _lanes(B=1, n=128, real=100, k=4, seed=3)
    pts, w, c0 = (np.concatenate([x, x]) for x in (pts, w, c0))
    cfg = BKMConfig(k=4)
    copied = bucket_balanced_kmeans(pts, w, c0, cfg, valid=[True, False],
                                    device=CPU)
    solved = bucket_balanced_kmeans(pts, w, c0, cfg, valid=[True, True],
                                    device=CPU)
    for x, y in zip(copied[:3], solved[:3]):
        assert torch.equal(x, y)
    for name in ("iters", "final_imbalance", "imbalance"):
        np.testing.assert_array_equal(np.asarray(copied[3][name]),
                                      np.asarray(solved[3][name]))


def test_padded_duplicates_take_their_source_label():
    pts, w, c0 = _lanes(B=2, n=300, real=120, k=5, seed=4)
    A = bucket_balanced_kmeans(pts, w, c0, BKMConfig(k=5), counts=[120, 120],
                               device=CPU)[0].numpy()
    src = np.arange(300) % 120
    np.testing.assert_array_equal(A, A[:, src])


@pytest.mark.parametrize("case", ["prev_missing", "warm_state_cold",
                                  "counts", "valid", "influence",
                                  "prev_shape"])
def test_bucket_error_paths_raise_the_reference_types(case):
    pts, w, c0 = _lanes(B=2, n=64, real=64, k=4, seed=5)
    calls = {
        "prev_missing": dict(warm=True),
        "warm_state_cold": dict(prev_assignment=np.zeros((2, 64), np.int32)),
        "counts": dict(counts=[64, 65]),
        "valid": dict(valid=[True]),
        "influence": dict(warm=True, influence0=np.ones((2, 3)),
                          prev_assignment=np.zeros((2, 64), np.int32)),
        "prev_shape": dict(warm=True,
                           prev_assignment=np.zeros((2, 63), np.int32)),
    }
    with pytest.raises(ValueError) as ref_err:
        ref_batched.bucket_balanced_kmeans(pts, w, c0, RefConfig(k=4),
                                           **calls[case])
    with pytest.raises(ValueError) as port_err:
        bucket_balanced_kmeans(pts, w, c0, BKMConfig(k=4), device=CPU,
                               **calls[case])
    assert str(port_err.value).split(",")[0] == \
        str(ref_err.value).split(",")[0]


def test_refinement_batch_and_factor_k_equal_reference():
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 1, (500, 3))
    labels = rng.integers(0, 7, 500)
    for weights in (None, rng.uniform(0.5, 2, 500)):
        for a, b in zip(build_refinement_batch(pts, weights, labels, 7),
                        ref_batched.build_refinement_batch(pts, weights,
                                                           labels, 7)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty coarse block"):
        build_refinement_batch(pts, None, labels, 8)
    for k in (1, 7, 12, 16, 64, 1024, 97):
        assert factor_k(k) == ref_factor_k(k)


@pytest.mark.parametrize("weighted", [False, True])
def test_hierarchical_matches_reference(weighted):
    m = ref_meshes.REGISTRY["delaunay2d"](3000, seed=1)
    w = np.random.default_rng(2).uniform(1, 2, 3000) if weighted else None
    ref = ref_partition(RefProblem(points=m.points, k=16, weights=w),
                        hierarchy=(4, 4))
    got = partition(PartitionProblem(points=m.points, k=16, weights=w),
                    hierarchy="4x4", device=CPU)
    assert np.mean(got.labels == ref.labels) >= 0.99
    assert got.method == ref.method
    assert got.stats["levels"][1]["iters"] == ref.stats["levels"][1]["iters"]
    assert got.stats["final_imbalance"] == pytest.approx(
        ref.stats["final_imbalance"], abs=1e-9)
    assert got.stats["levels"][0]["epsilon"] == 0.015
    assert set(ref.stats["levels"][1]) <= set(got.stats["levels"][1])
    assert got.centers.shape == (16, 2) and got.influence.shape == (16,)
    assert got.imbalance() <= 0.03 + 1e-6


def test_hierarchical_batched_equals_sequential_and_host_levels():
    prob = PartitionProblem(points=np.random.default_rng(3).uniform(
        0, 1, (2000, 3)), k=12)
    a = hierarchical_partition(prob, 3, 4, device=CPU)
    b = hierarchical_partition(prob, 3, 4, batched=False, device=CPU)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.centers, b.centers)
    assert b.stats["levels"][1]["dispatches"] == 3
    # host methods at both levels: equal labels
    ref = ref_partition(RefProblem(points=prob.points, k=12),
                        method="rcb", hierarchy=(3, 4), refine_method="rib")
    got = partition(prob, method="rcb", hierarchy=(3, 4),
                    refine_method="rib", device=CPU)
    np.testing.assert_array_equal(got.labels, ref.labels)
    # k2 == 1: the coarse cut at the full epsilon
    one = partition(prob, hierarchy=(12, 1), device=CPU)
    ref_one = ref_partition(RefProblem(points=prob.points, k=12),
                            hierarchy=(12, 1))
    assert one.stats["levels"][0]["epsilon"] == 0.03
    assert np.mean(one.labels == ref_one.labels) >= 0.99


@pytest.mark.parametrize("case", ["product", "tiny_block", "chunk",
                                  "bad_string"])
def test_hierarchical_error_paths_raise_the_reference_types(case):
    pts = np.random.default_rng(4).uniform(0, 1, (60, 2))
    calls = {"product": dict(hierarchy=(3, 4), k=16),
             "tiny_block": dict(hierarchy=(2, 30), k=60),
             "chunk": dict(hierarchy=(2, 2), k=4, chunk=8),
             "bad_string": dict(hierarchy="2x2x2", k=8)}
    kw = dict(calls[case])
    k = kw.pop("k")
    with pytest.raises(ValueError):
        ref_partition(RefProblem(points=pts, k=k), **kw)
    with pytest.raises(ValueError):
        partition(PartitionProblem(points=pts, k=k), device=CPU, **kw)


def test_hierarchical_unported_paths():
    """``devices=`` and the split lanes are ported (held in
    tests/test_torch_sharded.py); what they refuse, the reference refuses
    too."""
    prob = PartitionProblem(points=np.random.default_rng(5).uniform(
        0, 1, (200, 2)), k=4)
    rprob = RefProblem(points=prob.points, k=4)
    for hier in (hierarchical_partition, ref_hierarchical):
        p = prob if hier is hierarchical_partition else rprob
        kw = {"device": CPU} if hier is hierarchical_partition else {}
        with pytest.raises(ValueError, match="multi-device"):
            hier(p, 2, 2, method="rcb", devices=2, **kw)
        with pytest.raises(ValueError, match="chunk"):
            hier(p, 2, 2, chunk=8, **kw)
    with pytest.raises(ValueError, match="P1, P2"):
        port_batched.sharded_batched_balanced_kmeans(
            np.zeros((1, 8, 2)), None, np.zeros((1, 2, 2)), BKMConfig(k=2),
            devices=2, device=CPU)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, w, c0 = _lanes(B=1, n=32, real=32, k=2)
    prob = PartitionProblem(points=pts[0], k=4)
    for call in (lambda: batched_balanced_kmeans(pts, w, c0, BKMConfig(k=2)),
                 lambda: sequential_balanced_kmeans(pts, w, c0,
                                                    BKMConfig(k=2)),
                 lambda: bucket_balanced_kmeans(pts, w, c0, BKMConfig(k=2)),
                 lambda: hierarchical_partition(prob, 2, 2),
                 lambda: partition(prob, hierarchy=(2, 2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
