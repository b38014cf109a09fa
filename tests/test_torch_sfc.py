"""Hilbert keys and the SFC bootstrap: the port's torch version (the one
the partitioner runs on the card) against the reference's numpy version.
Contract: exact equality of keys, orders and initial centers."""
import numpy as np
import pytest
import torch

from repro.core import sfc as ref_sfc
from repro_torch.core import sfc

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)


def _points(kind, n, d, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3.0, 5.0, (n, d))
    if kind == "duplicates":
        pts[n // 2:] = pts[: n - n // 2]          # every point twice
    elif kind == "flat_axis":
        pts[:, -1] = 0.25                         # zero-span axis
    elif kind == "grid":
        pts = np.floor(pts)                       # many exact ties
    return pts


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("kind", ["uniform", "duplicates", "flat_axis",
                                  "grid"])
def test_keys_equal_numpy_reference(d, kind):
    pts = _points(kind, 3000, d, seed=d * 7 + len(kind))
    want = ref_sfc.hilbert_index_np(pts)
    got = sfc.hilbert_index_torch(torch.from_numpy(pts))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    np.testing.assert_array_equal(sfc.hilbert_index_np(pts), want)


@pytest.mark.parametrize("d,bits", [(2, 5), (3, 4), (3, 21), (2, 31)])
def test_keys_equal_at_explicit_bits(d, bits):
    pts = _points("uniform", 500, d, seed=bits)
    np.testing.assert_array_equal(
        sfc.hilbert_index_torch(torch.from_numpy(pts), bits).numpy()
        .astype(np.uint64), ref_sfc.hilbert_index_np(pts, bits))


@pytest.mark.parametrize("d", [2, 3])
def test_order_is_the_stable_order(d):
    pts = _points("duplicates", 2000, d, seed=11)
    want = ref_sfc.sfc_order(pts)
    np.testing.assert_array_equal(
        sfc.sfc_order_torch(torch.from_numpy(pts)).numpy(), want)
    np.testing.assert_array_equal(sfc.sfc_order(pts), want)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_initial_centers_equal(d, weighted, k):
    pts = _points("grid", 1500, d, seed=k + d)
    w = (np.random.default_rng(k).lognormal(0.0, 1.0, 1500) if weighted
         else None)
    want = ref_sfc.sfc_initial_centers(pts, k, w)
    got = sfc.sfc_initial_centers_torch(torch.from_numpy(pts), k, w)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sfc.sfc_initial_centers(pts, k, w), want)


def test_too_many_bits_raise():
    with pytest.raises(ValueError, match="64-bit key"):
        sfc.hilbert_index_torch(torch.zeros(4, 3, dtype=torch.float64), 22)


@pytest.mark.parametrize("n,sigma", [(1, 0.5), (2049, 2.0), (300_000, 0.5)])
def test_prefix_sum_adds_in_index_order(n, sigma):
    """The weighted picks' prefix sum equals numpy's cumsum bit for bit
    (the kernel adds in index order; on the CPU the plain version runs)."""
    from repro_torch.kernels import ops, scan
    w = np.random.default_rng(n).lognormal(0.0, sigma, n)
    ops.reset_launch_counts()
    got = scan.prefix_sum(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.cumsum(w))
    counts = ops.launch_counts()
    assert counts["prefix_sum_plain"] == 1 and counts["prefix_sum"] == 0


def test_prefix_sum_takes_only_1d_float64():
    from repro_torch.kernels import scan
    with pytest.raises(ValueError, match="1-D float64"):
        scan.prefix_sum(torch.ones(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="1-D float64"):
        scan.prefix_sum(torch.ones(2, 2, dtype=torch.float64))


@pytest.mark.parametrize("n,k", [(1, 1), (1000, 7), (5000, 1024),
                                 (200_000, 64)])
@pytest.mark.parametrize("weighted", [False, True])
def test_picks_on_the_device_equal_numpy(n, k, weighted):
    """The strided and weighted picks the bootstrap runs on the device
    equal the host version's, with k = 1 and heavy-tailed weights."""
    rng = np.random.default_rng(n + k)
    w = rng.lognormal(0.0, 2.0, n) if weighted else None
    got = sfc._picks_torch(n, k, None if w is None else torch.from_numpy(w),
                           torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), sfc._picks(n, k, w))
