"""Balanced k-means: the port's core against the reference's, on the CPU,
from identical inputs (numpy, handed to both).

Contracts: the influence updates within float32 rounding (rtol 1e-6);
the warm-up sample sizes exactly equal to the reference's float32
arithmetic under jit; a whole solve from the same ``centers0`` with the
same movement-iteration count, ``final_imbalance`` within 1e-4 and at
least 99% label agreement (float32 sums are taken in another order, so
the solves agree to rounding, not bitwise).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import balanced_kmeans as ref_bkm
from repro_torch import convert
from repro_torch.core import balanced_kmeans as bkm

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)


@pytest.mark.parametrize("k", [1, 9])
def test_assign_effective_matches(k):
    """True effective distances; with k == 1 the second bound falls back
    to the best one instead of +inf."""
    rng = np.random.default_rng(k)
    pts = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    ctr = rng.uniform(0, 1, (k, 3)).astype(np.float32)
    infl = rng.uniform(0.5, 2.0, k).astype(np.float32)
    want = ref_bkm.assign_effective(jnp.asarray(pts), jnp.asarray(ctr),
                                    jnp.asarray(infl), backend="jnp")
    for backend in ("torch", "cuda", "cuda_flat"):
        got = bkm.assign_effective(torch.from_numpy(pts),
                                   torch.from_numpy(ctr),
                                   torch.from_numpy(infl), backend=backend)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for a, b in zip(got[1:], want[1:]):
            assert torch.isfinite(a).all()
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


def test_adapt_influence_matches():
    rng = np.random.default_rng(0)
    infl = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    sizes = rng.uniform(0.0, 300.0, 64).astype(np.float32)
    sizes[:3] = 0.0
    for d_eff in (2, 3):
        want = ref_bkm.adapt_influence(jnp.asarray(infl), jnp.asarray(sizes),
                                       jnp.float32(120.0), d_eff, 0.05)
        got = bkm.adapt_influence(torch.from_numpy(infl),
                                  torch.from_numpy(sizes),
                                  torch.tensor(120.0), d_eff, 0.05)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_erode_influence_matches():
    rng = np.random.default_rng(1)
    infl = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    delta = rng.uniform(0.0, 0.2, 64).astype(np.float32)
    for beta in (0.0, 0.05, 1.0):
        want = ref_bkm.erode_influence(jnp.asarray(infl), jnp.asarray(delta),
                                       jnp.float32(beta))
        got = bkm.erode_influence(torch.from_numpy(infl),
                                  torch.from_numpy(delta),
                                  torch.tensor(beta))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("n", [999, 1500, 131072, 1000003, 4194304,
                               5000001])
def test_warmup_sample_sizes_equal_reference(n):
    """The reference computes the sample size in float32 inside jit,
    where XLA divides by the constant n as a multiply by its float32
    reciprocal (balanced_kmeans.py:342-343, the same expression)."""
    start = 100
    ref = jax.jit(lambda it: jnp.ceil(
        jnp.minimum((start * 2.0 ** it) / n, 1.0) * n).astype(jnp.int32))
    n_warm = int(np.ceil(np.log2(max(n / start, 1))))
    for it in range(n_warm + 2):
        assert bkm.warmup_sample_size(it, n, n, start) == int(
            ref(jnp.int32(it)))


def _solve_both(pts, k, weights=None, backend="torch", **cfg_kw):
    """Reference and port from the same config, points and centers0."""
    ref_cfg = ref_bkm.BKMConfig(k=k, **cfg_kw)
    fields = dataclasses.asdict(ref_cfg)
    fields["dtype"] = "float32"
    fields["backend"] = {"torch": "jnp", "cuda": "pallas",
                         "cuda_flat": "triton"}[backend]
    cfg = convert.bkm_config_from_reference(fields)
    assert cfg.backend == backend
    c0 = pts[np.linspace(0, len(pts) - 1, k).astype(np.int32)]
    w_j = None if weights is None else jnp.asarray(weights)
    w_t = None if weights is None else torch.from_numpy(weights)
    A0, C0, I0, st0 = ref_bkm.balanced_kmeans_jit(
        jnp.asarray(pts), ref_cfg, w_j, jnp.asarray(c0))
    c0_t, _ = convert.state_from_numpy(c0, None, "cpu")
    A1, C1, I1, st1 = bkm.balanced_kmeans(torch.from_numpy(pts), cfg, w_t,
                                          c0_t)
    return (np.asarray(A0), np.asarray(C0), np.asarray(I0), st0), \
        (A1.numpy(), C1.numpy(), I1.numpy(), st1)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_flat"])
@pytest.mark.parametrize("n,k,d,weighted", [(2000, 8, 2, False),
                                            (3000, 12, 3, False),
                                            (2500, 6, 2, True)])
def test_balanced_kmeans_matches_reference(backend, n, k, d, weighted):
    rng = np.random.default_rng(n + k)
    pts = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    w = (rng.lognormal(0.0, 0.5, n).astype(np.float32) if weighted
         else None)
    (A0, C0, I0, st0), (A1, C1, I1, st1) = _solve_both(pts, k, w, backend,
                                                       block_p=256)
    assert int(st1["iters"]) == int(st0["iters"])
    assert abs(float(st1["final_imbalance"])
               - float(st0["final_imbalance"])) <= 1e-4
    assert np.mean(A1 == A0) >= 0.99
    np.testing.assert_allclose(C1, C0, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(I1, I0, rtol=1e-3)
    for key in ("balance_iters", "imbalance", "max_delta"):
        np.testing.assert_allclose(st1["history"][key].numpy(),
                                   np.asarray(st0["history"][key]),
                                   rtol=1e-3, atol=1e-5)
    assert float(st1["tiles_pruned_frac"]) == pytest.approx(
        float(st0["tiles_pruned_frac"]), abs=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_unfused_path_is_bit_identical_on_torch_backend(fused):
    """fused=False takes the argmin sweep + segment_moments; on the dense
    backend both share one reduction order, so the solves are equal."""
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.uniform(0, 1, (1500, 2)).astype(np.float32))
    base = bkm.balanced_kmeans(pts, bkm.BKMConfig(k=6, backend="torch"))
    other = bkm.balanced_kmeans(pts, bkm.BKMConfig(k=6, backend="torch",
                                                   fused=fused))
    np.testing.assert_array_equal(base[0].numpy(), other[0].numpy())
    np.testing.assert_array_equal(base[1].numpy(), other[1].numpy())


def test_warm_repartition_and_noop_detection_match_reference():
    """Warm start from a finished solve (``geographer_repartition``): the
    reference's pre-pass finds a fixed point or, with the previous labels,
    a no-op that re-emits them; so must the port."""
    from repro.core import partitioner as ref_part
    from repro_torch.core import partitioner
    rng = np.random.default_rng(9)
    pts = rng.uniform(0, 1, (2000, 2))
    labels, C, I, _ = ref_part.geographer_partition(pts, 8, seed=3,
                                                    return_state=True)
    for prev in (None, labels):
        want = ref_part.geographer_repartition(pts, 8, C, I, seed=3,
                                               prev_labels=prev)
        got = partitioner.geographer_repartition(pts, 8, C, I, seed=3,
                                                 prev_labels=prev,
                                                 device="cpu")
        assert int(got[3]["iters"]) == int(want[3]["iters"])
        assert np.mean(got[0] == want[0]) >= 0.99
        if prev is not None:
            assert int(got[3]["iters"]) == 0
            np.testing.assert_array_equal(got[0], labels)


def test_config_validation_and_conversion():
    with pytest.raises(ValueError, match="max_balance_iter"):
        bkm.BKMConfig(k=2, max_balance_iter=0)
    with pytest.raises(ValueError, match="assign_precision"):
        bkm.BKMConfig(k=2, assign_precision="fp8")
    cfg = convert.bkm_config_from_reference(
        {"k": 4, "backend": "jnp", "use_kernel": True, "dtype": "float32"})
    assert cfg.backend == "cuda" and cfg.dtype == torch.float32
    assert convert.bkm_config_from_reference(
        {"k": 4, "backend": "triton"}).backend == "cuda_flat"
    with pytest.raises(KeyError, match="no counterpart"):
        convert.bkm_config_from_reference({"k": 4, "backend": "mosaic"})
