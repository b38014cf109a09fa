"""The port's assignment sweep on the CPU (the plain versions behind the
CUDA wrappers, and the dense ``torch`` backend) against the reference:
``assign_argmin_jnp``, the Pallas kernels in interpret mode, the sorted
wrapper ``ops.assign_argmin``, ``segment_moments`` and
``tile_prune_fraction``. Inputs are made with numpy and handed to both.

Tolerances (those of tests/test_kernels.py): best/second rtol 1e-4, atol
1e-5; moments rtol 1e-4, atol 1e-4; labels equal (f32 sums in another
order can only flip exact near-ties, which these inputs do not have);
bf16 labels flip only at near-ties, under 5% at the reference test's
shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import assign_kernel as ref_ak
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import triton_assign as ref_ta
from repro_torch.kernels import assign_kernel as ak
from repro_torch.kernels import ops, ref
from repro_torch.kernels import triton_assign as ta

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)

BEST = dict(rtol=1e-4, atol=1e-5)
MOM = dict(rtol=1e-4, atol=1e-4)


def _rand(n, k, d, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, spread, (n, d)).astype(np.float32)
    ctr = rng.uniform(0, spread, (k, d)).astype(np.float32)
    infl = rng.uniform(0.5, 2.0, (k,)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    return pts, ctr, infl, w


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _kernel_inputs(pts, ctr, infl, w, bp, bc, sort=True):
    """Padded kernel inputs in numpy, as both wrappers build them."""
    n, d = pts.shape
    k = ctr.shape[0]
    inv2 = (1.0 / (infl * infl)).astype(np.float32)
    order = np.arange(k)
    if sort:
        lo, hi = pts.min(0), pts.max(0)
        gap = np.maximum(np.maximum(lo[None] - ctr, ctr - hi[None]), 0)
        order = np.argsort((gap * gap).sum(1) * inv2, kind="stable")
    pn, pk = (-n) % bp, (-k) % bc
    p = np.concatenate([pts, np.zeros((pn, d), np.float32)])
    c = np.concatenate([ctr[order], np.full((pk, d), 1e30, np.float32)])
    iv = np.concatenate([inv2[order], np.ones(pk, np.float32)])
    ww = np.concatenate([w, np.zeros(pn, np.float32)])
    return p, c, iv, ww


def _assert_triple(got, want, labels="equal"):
    gi, gb, gs = (np.asarray(x) for x in got[:3])
    wi, wb, ws = (np.asarray(x) for x in want[:3])
    if labels == "equal":
        np.testing.assert_array_equal(gi, wi)
    else:
        assert np.mean(gi == wi) >= labels
    np.testing.assert_allclose(gb, wb, **BEST)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    np.testing.assert_allclose(gs[fin], ws[fin], **BEST)


# shapes: multi-tile, ragged on both axes, center tiles of 128, high d
SHAPES = [(1024, 64, 2, 256, 32), (777, 33, 2, 256, 32),
          (512, 200, 3, 256, 128), (256, 8, 16, 128, 8)]


@pytest.mark.parametrize("n,k,d,bp,bc", SHAPES)
def test_sorted_kernel_plain_matches_pallas(n, k, d, bp, bc):
    pts, ctr, infl, w = _rand(n, k, d, seed=n + k)
    p, c, iv, ww = _kernel_inputs(pts, ctr, infl, w, bp, bc)
    bounds = ref_ops._tile_bounds(*_j(p, c, iv), bp, bc)
    want = ref_ak.assign_reduce_pallas(*_j(p, c, iv), bounds, jnp.asarray(ww),
                                       k_real=k, block_p=bp, block_c=bc,
                                       interpret=True)
    got = ak.assign_reduce_cuda(*_t(p, c, iv, ww), k, block_p=bp,
                                block_c=bc)
    _assert_triple(got, want)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **MOM)
    want_a = ref_ak.assign_argmin_pallas(*_j(p, c, iv), bounds, k_real=k,
                                         block_p=bp, block_c=bc,
                                         interpret=True)
    got_a = ak.assign_argmin_cuda(*_t(p, c, iv), k, block_p=bp, block_c=bc)
    _assert_triple(got_a, want_a)
    # fused and argmin-only give the same triple
    for a, b in zip(got_a, got[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,k,d,bp,bc", [(1024, 64, 2, 256, 128),
                                         (777, 33, 3, 256, 128)])
def test_flat_kernel_plain_matches_triton_shaped_pallas(n, k, d, bp, bc):
    pts, ctr, infl, w = _rand(n, k, d, seed=3 * n + k)
    p, c, iv, ww = _kernel_inputs(pts, ctr, infl, w, bp, bc, sort=False)
    want = ref_ta.triton_assign_reduce_pallas(
        *_j(p, c, iv, ww), k_real=k, block_p=bp, block_c=bc,
        interpret=True)
    got = ta.triton_assign_reduce_cuda(*_t(p, c, iv, ww), k, block_p=bp,
                                       block_c=bc)
    _assert_triple(got, want)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **MOM)
    want_a = ref_ta.triton_assign_pallas(*_j(p, c, iv), k_real=k,
                                         block_p=bp, block_c=bc,
                                         interpret=True)
    _assert_triple(ta.triton_assign_cuda(*_t(p, c, iv), k, block_p=bp,
                                         block_c=bc), want_a)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_flat"])
@pytest.mark.parametrize("n,k,d", [(2000, 9, 2), (1024, 200, 3),
                                   (300, 1, 2), (5000, 37, 3)])
def test_backends_match_jnp(backend, n, k, d):
    """Every registered backend, end to end through its registry adapter
    (sort, padding, un-sort), against the reference's dense backend."""
    pts, ctr, infl, w = _rand(n, k, d, seed=17 + n)
    want = ref_ops.assign_argmin_jnp(*_j(pts, ctr, infl),
                                     weights=jnp.asarray(w),
                                     return_moments=True)
    fn = ops.assign_backend(backend)
    got = fn(*_t(pts, ctr, infl), weights=torch.from_numpy(w),
             return_moments=True)
    _assert_triple(got, want)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MOM)
    plain = fn(*_t(pts, ctr, infl))
    for a, b in zip(plain, got[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,k,d,bp,bc", [(1024, 64, 2, 256, 32),
                                         (777, 33, 3, 256, 32)])
def test_sorted_wrapper_matches_reference_wrapper(n, k, d, bp, bc):
    """``ops.assign_argmin``: center sort, ``_FAR`` padding and the
    un-sort of labels and moments, against the reference's wrapper."""
    pts, ctr, infl, w = _rand(n, k, d, seed=5 * n)
    want = ref_ops.assign_argmin(*_j(pts, ctr, infl), block_p=bp,
                                 block_c=bc, weights=jnp.asarray(w),
                                 return_moments=True)
    got = ops.assign_argmin(*_t(pts, ctr, infl), block_p=bp, block_c=bc,
                            weights=torch.from_numpy(w),
                            return_moments=True)
    _assert_triple(got, want)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MOM)
    _assert_triple(ops.assign_argmin(*_t(pts, ctr, infl), block_p=bp,
                                     block_c=bc),
                   ref_ops.assign_argmin(*_j(pts, ctr, infl), block_p=bp,
                                         block_c=bc))


@pytest.mark.parametrize("n,k,bc", [(256, 3, 8), (512, 9, 8), (300, 1, 128)])
def test_far_coordinates_never_corrupt(n, k, bc):
    """1e9-scale coordinates: the padded _FAR rows overflow in the
    expansion; the plain version never computes them. As in the
    reference test: labels equal, no NaN, best within rtol 1e-2 (the
    expansion cancels catastrophically at this scale)."""
    rng = np.random.default_rng(5)
    pts = (rng.uniform(0, 1, (n, 2)) * 1e9).astype(np.float32)
    ctr = (rng.uniform(0, 1, (k, 2)) * 1e9).astype(np.float32)
    infl = np.ones(k, np.float32)
    want = ref_ops.assign_argmin_jnp(*_j(pts, ctr, infl))
    for backend in ("cuda", "cuda_flat"):
        got = ops.assign_backend(backend)(*_t(pts, ctr, infl), block_p=256,
                                          block_c=bc)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert not torch.isnan(got[1]).any()
        assert not torch.isnan(got[2]).any()
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-2)


def test_k1_second_is_exact_inf():
    pts, _, _, w = _rand(256, 1, 2, seed=11)
    ctr = np.asarray([[0.4, 0.6]], np.float32)
    infl = np.ones(1, np.float32)
    want = ref_ops.assign_argmin_jnp(*_j(pts, ctr, infl))
    for backend in ("torch", "cuda", "cuda_flat"):
        i, b, s = ops.assign_backend(backend)(*_t(pts, ctr, infl),
                                              block_p=256, block_c=8)
        assert (i == 0).all() and torch.isinf(s).all()
        np.testing.assert_allclose(b.numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_flat"])
def test_zero_weight_padding_adds_nothing(backend):
    pts, ctr, infl, _ = _rand(400, 5, 2, seed=19)
    w = np.r_[np.ones(300), np.zeros(100)].astype(np.float32)
    fn = ops.assign_backend(backend)
    full = fn(*_t(pts, ctr, infl), weights=torch.from_numpy(w),
              return_moments=True, block_p=256, block_c=128)
    part = fn(*_t(pts[:300], ctr, infl), weights=torch.from_numpy(w[:300]),
              return_moments=True, block_p=256, block_c=128)
    for a, b in zip(full[3:], part[3:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "cuda", "cuda_flat"])
def test_bf16_within_reference_bounds(backend):
    """tests/test_kernels.py::test_bf16_precision_within_tolerance on the
    port: at its shape, bf16 labels flip only where the f32 best/second
    gap is within 2^-6, and on fewer than 5% of the points; and the port's
    bf16 labels agree with the reference's bf16 labels."""
    pts, ctr, infl, _ = _rand(2048, 32, 3, seed=29)
    fn = ops.assign_backend(backend)
    i32, b32, s32 = fn(*_t(pts, ctr, infl), block_p=256, block_c=32)
    i16, b16, _ = fn(*_t(pts, ctr, infl), block_p=256, block_c=32,
                     precision="bf16")
    flipped = (i16 != i32).numpy()
    np.testing.assert_allclose(b16.numpy()[~flipped], b32.numpy()[~flipped],
                               rtol=1e-2, atol=2e-2)
    if flipped.any():
        assert float((s32 - b32).numpy()[flipped].max()) <= 2.0 ** -6
    assert float(np.mean(flipped)) < 0.05
    want = ref_ops.assign_argmin_jnp(*_j(pts, ctr, infl), precision="bf16")
    assert np.mean(i16.numpy() == np.asarray(want[0])) >= 0.99


@pytest.mark.parametrize("n,chunk", [(500, 65536), (5000, 1024)])
def test_segment_moments_match_reference(n, chunk):
    pts, ctr, infl, w = _rand(n, 7, 2, seed=13)
    idx, best, _ = ops.assign_argmin_torch(*_t(pts, ctr, infl), chunk=chunk)
    want = ref_ops.segment_moments(*_j(pts, w, idx.numpy(), best.numpy()),
                                   7, chunk=chunk)
    got = ops.segment_moments(*_t(pts, w), idx, best, 7, chunk=chunk)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MOM)
    # and bit-equal to the dense backend's fused moments (one sum order)
    fused = ops.assign_argmin_torch(*_t(pts, ctr, infl), chunk=chunk,
                                    weights=torch.from_numpy(w),
                                    return_moments=True)
    for a, b in zip(fused[3:], got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("k,bc", [(4, 1), (64, 8), (1, 128)])
def test_tile_prune_fraction_matches_reference(k, bc):
    rng = np.random.default_rng(41)
    xs = np.linspace(0.0, 30.0, max(k, 2))
    pts = np.concatenate([rng.normal([x, 0.0], 0.05, (256, 2))
                          for x in xs]).astype(np.float32)
    ctr = np.asarray([[x, 0.0] for x in xs[:k]], np.float32)
    infl = np.ones(k, np.float32)
    _, _, s = ops.assign_argmin_torch(*_t(pts, ctr, infl))
    want = ref_ops.tile_prune_fraction(*_j(pts, ctr, infl, s.numpy()),
                                       block_p=256, block_c=bc)
    got = ops.tile_prune_fraction(*_t(pts, ctr, infl), s, block_p=256,
                                  block_c=bc)
    assert float(got) == float(want)
    bounds = ops._tile_bounds(*_t(pts[:512], np.pad(ctr, ((0, (-k) % bc),
                                                          (0, 0))),
                                  np.ones(k + (-k) % bc, np.float32)),
                              256, bc)
    np.testing.assert_allclose(
        bounds.numpy(),
        np.asarray(ref_ops._tile_bounds(*_j(
            pts[:512], np.pad(ctr, ((0, (-k) % bc), (0, 0))),
            np.ones(k + (-k) % bc, np.float32)), 256, bc)), rtol=1e-6)


def test_oracles_match_reference_oracles():
    pts, ctr, infl, w = _rand(600, 23, 3, seed=2)
    _assert_triple(ref.assign_argmin_ref(*_t(pts, ctr, infl)),
                   ref_ref.assign_argmin_ref(*_j(pts, ctr, infl)))
    idx = np.random.default_rng(3).integers(0, 23, 600).astype(np.int32)
    got = ref.center_update_ref(*_t(pts, w, idx), 23)
    want = ref_ref.center_update_ref(*_j(pts, w, idx), 23)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_registry_and_auto_resolution(monkeypatch):
    assert set(ops.available_assign_backends()) == {
        "torch", "cuda", "cuda_flat", "auto"}
    monkeypatch.delenv(ops.ENV_BACKEND, raising=False)
    assert ops.resolve_assign_backend("auto", "cpu") == "torch"
    assert ops.resolve_assign_backend("auto", "cuda") == "cuda"
    for name in ("torch", "cuda", "cuda_flat"):
        assert ops.backend_supports_moments(name)
    monkeypatch.setenv(ops.ENV_BACKEND, "cuda_flat")
    assert ops.resolve_assign_backend("auto", "cpu") == "cuda_flat"
    assert ops.resolve_assign_backend("torch", "cpu") == "torch"
    monkeypatch.setenv(ops.ENV_BACKEND, "nope")
    with pytest.raises(KeyError, match=ops.ENV_BACKEND):
        ops.resolve_assign_backend("auto", "cpu")
    with pytest.raises(KeyError, match="unknown assign backend"):
        ops.resolve_assign_backend("pallas", "cpu")


def test_kernel_entry_checks_tiling_and_counts():
    pts, ctr, infl, w = _rand(1000, 8, 2, seed=23)
    inv2 = 1.0 / (infl * infl)
    with pytest.raises(ValueError, match=r"n=1000.*block_p=256"):
        ak.assign_argmin_cuda(*_t(pts, ctr, inv2), 8, block_p=256,
                              block_c=8)
    with pytest.raises(ValueError, match=r"k=8.*block_c=128"):
        ta.triton_assign_reduce_cuda(*_t(pts[:768], ctr, inv2, w[:768]), 8,
                                     block_p=256, block_c=128)
    ops.reset_launch_counts()
    ak.assign_reduce_cuda(*_t(pts[:768], ctr, inv2, w[:768]), 8,
                          block_p=256, block_c=8)
    counts = ops.launch_counts()
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert counts["assign_reduce_plain"] == 1
    assert counts["assign_reduce"] == 0
    assert ak.points_per_thread(1024) == 4
    assert ak.points_per_thread(256) == 1


def test_kernel_libraries_are_named():
    from repro_torch.kernels import build
    assert build.LIBRARIES == ("assign", "scan", "router", "flash_attention",
                               "flash_attention_tc")
    for name in build.LIBRARIES:
        assert (build.CSRC / f"{name}.cu").is_file()
    with pytest.raises(KeyError, match="unknown kernel libraries"):
        build.build_libraries(("nope",))
