"""The MoE router: the port's ``ops.router_topk`` (its plain version on the
CPU) against the JAX package's ``ops.router_topk`` (the Pallas kernel in
interpret mode), the nearest-expert property, and the agreement with the
model's ``router_logits`` + top-k. Inputs are made with numpy and handed
to both.

Tolerance: eff rtol/atol 1e-4, the reference's own
(tests/test_kernels_flash_router.py): float32 dot products summed in
another order; indices may differ only where the effective distances tie
within that tolerance (the reference's rule). Both packages' indices are
held against a float64 dense oracle of all [T, E] distances
(``ref.router_topk_disagreements``): distinct experts, each named expert's
distance, the stable order except at a tie.

The divide form (the model path) is held to the reference model's
``router_logits`` + ``jax.lax.top_k`` bit for bit, on integer-valued
inputs whose dot products are exact on every backend, with influences
planted so that the multiply form ranks two experts the other way
(``ref.router_near_tie_case``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.models import moe as RMOE
from repro.models.config import MoEConfig as RMoEConfig
from repro_torch.kernels import moe_router_kernel as mr
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (router_near_tie_case,
                                     router_topk_disagreements)
from repro_torch.models import moe as MOE
from repro_torch.models.config import MoEConfig

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)



def _inputs(T, E, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((E, D)).astype(np.float32),
            rng.uniform(0.5, 2.0, (E,)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _full64(x, c, inv2):
    """[T, E] effective squared distances in float64."""
    x, c = x.astype(np.float64), c.astype(np.float64)
    sq = (x * x).sum(1)[:, None] + (c * c).sum(1)[None] - 2.0 * x @ c.T
    return torch.from_numpy(np.maximum(sq, 0.0) * inv2.astype(np.float64))


def _assert_topk_close(idx, eff, ridx, reff, full):
    """The port's result and the reference's agree in eff, and each names
    the K nearest experts of the float64 oracle ``full`` in its stable
    order, so their indices differ only where distances tie."""
    np.testing.assert_allclose(eff, reff, **TOL)
    for name, i, e in (("port", idx, eff), ("reference", ridx, reff)):
        faults = router_topk_disagreements(
            torch.from_numpy(np.array(i)), torch.from_numpy(np.array(e)),
            full, **TOL)
        assert not faults, f"{name}: {faults}"


@pytest.mark.parametrize("T,E,D,K,bt", [
    (512, 8, 64, 1, 256),         # llama4-style top-1
    (512, 16, 64, 2, 128),        # jamba top-2
    (512, 40, 32, 8, 256),        # granite top-8, E off the tiles
    (300, 128, 128, 2, 128),      # ragged T
    (512, 200, 64, 4, 128),       # E > 128
    (300, 256, 32, 8, 128),       # ragged T, deep top-k
    (256, 384, 16, 2, 256),       # 3 TPU expert tiles, 6 CUDA ones
])
def test_router_matches_reference(T, E, D, K, bt):
    x, c, infl = _inputs(T, E, D)
    ridx, reff = ref_ops.router_topk(jnp.asarray(x), jnp.asarray(c),
                                     jnp.asarray(infl), top_k=K, bt=bt)
    idx, eff = ops.router_topk(*_t(x, c, infl), top_k=K, bt=bt)
    assert idx.dtype == torch.int32 and eff.dtype == torch.float32
    assert idx.shape == eff.shape == (T, K)
    _assert_topk_close(idx.numpy(), eff.numpy(), np.asarray(ridx),
                       np.asarray(reff), _full64(x, c, 1.0 / (infl * infl)))
    # ascending along k, distinct valid experts per token
    e = eff.numpy()
    assert (np.diff(e, axis=1) >= 0).all()
    i = idx.numpy()
    assert ((i >= 0) & (i < E)).all()
    assert all(len(set(row.tolist())) == K for row in i)


def test_router_uniform_influence_is_nearest_expert():
    x, c, _ = _inputs(256, 16, 32, seed=3)
    idx, _ = ops.router_topk(*_t(x, c), torch.ones(16), top_k=1)
    d = np.sum((x[:, None].astype(np.float64) - c[None]) ** 2, -1)
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.argmin(d, 1))


def test_ties_keep_the_lower_expert_first():
    """Duplicated centroids give exactly equal effective distances: the
    lower expert index comes first, as in jax.lax.top_k."""
    x, c, _ = _inputs(64, 6, 8, seed=4)
    c = np.concatenate([c, c])                    # expert e == e + 6
    idx, eff = ops.router_topk(*_t(x, c), torch.ones(12), top_k=4)
    i, e = idx.numpy(), eff.numpy()
    for row_i, row_e in zip(i, e):
        for a in range(3):
            if row_e[a] == row_e[a + 1]:
                assert row_i[a] < row_i[a + 1]
    assert (i[:, 0] < 6).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_equals_router_logits_topk_at_unit_influence(dtype):
    """With influence 1 (the serving paths) the kernel's multiply by
    1/influence^2 is the model's divide by influence^2: the port's
    router_topk equals its router_logits + a stable top-k bit for bit, and
    the reference's router_logits + lax.top_k within the tolerance."""
    x, c, _ = _inputs(300, 40, 48, seed=5)
    tx = torch.from_numpy(x).to(dtype)
    m = MoEConfig(n_experts=40, top_k=8, d_ff=16, router="balanced_kmeans")
    ones = torch.ones(40)
    logits = MOE.router_logits({"centroids": torch.from_numpy(c)}, tx, m,
                               ones)
    gates, want_idx = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
    idx, eff = ops.router_topk(tx, torch.from_numpy(c), ones, top_k=8)
    assert torch.equal(idx.long(), want_idx[:, :8])
    assert torch.equal(-eff, gates[:, :8])
    import jax
    rm = RMoEConfig(n_experts=40, top_k=8, d_ff=16, router="balanced_kmeans")
    rl = RMOE.router_logits({"centroids": jnp.asarray(c)},
                            jnp.asarray(tx.float().numpy()), rm,
                            jnp.ones(40))
    rg, ri = jax.lax.top_k(rl, 8)
    _assert_topk_close(idx.numpy(), eff.numpy(), np.asarray(ri),
                       -np.asarray(rg),
                       _full64(tx.float().numpy(), c, np.ones(40)))


def test_multiply_by_inv2_is_not_the_models_divide():
    """The hazard the training slice must handle: away from influence 1,
    max(sq, 0) * (1/influence^2) and max(sq, 0) / influence^2 round
    differently in the last bit, so the kernel equals the model's
    router_logits within 3e-7 relative (about 2 ulp), not bit for bit."""
    x, c, infl = _inputs(512, 40, 48, seed=6)
    m = MoEConfig(n_experts=40, top_k=8, d_ff=16, router="balanced_kmeans")
    logits = MOE.router_logits({"centroids": torch.from_numpy(c)},
                               torch.from_numpy(x), m,
                               torch.from_numpy(infl))
    idx, eff = ops.router_topk(*_t(x, c, infl), top_k=40)
    div = -torch.gather(logits, 1, idx.long())
    assert not torch.equal(eff, div)
    torch.testing.assert_close(eff, div, rtol=3e-7, atol=0.0)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("K", [2, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_divide_form_is_the_reference_models_routing_at_near_ties(K, dtype):
    """At adapted influence with planted near-ties the divide form picks
    the reference model's experts and gates (router_logits + lax.top_k)
    bit for bit; the multiply form (ops.router_topk) ranks every planted
    pair the other way: another expert at top_k = 2, another order
    above."""
    import jax
    x, c, infl = router_near_tie_case(24, 40, 48, seed=8)
    rm = RMoEConfig(n_experts=40, top_k=K, d_ff=16, router="balanced_kmeans")
    rl = RMOE.router_logits({"centroids": jnp.asarray(c)}, jnp.asarray(x),
                            rm, jnp.asarray(infl))
    rg, ri = jax.lax.top_k(rl, K)
    tx = torch.from_numpy(x).to(dtype)       # small integers: exact in bf16
    idx, eff = ops.router_topk_divide(tx, torch.from_numpy(c),
                                      torch.from_numpy(infl), top_k=K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(_bits(-eff.numpy()), _bits(rg))
    midx, _ = ops.router_topk(tx, torch.from_numpy(c),
                              torch.from_numpy(infl), top_k=K)
    assert (midx.numpy()[:, 1] != np.asarray(ri)[:, 1]).all()
    assert (np.sort(midx.numpy(), 1) == np.sort(np.asarray(ri), 1)).all() \
        == (K > 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_form_equals_multiply_and_divide_at_influence_one(dtype):
    """No influence (the serving paths) routes unscaled: the same bits as
    multiplying by 1 / 1^2 and dividing by 1^2."""
    x, c, _ = _inputs(300, 40, 48, seed=9)
    tx, tc, ones = torch.from_numpy(x).to(dtype), torch.from_numpy(c), \
        torch.ones(40)
    ui, ue = ops.router_topk_divide(tx, tc, None, top_k=8)
    for oi, oe in (ops.router_topk_divide(tx, tc, ones, top_k=8),
                   ops.router_topk(tx, tc, ones, top_k=8)):
        assert torch.equal(ui, oi)
        assert torch.equal(ue, oe)


def test_kernel_input_checks():
    x = torch.zeros(8, 16)
    c = torch.zeros(64, 16)
    inv2 = torch.ones(64)
    mr._check_inputs(x, c, inv2, top_k=4)
    mr._check_inputs(x, torch.zeros(40, 16), torch.ones(40), top_k=8)
    mr._check_inputs(x, c, None, top_k=4)               # the unit form
    with pytest.raises(ValueError, match="do not match"):
        mr._check_inputs(x, c, torch.ones(40), top_k=4)
    with pytest.raises(ValueError, match="top_k"):
        mr._check_inputs(x, c, inv2, top_k=mr.KMAX + 1)
    with pytest.raises(ValueError, match="top_k"):
        mr._check_inputs(x, torch.zeros(6, 16), torch.ones(6), top_k=8)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        mr._check_inputs(x.half(), c, inv2, top_k=4)


def test_cpu_tensor_takes_the_plain_version_and_padding_is_never_chosen():
    x, c, infl = _inputs(100, 40, 16, seed=7)
    ops.reset_launch_counts()
    idx, _ = ops.router_topk(*_t(x, c, infl), top_k=8)
    counts = ops.launch_counts()
    assert counts["router_topk_plain"] == 1 and counts["router_topk"] == 0
    assert (idx.numpy() < 40).all()
    ops.router_topk_divide(*_t(x, c, infl), top_k=8)
    ops.router_topk_divide(*_t(x, c), None, top_k=8)
    counts = ops.launch_counts()
    assert counts["router_topk_plain"] == 3 and counts["router_topk"] == 0

