"""Gradients through the port's model path against ``jax.grad`` of the
JAX package's, on inputs and parameters made with seeded numpy (or the
reference's ``init_params``) and handed to both.

* every SMOKE config: ``loss_fn(forward(...))`` and its gradient with
  respect to every parameter, with the reference's parameters carried over
  by ``convert.params_from_numpy``;
* granite at S = 4096, where attention takes the flash path
  (``kernels.flash_attention.FlashAttentionFn``: the plain version
  forward on the CPU, the plain recompute backward) and the reference its
  chunked ``_flash_full``;
* the Mamba scan's out-of-place form (autograd refuses ``out=``), bit-equal
  in its forward to the serving form, and the Mamba and RWKV blocks'
  gradients (RWKV's scan is out of place already).

``FlashAttentionFn`` alone is held against ``_flash_full`` in
tests/test_torch_flash.py, and remat in tests/test_torch_train.py.

Tolerances: float32 losses within 1e-6 relative and gradients within 1e-4
relative and 1e-6 absolute (the same float32 functions; sums in other
orders); bfloat16 within the repo's 5e-2 for losses and elementwise, and
the whole gradient tree within 5e-2 in relative L2 norm (activations
rounded to bfloat16 at other places: a token routed to another expert
over a near-tie moves that expert's gradient as a whole).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.rules import resolve_rules
from repro.launch.mesh import make_host_mesh
from repro.models import model as RM
from repro.models import ssm as RSSM
from repro_torch import configs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import ssm as SSM
from repro_torch.optim.adamw import tree_leaves

from lm_train_cases import (GRANITE, batch_for, cfgs, influence,
                            port_loss_and_grad, ref_params)

torch.set_num_threads(1)

MESH = make_host_mesh()
F32 = dict(rtol=1e-4, atol=1e-6)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _ref_loss_and_grad(arch, rcfg, batch, infl, remat=False):
    """``jax.value_and_grad`` of the reference's loss, jitted; its layers
    unrolled (the same arithmetic: ``unroll`` only shapes the compiled
    program, which compiles twice as fast for jamba)."""
    rules = resolve_rules(MESH, rcfg, "train")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        logits, _, _ = RM.forward(p, jb, rcfg, rules, unroll=True,
                                  remat=remat, influence=infl)
        return RM.loss_fn(logits, jb["labels"], rcfg)

    return jax.jit(jax.value_and_grad(loss))(
        jax.tree.map(jnp.asarray, ref_params(arch)))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_grads(got, want, dtype, tol=None):
    """Leaf by leaf (sorted keys on both sides), then the whole tree."""
    num = den = 0.0
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(got)
    for (path, w), g in zip(paths, got):
        name = jax.tree_util.keystr(path)
        w, g = _np(w), _np(g)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, **(tol or (
            F32 if dtype == "float32" else BF16)), err_msg=name)
        num += float(np.sum((g.astype(np.float64) - w) ** 2))
        den += float(np.sum(w.astype(np.float64) ** 2))
    if dtype == "bfloat16":
        assert (num / den) ** 0.5 <= 5e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_forward_and_grad_match_reference(arch, dtype):
    """B=2, S=32 through ``loss_fn(forward(...))``; MoE configs with the
    router's influence state (ones) in both packages."""
    rcfg, pcfg = cfgs(arch, dtype)
    batch = batch_for(pcfg, 2, 32, 0)
    infl = influence(rcfg)
    wl, wg = _ref_loss_and_grad(arch, rcfg, batch, infl)
    gl, _, gg = port_loss_and_grad(arch, pcfg, batch, infl)
    np.testing.assert_allclose(float(gl.detach()), float(wl), **(
        dict(rtol=1e-6) if dtype == "float32" else BF16))
    _assert_grads(gg, wg, dtype)


def test_granite_grad_at_s4096_through_flash_matches_reference():
    """granite SMOKE at B=1, S=4096: attention through ``FlashAttentionFn``
    (a plain forward and a plain recompute backward on the CPU) against
    the reference's ``_flash_full`` under ``jax.grad``, with remat on
    both sides."""
    rcfg, pcfg = cfgs(GRANITE, "float32")
    batch = batch_for(pcfg, 1, 4096, 3)
    infl = influence(rcfg)
    wl, wg = _ref_loss_and_grad(GRANITE, rcfg, batch, infl, remat=True)
    ops.reset_launch_counts()
    gl, _, gg = port_loss_and_grad(GRANITE, pcfg, batch, infl, remat=True)
    counts = ops.launch_counts()
    # forward and the remat recompute, one plain call a layer each
    assert counts["flash_attention_plain"] == 2 * pcfg.n_layers
    assert counts["router_topk_plain"] == 2 * pcfg.n_layers
    np.testing.assert_allclose(float(gl.detach()), float(wl), rtol=1e-6)
    _assert_grads(gg, wg, "float32")


@pytest.mark.parametrize("C", [128, 100])
def test_mamba_grad_form_is_bit_equal_to_the_out_form(C):
    """``_ssm_chunk`` with inputs that require grad (out of place) and
    without (``out=`` into a pair of buffers): the same bits."""
    rng = np.random.default_rng(13)
    B, di, ds = 2, 128, 8
    h0 = torch.from_numpy(rng.standard_normal((B, di, ds)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.001, 0.1, (B, C, di))
                          .astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((B, C, ds))
                               .astype(np.float32)) for _ in range(2))
    x = torch.from_numpy(rng.standard_normal((B, C, di)).astype(np.float32))
    a = -torch.exp(torch.from_numpy(rng.standard_normal((di, ds))
                                    .astype(np.float32)))
    y0, h0_ = SSM._ssm_chunk(h0, dt, bm, x, cm, a)
    dtg = dt.clone().requires_grad_()
    y1, h1 = SSM._ssm_chunk(h0, dtg, bm, x, cm, a)
    assert y1.grad_fn is not None
    assert torch.equal(y0, y1.detach()) and torch.equal(h0_, h1.detach())
    (y1.sum() + h1.sum()).backward()
    assert torch.isfinite(dtg.grad).all()


def _ssm_params(fn, cfg, seed):
    """A block's parameters from its reference ``*_params`` function with
    seeded numpy leaves (the constant inits as the reference's)."""
    rng = np.random.default_rng(seed)
    fills = {"ones": 1.0, "zeros": 0.0, "half": 0.5, "ssm_dt": -4.6,
             "ssm_w0": -0.7}

    def create(shape, axes, scale, init="normal"):
        if init in fills:
            return np.full(shape, fills[init], np.float32)
        if init == "ssm_a":
            return np.broadcast_to(np.log(np.arange(1, shape[-1] + 1,
                                                    dtype=np.float32)),
                                   shape).copy()
        return (rng.standard_normal(shape) * (scale or 0.02)) \
            .astype(np.float32)

    return fn(cfg, create)


@pytest.mark.parametrize("block,S", [("mamba", 256), ("rwkv", 48)])
def test_ssm_block_grads_match_reference(block, S):
    """``mamba_apply`` (two 128-token chunks) and ``rwkv_time_mix`` (three
    16-token chunks: ``_rwkv_scan`` is out of place) in float32: the
    gradients of ``sum(out * w)`` with respect to x and every parameter
    against ``jax.grad`` of the reference's, within test_torch_ssm.py's
    float32 1e-4 (rtol and atol: a seeded cotangent makes gradients of
    order 1-10, and the doubling scan sums in another order)."""
    arch = "jamba_1p5_large_398b" if block == "mamba" else "rwkv6_3b"
    rcfg, pcfg = cfgs(arch, "float32")
    ref_fn = RSSM.mamba_apply if block == "mamba" else RSSM.rwkv_time_mix
    port_fn = SSM.mamba_apply if block == "mamba" else SSM.rwkv_time_mix
    pfn = RSSM.mamba_params if block == "mamba" else RSSM.rwkv_params
    params = _ssm_params(pfn, rcfg, 14)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, rcfg.d_model)).astype(np.float32)
    rules = resolve_rules(MESH, rcfg, "train")

    def ref(p, x_):
        out, _ = ref_fn(p, x_, rcfg, rules)
        return jnp.sum(out * w)

    wgrads = jax.grad(ref, argnums=(0, 1))(jax.tree.map(jnp.asarray, params),
                                           jnp.asarray(x))
    tp = params_from_numpy(params, "cpu")
    for t in tree_leaves(tp):
        t.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = port_fn(tp, tx, pcfg)
    torch.sum(out * torch.from_numpy(w)).backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tx.grad), _np(wgrads[1]), **tol)
    got = [t.grad for t in tree_leaves(tp)]
    _assert_grads(got, wgrads[0], "float32", tol)
