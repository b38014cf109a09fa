"""Causal flash attention: the port's ``ops.flash_attention`` (its plain
version on the CPU) against the JAX package's ``ops.flash_attention`` (the
Pallas kernel in interpret mode), and the port's ``attention`` against the
reference's across the ``FLASH_S_MIN`` switch, and the training path's
``FlashAttentionFn`` against ``jax.grad`` of the reference's
``_flash_full``. Inputs are made with numpy and handed to both.

Tolerances: 2e-5 in float32 and 2e-2 in bfloat16 for the kernel, the
reference's own (tests/test_kernels_flash_router.py): an exact softmax
against an online one over 128-key tiles differs in the last bits in
float32, and bfloat16 output rounds at 8 bits. The layer-level comparison
uses the LM parity tolerance of 1e-4 (tests/test_torch_lm.py): the
projections and RoPE around the attention add float32 rounding of their
own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist.rules import resolve_rules
from repro.kernels import ops as ref_ops
from repro.launch.mesh import make_host_mesh
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import granite_moe_3b_a800m as granite
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

# several pytest workers share a few cores: one intra-op thread each keeps
# these small-tensor tests from oversubscribing them
torch.set_num_threads(1)

MESH = make_host_mesh()



def _qkv(B, S, H, KV, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, dh)).astype(np.float32),
            rng.standard_normal((B, S, KV, dh)).astype(np.float32),
            rng.standard_normal((B, S, KV, dh)).astype(np.float32))


CASES = [
    (2, 256, 4, 4, 32, 128, 128, 0.0, "float32"),     # MHA
    (1, 512, 8, 2, 64, 256, 128, 0.0, "float32"),     # GQA 4:1
    (2, 384, 4, 1, 32, 128, 128, 0.0, "float32"),     # MQA + padding
    (1, 256, 4, 4, 128, 128, 128, 50.0, "float32"),   # softcap (gemma)
    (1, 256, 2, 2, 64, 128, 128, 0.0, "bfloat16"),    # bf16 io
    (1, 300, 3, 1, 16, 128, 128, 0.0, "float32"),     # odd S, odd heads
    (1, 256, 4, 4, 96, 128, 128, 0.0, "float32"),     # dh 96 (phi3), MHA
    (1, 300, 6, 2, 96, 128, 128, 0.0, "float32"),     # dh 96, GQA, ragged
    (2, 200, 4, 4, 96, 128, 128, 30.0, "float32"),    # dh 96, softcap
    (1, 300, 6, 2, 96, 128, 128, 0.0, "bfloat16"),    # dh 96 bf16 io
]


@pytest.mark.parametrize("B,S,H,KV,dh,bq,bk,softcap,dtype", CASES)
def test_flash_matches_reference(B, S, H, KV, dh, bq, bk, softcap, dtype):
    q, k, v = _qkv(B, S, H, KV, dh)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_ops.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                   jnp.asarray(v, jdt), bq=bq, bk=bk,
                                   softcap=softcap)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, bq=bq, bk=bk, softcap=softcap)
    assert got.shape == (B, S, H, dh) and got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    # and against the port's dense oracle in the [BH, S, dh] layout
    oracle = ref.flash_attention_ref(
        tq.transpose(1, 2).reshape(B * H, S, dh),
        tk.transpose(1, 2).reshape(B * KV, S, dh),
        tv.transpose(1, 2).reshape(B * KV, S, dh), softcap=softcap)
    oracle = oracle.reshape(B, H, S, dh).transpose(1, 2)
    np.testing.assert_allclose(got.float().numpy(), oracle.float().numpy(),
                               rtol=tol, atol=tol)


def test_plain_version_reads_strided_layout():
    """The kernel's contract reads q/k/v through strides: a non-contiguous
    view (heads split out of a fused projection) gives the contiguous
    result, and the query chunk changes no row."""
    q, k, v = _qkv(1, 200, 6, 2, 16, seed=3)
    fused = torch.from_numpy(np.concatenate(
        [q, k, v], axis=2)).contiguous()           # [1, 200, 10, 16]
    tq, tk, tv = fused[:, :, :6], fused[:, :, 6:8], fused[:, :, 8:]
    assert not tq.is_contiguous()
    fa.check_kernel_inputs(tq, tk, tv)
    a = fa.flash_attention_plain(tq, tk, tv, q_chunk=64)
    b = fa.flash_attention_plain(tq.contiguous(), tk.contiguous(),
                                 tv.contiguous(), q_chunk=512)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("dh", [8, 48, 512])
def test_kernel_refuses_head_dims_it_is_not_built_for(dh):
    q, k, v = (torch.zeros(1, 64, 2, dh) for _ in range(3))
    with pytest.raises(fa.UnsupportedHeadDimError, match="head dim"):
        fa.check_kernel_inputs(q, k, v)
    for good in fa.HEAD_DIMS:
        t = torch.zeros(1, 64, 2, good)
        fa.check_kernel_inputs(t, t, t)


def test_kernel_input_checks():
    q = torch.zeros(1, 64, 6, 16)
    kv = torch.zeros(1, 64, 4, 16)
    with pytest.raises(ValueError, match="multiple"):
        fa.check_kernel_inputs(q, kv, kv)
    with pytest.raises(ValueError, match="one type"):
        fa.check_kernel_inputs(q.bfloat16(), torch.zeros(1, 64, 2, 16),
                               torch.zeros(1, 64, 2, 16))


def test_cpu_tensor_takes_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 2, 16))
    ops.reset_launch_counts()
    ops.flash_attention(q, k, v)
    fa.flash_attention_cuda(q, k, v)
    fa.flash_attention_f32(q, k, v)
    fa.flash_attention_tc(q.bfloat16(), k.bfloat16(), v.bfloat16())
    counts = ops.launch_counts()
    assert counts["flash_attention_plain"] == 4
    assert counts["flash_attention"] == counts["flash_attention_tc"] == 0


@pytest.mark.parametrize("device,dtype,route", [
    ("cpu", torch.bfloat16, "plain"),
    ("cpu", torch.float32, "plain"),
    ("cpu", torch.float16, "plain"),
    ("cuda", torch.bfloat16, "tensor_cores"),
    ("cuda", torch.float32, "cuda_cores"),
])
def test_dispatch_by_device_and_dtype(device, dtype, route):
    """On the card the dtype alone picks the kernel: bfloat16 the
    tensor-core kernel, float32 the CUDA-core kernel."""
    assert fa.kernel_for(device, dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_dispatch_refuses_other_types_on_the_card(dtype):
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.kernel_for("cuda", dtype)


def _fused(dtype, width, offset=0):
    """q/k/v as views of one fused [1, 64, width] projection (heads split
    out of it), starting ``offset`` elements in."""
    buf = torch.zeros(1, 64, width + offset, dtype=dtype)[:, :, offset:]
    qkv = buf[:, :, :10 * 16].unflatten(2, (10, 16))
    return qkv[:, :, :6], qkv[:, :, 6:8], qkv[:, :, 8:]


def test_bf16_kernel_takes_aligned_strided_views():
    """The model's fused-projection views: 16-byte bases and strides."""
    q, k, v = _fused(torch.bfloat16, 160)
    assert not q.is_contiguous()
    fa.check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("width,offset,match", [
    (164, 0, "multiples of 16 bytes"),     # seq stride 164 elements
    (160, 4, "16-byte boundary"),          # base 8 bytes past a boundary
])
def test_bf16_kernel_refuses_misaligned_inputs(width, offset, match):
    """The tensor-core kernel's copy engine reads from 16-byte boundaries
    in 16-byte steps: a bf16 view that breaks either raises, while the
    float32 kernel takes the same layout (a seq stride of 164 floats is
    656 bytes, a multiple of 16)."""
    q, k, v = _fused(torch.bfloat16, width, offset)
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_inputs(q, k, v)
    if offset == 0:
        fa.check_kernel_inputs(*_fused(torch.float32, width))


@pytest.mark.parametrize("width", [160, 164, 168])
def test_f32_kernel_takes_aligned_strided_views(width):
    """The float32 kernel's 16-byte loads: fused-projection views whose
    base and batch/seq/head strides are multiples of 16 bytes pass."""
    q, k, v = _fused(torch.float32, width)
    assert not q.is_contiguous()
    fa.check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("width,offset,match", [
    (162, 0, "multiples of 16 bytes"),     # seq stride 648 bytes
    (166, 0, "multiples of 16 bytes"),     # seq stride 664 bytes
    (160, 2, "16-byte boundary"),          # base 8 bytes past a boundary
    (160, 1, "16-byte boundary"),          # base 4 bytes past a boundary
])
def test_f32_kernel_refuses_misaligned_inputs(width, offset, match):
    """The float32 kernel reads q, k and v 16 bytes at a time from 16-byte
    boundaries: a float32 view that breaks either raises (nothing falls
    back), in the same words as the bf16 rule."""
    q, k, v = _fused(torch.float32, width, offset)
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_inputs(q, k, v)


def test_f32_kernel_refuses_a_misaligned_head_stride():
    """A head stride of 18 floats (72 bytes): each head's row starts off a
    16-byte boundary."""
    buf = torch.zeros(1, 64, 4 * 18)
    q = buf.unflatten(2, (4, 18))[..., :16]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.check_kernel_inputs(q, q, q)


def test_tma_strides_ignore_size_one_dims():
    """A size-1 batch, sequence or head dim is never stepped over, so its
    stride (whatever view made it) is replaced by the packed one."""
    t = torch.zeros(1, 64, 1, 16, dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 16), (3, 16, 5, 1))
    assert fa.tma_strides(t) == (64 * 16, 16, 16)
    fa.check_kernel_inputs(torch.zeros(1, 64, 2, 16, dtype=torch.bfloat16),
                           t, t)


@pytest.mark.parametrize("S", [48, 64, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_reference_across_flash_switch(monkeypatch, S,
                                                         dtype):
    """granite SMOKE attention, full causal with the prefill cache: below
    FLASH_S_MIN the dense path in both packages, at and above it the
    reference's _flash_full against the port's ops.flash_attention. Both
    modules get FLASH_S_MIN = 64 and 32-token chunks, as
    tests/test_flash_path.py shrinks the reference's."""
    for mod in (RL, L):
        monkeypatch.setattr(mod, "FLASH_S_MIN", 64)
        monkeypatch.setattr(mod, "_QC", 32)
        monkeypatch.setattr(mod, "_KVC", 32)
    import dataclasses
    import jax
    rcfg = dataclasses.replace(ref_configs.get_config(
        "granite_moe_3b_a800m", smoke=True), dtype=dtype)
    pcfg = dataclasses.replace(granite.SMOKE, dtype=dtype)
    rules = resolve_rules(MESH, rcfg, "decode")
    rp = RM.init_params(rcfg, jax.random.PRNGKey(1))["layers"]["pos0"][
        "attn"]
    rp = {kk: vv[0] for kk, vv in rp.items()}
    pp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    x = np.random.default_rng(S).standard_normal(
        (2, S, rcfg.d_model)).astype(np.float32)
    want, wc = RL.attention(rp, jnp.asarray(x, getattr(jnp, dtype)), rcfg,
                            rules, want_cache=True)
    ops.reset_launch_counts()
    got, gc = L.attention(pp, torch.from_numpy(x).to(getattr(torch, dtype)),
                          pcfg, want_cache=True)
    flash = ops.launch_counts()["flash_attention_plain"]
    assert flash == (1 if S >= 64 else 0)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    for kk in ("k", "v"):
        np.testing.assert_allclose(gc[kk].float().numpy(),
                                   np.asarray(wc[kk], np.float32),
                                   rtol=tol, atol=tol)

# FlashAttentionFn (training): gradients against jax.grad of the
# reference's _flash_full. Float32 within 1e-4 relative and 1e-5 absolute
# (outputs and gradients of order 1; the backward recomputes each
# 512-query chunk with an exact softmax where the reference differentiates
# its online one over 2048-key chunks); bfloat16 within 5e-2. On the card
# the bf16 kernel rounds the softmax weights to bfloat16 before the PV
# product and the recompute does not: the gradients are those of the
# float32 function at the bf16 inputs, held there against autograd
# through the plain version within 2e-2 of each row's largest value
# (chip_smoke.py's train phase).
GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
            "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


FLASH_CASES = {
    # (S, H, KV, dh, softcap, dtype)
    "mha": (640, 4, 4, 16, 0.0, "float32"),
    "gqa-softcap30": (640, 4, 2, 16, 30.0, "float32"),
    "mqa-4096": (4096, 4, 1, 16, 0.0, "float32"),
    "gqa-softcap30-bf16": (640, 6, 2, 32, 30.0, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_function_matches_reference_grad(case):
    """``ops.flash_attention`` with inputs that require grad (so through
    ``FlashAttentionFn``) against ``_flash_full`` under ``jax.grad``: the
    output and dq, dk, dv of ``sum(out * w)`` for a seeded cotangent w.
    S = 640 is ragged against the backward's 512-query chunks (and one
    chunk in the reference); S = 4096 takes the reference's 2048 chunks."""
    S, H, KV, dh, cap, dtype = FLASH_CASES[case]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, S, n, dh)).astype(np.float32)
               for n in (H, KV, KV))
    w = rng.standard_normal((1, S, H, dh)).astype(np.float32)
    rcfg = dataclasses.replace(ref_configs.get_config(
        "granite_moe_3b_a800m", smoke=True), n_heads=H, n_kv_heads=KV, head_dim=dh,
                               logit_softcap=cap or None, dtype=dtype)
    rules = resolve_rules(MESH, rcfg, "train")
    jdt = jnp.dtype(dtype)

    def ref(q_, k_, v_):
        out = RL._flash_full(q_, k_, v_, rcfg, rules)
        return jnp.sum(out.astype(jnp.float32) * w), out

    (_, wout), wgrads = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(t).to(tdt).requires_grad_()
                  for t in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, softcap=cap)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    torch.sum(out.float() * torch.from_numpy(w)).backward()
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(wout), **tol)
    for name, g, want in zip("qkv", (tq.grad, tk.grad, tv.grad), wgrads):
        assert g.dtype == tdt
        np.testing.assert_allclose(_f32(g), _f32(want), **tol,
                                   err_msg=f"d{name}")


def test_flash_takes_the_function_only_with_gradients():
    """Without an input that requires grad, or under no_grad, the plain
    path (no autograd node) as before; with one, the Function: one counted
    plain call forward, none in its backward."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, n, 16))
                                .astype(np.float32)) for n in (4, 2, 2))
    assert ops.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention_plain"] == 1
    assert torch.equal(out.detach(), fa.flash_attention_plain(q.detach(), k,
                                                              v))
    out.sum().backward()
    assert ops.launch_counts()["flash_attention_plain"] == 2   # the check
    assert k.grad is None and q.grad.shape == q.shape
