"""Hand-written CUDA causal flash attention (forward) and its plain
PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py``: the TPU kernel it
replaces is ``_flash_kernel`` (``flash_attention_pallas``). Two CUDA
sources take its calls on the card, by dtype: ``csrc/flash_attention_tc.cu``
(bfloat16, on the tensor cores: wgmma fed by TMA through a ring of K/V
slots) and ``csrc/flash_attention.cu`` (float32, on the CUDA cores, where
TF32 tensor cores would lose the float32 checks' 2e-5). Each header says
what bounds its kernel on the H100 and what the design does about it.

Contract: ``q [B, S, H, dh]``, ``k``/``v`` ``[B, S, KV, dh]`` with
``H % KV == 0`` (query head h reads key/value head ``h // (H / KV)``),
one type for all three (bfloat16 or float32), any strides with a
contiguous head dim: the model's layout is read as it is, with no
transposed copy. Returns ``[B, S, H, dh]`` in q's type: causal softmax
attention with scores ``(q.k) * dh^-0.5`` (tanh-capped when ``softcap``),
accumulated in float32 and rounded once. The bfloat16 kernel rounds the
softmax weights to bfloat16 before the PV product (as the model's own
dense path below ``FLASH_S_MIN`` does); the float32 kernel and the plain
version keep them in float32. The kernels take head dims ``HEAD_DIMS``
and raise ``UnsupportedHeadDimError`` for others; the plain version takes
any. Both kernels read 16 bytes at a time, so they also need
16-byte-aligned base pointers and batch/seq/head strides
(``check_kernel_inputs``).

Dispatch (``kernel_for``), by device and dtype alone: a CPU tensor goes to
the plain version; on the card a bfloat16 tensor to the tensor-core
kernel and a float32 tensor to the CUDA-core kernel. A tensor the chosen
kernel cannot take raises; nothing falls back to another kernel or to the
plain version. A ``meta`` tensor (the dry run's) takes the kernel's route
and its checks and, in place of the launch, ``meta.flash_attention``: an
output of the kernel's shape and type, the kernel's cost reported, nothing
counted. ``flash_attention_tc.launches`` and
``flash_attention_f32.launches`` count kernel launches,
``flash_attention_plain.calls`` plain calls.

Training goes through ``FlashAttentionFn``:
the same forward, and a backward that recomputes the attention of each
query chunk in plain PyTorch (no backward kernel: the TPU kernel has
none either).
"""
from __future__ import annotations

import torch

from . import meta

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 128, 256)


class UnsupportedHeadDimError(ValueError):
    """The CUDA kernel is built for the head dims ``HEAD_DIMS`` only."""


def _plain_chunk(qi, k, v, q0: int, softcap: float):
    """Float32 causal attention of the queries ``qi`` [B, C, H, dh] at
    positions ``q0 ..`` against ``k``/``v`` [B, T, KV, dh] (the keys up
    to the chunk's end): dense scores, masked at -1e30 above the
    diagonal, an exact softmax and the PV product. Returns float32
    [B, C, H, dh]."""
    B, C, H, dh = qi.shape
    KV = k.shape[2]
    qf = qi.float().reshape(B, C, KV, H // KV, dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, k.float()) * dh ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(q0, q0 + C, device=qi.device)
    kpos = torch.arange(k.shape[1], device=qi.device)
    s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p, v.float())
    return o.reshape(B, C, H, dh)


def flash_attention_plain(q, k, v, softcap: float = 0.0,
                          q_chunk: int = 512):
    """Plain version of ``flash_attention_cuda``: ``_plain_chunk`` for each
    chunk of ``q_chunk`` queries against the keys up to the chunk's end;
    the chunking bounds the score scratch and changes no row's
    arithmetic."""
    flash_attention_plain.calls += 1
    B, S, H, dh = q.shape
    out = torch.empty(B, S, H, dh, dtype=q.dtype, device=q.device)
    for q0 in range(0, S, q_chunk):
        q1 = min(q0 + q_chunk, S)
        out[:, q0:q1] = _plain_chunk(q[:, q0:q1], k[:, :q1], v[:, :q1], q0,
                                     softcap).to(q.dtype)
    return out


flash_attention_plain.calls = 0


def kernel_for(device_type: str, dtype: torch.dtype) -> str:
    """Which implementation takes a call: ``"plain"`` for a CPU tensor,
    ``"tensor_cores"`` for a bfloat16 and ``"cuda_cores"`` for a float32
    tensor on the card. Raises for another dtype on the card."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.bfloat16:
        return "tensor_cores"
    if dtype == torch.float32:
        return "cuda_cores"
    raise ValueError(f"flash_attention_cuda: q must be bfloat16 or float32, "
                     f"got {dtype}")


def tma_strides(t) -> tuple[int, int, int]:
    """Batch, seq and head strides (elements) of ``t [B, S, heads, dh]``
    as both kernels take them (the tensor-core kernel's tensor maps, the
    float32 kernel's loads): a dim of size 1 is never stepped over, so its
    stride is replaced by the packed one."""
    B, S, n, dh = t.shape
    sb, ss, sh = t.stride()[:3]
    sh = sh if n > 1 else dh
    ss = ss if S > 1 else n * sh
    sb = sb if B > 1 else S * ss
    return sb, ss, sh


def check_kernel_inputs(q, k, v) -> None:
    """Raise on what the CUDA kernel for q's dtype does not take."""
    B, S, H, dh = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, S) \
            or k.shape[3] != dh:
        raise ValueError(f"flash_attention_cuda: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    KV = k.shape[2]
    if H % KV != 0:
        raise ValueError(f"flash_attention_cuda: H={H} is not a multiple "
                         f"of KV={KV}")
    if dh not in HEAD_DIMS:
        raise UnsupportedHeadDimError(
            f"flash_attention_cuda: head dim {dh} is not one the kernel is "
            f"built for {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash_attention_cuda: q must be bfloat16 or "
                         f"float32, got {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_cuda: q, k and v must share "
                             "one type and one device")
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("flash_attention_cuda: the head dim must be "
                             "contiguous")
    # both kernels read from 16-byte boundaries in 16-byte steps: the
    # bfloat16 kernel's copy engine, the float32 kernel's vector loads
    width = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} does not start "
                             "on a 16-byte boundary")
        if any(st * width % 16 for st in tma_strides(t)):
            raise ValueError(
                f"flash_attention_cuda: {name}'s batch/seq/head strides "
                f"{tuple(t.stride()[:3])} are not multiples of 16 bytes")


def _launch(library, entry, q, k, v, softcap):
    from .build import load_library
    B, S, H, dh = q.shape
    out = torch.empty(B, S, H, dh, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in tma_strides(t)]
    strides += list(out.stride()[:3])
    load_library(library).call(
        entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
        S, H, k.shape[2], dh, *strides, dh ** -0.5, float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_attention_tc(q, k, v, softcap: float = 0.0):
    """The bfloat16 tensor-core kernel (``csrc/flash_attention_tc.cu``);
    the plain version for a CPU tensor, ``meta.flash_attention`` (no
    launch) for a ``meta`` one."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, softcap)
    check_kernel_inputs(q, k, v)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention_tc: takes bfloat16, got {q.dtype}")
    if q.device.type == "meta":
        return meta.flash_attention("flash_attention_tc", q, k, v)
    out = _launch("flash_attention_tc", "repro_flash_attention_tc_fwd", q, k,
                  v, softcap)
    flash_attention_tc.launches += 1
    return out


flash_attention_tc.launches = 0


def flash_attention_f32(q, k, v, softcap: float = 0.0):
    """The float32 CUDA-core kernel (``csrc/flash_attention.cu``); the
    plain version for a CPU tensor, ``meta.flash_attention`` (no launch)
    for a ``meta`` one."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, softcap)
    check_kernel_inputs(q, k, v)
    if q.dtype != torch.float32:
        raise ValueError(f"flash_attention_f32: takes float32, got {q.dtype}")
    if q.device.type == "meta":
        return meta.flash_attention("flash_attention", q, k, v)
    out = _launch("flash_attention", "repro_flash_attention_fwd", q, k, v,
                  softcap)
    flash_attention_f32.launches += 1
    return out


flash_attention_f32.launches = 0


def flash_attention_cuda(q, k, v, softcap: float = 0.0):
    """Causal attention in the ``[B, S, heads, dh]`` layout, dispatched by
    ``kernel_for``. Replaces ``flash_attention_pallas``."""
    route = kernel_for(q.device.type, q.dtype)
    if route == "plain":
        return flash_attention_plain(q, k, v, softcap)
    if route == "tensor_cores":
        return flash_attention_tc(q, k, v, softcap)
    return flash_attention_f32(q, k, v, softcap)


# queries a chunk of the backward's recompute: its float32 scores and
# softmax weights are [B, H, chunk, S] each (granite at S = 4096: 192 MB)
BACKWARD_CHUNK = 512


class FlashAttentionFn(torch.autograd.Function):
    """Causal flash attention with a gradient. Forward: the kernel of
    ``flash_attention_cuda`` on the card (the plain version on the CPU),
    saving only q, k and v. Backward: each chunk of ``BACKWARD_CHUNK``
    queries recomputed in plain float32 PyTorch (``_plain_chunk``) under
    autograd, its gradients taken there and summed into dk and dv: the
    reference's recipe, whose ``_flash_full`` checkpoints each chunk pair
    and recomputes it in the backward. No backward kernel exists (the TPU
    kernel has none). The recompute keeps the softmax weights in float32
    where the bfloat16 kernel rounds them to bfloat16 before the PV
    product, so the gradients are those of the float32 function at the
    bf16 inputs."""

    @staticmethod
    def forward(ctx, q, k, v, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.softcap = softcap
        return flash_attention_cuda(q, k, v, softcap)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        S = q.shape[1]
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for q0 in range(0, S, BACKWARD_CHUNK):
            q1 = min(q0 + BACKWARD_CHUNK, S)
            with torch.enable_grad():
                qi = q[:, q0:q1].detach().float().requires_grad_()
                ki = k[:, :q1].detach().float().requires_grad_()
                vi = v[:, :q1].detach().float().requires_grad_()
                o = _plain_chunk(qi, ki, vi, q0, ctx.softcap)
                gq, gk, gv = torch.autograd.grad(
                    o, (qi, ki, vi), grad_out[:, q0:q1].float())
            dq[:, q0:q1] = gq
            dk[:, :q1] += gk
            dv[:, :q1] += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None
