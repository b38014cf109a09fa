"""Hand-written CUDA causal flash attention (forward) and its plain
PyTorch version.

Counterpart of ``repro/kernels/flash_attention.py``: the TPU kernel it
replaces is ``_flash_kernel`` (``flash_attention_pallas``). The CUDA source
is ``csrc/flash_attention.cu``; its header says what bounds the kernel on
the H100 and what the design does about it.

Contract: ``q [B, S, H, dh]``, ``k``/``v`` ``[B, S, KV, dh]`` with
``H % KV == 0`` (query head h reads key/value head ``h // (H / KV)``),
one type for all three (bfloat16 or float32), any strides with a
contiguous head dim: the model's layout is read as it is, with no
transposed copy. Returns ``[B, S, H, dh]`` in q's type: causal softmax
attention with scores ``(q.k) * dh^-0.5`` (tanh-capped when ``softcap``),
computed in float32 and rounded once. The kernel takes head dims
``HEAD_DIMS`` and raises ``UnsupportedHeadDimError`` for others; the plain
version takes any.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel, with no fallback. ``flash_attention_cuda.launches`` counts kernel
launches and ``flash_attention_plain.calls`` plain calls.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)


class UnsupportedHeadDimError(ValueError):
    """The CUDA kernel is built for the head dims ``HEAD_DIMS`` only."""


def flash_attention_plain(q, k, v, softcap: float = 0.0,
                          q_chunk: int = 512):
    """Plain version of ``flash_attention_cuda``: for each chunk of
    ``q_chunk`` queries, the dense float32 scores against the keys up to
    the chunk's end, masked at -1e30 above the diagonal, an exact softmax
    and the PV product; the chunking bounds the score scratch and changes
    no row's arithmetic."""
    flash_attention_plain.calls += 1
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty(B, S, H, dh, dtype=q.dtype, device=q.device)
    for q0 in range(0, S, q_chunk):
        q1 = min(q0 + q_chunk, S)
        qi = q[:, q0:q1].float().reshape(B, q1 - q0, KV, G, dh)
        s = torch.einsum("bqkgd,btkd->bkgqt", qi, kf[:, :q1]) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(q0, q1, device=q.device)
        kpos = torch.arange(q1, device=q.device)
        s = torch.where(kpos[None, :] <= qpos[:, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,btkd->bqkgd", p, vf[:, :q1])
        out[:, q0:q1] = o.reshape(B, q1 - q0, H, dh).to(q.dtype)
    return out


flash_attention_plain.calls = 0


def check_kernel_inputs(q, k, v) -> None:
    """Raise on what the CUDA kernel does not take."""
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


def flash_attention_cuda(q, k, v, softcap: float = 0.0):
    """Causal attention in the ``[B, S, heads, dh]`` layout. Replaces
    ``flash_attention_pallas``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, softcap)
    from .build import load_library
    check_kernel_inputs(q, k, v)
    B, S, H, dh = q.shape
    out = torch.empty(B, S, H, dh, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    load_library("flash_attention").call(
        "repro_flash_attention_fwd", q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16), B, S,
        H, k.shape[2], dh, *strides, dh ** -0.5, float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
