"""The model path's kernels on ``meta`` tensors: outputs of the kernel's
shapes and types with no launch, for the dry run (``launch/dryrun.py``).

A ``meta`` tensor has a shape, a type and no storage, and a CUDA kernel
cannot take it. So the flash and router wrappers hand a ``meta`` tensor,
and only a ``meta`` tensor, to the routes here. Each route allocates what
the kernel's wrapper allocates (the router's ``[T*E]`` float32 scratch
too, so that ``launch.live_mem`` sees it), and reports the kernel's
operations and bytes, by the formulas of the kernel table in
``chip_smoke.py``, to every ``kernel_costs()`` collector that is open.
Nothing is launched and no launch is counted; a CPU or CUDA tensor never
comes here.
"""
from __future__ import annotations

import contextlib

import torch

_COLLECTORS: list = []


@contextlib.contextmanager
def kernel_costs():
    """Collect the reports of the routes run inside the block: yields a
    list that fills with ``(kernel, flops, bytes, reads)``, ``reads`` the
    storage identities (``untyped_storage()._cdata``) of the tensors the
    kernel reads."""
    costs: list = []
    _COLLECTORS.append(costs)
    try:
        yield costs
    finally:
        _COLLECTORS.remove(costs)


def _report(name: str, flops: float, nbytes: float, *reads) -> None:
    keys = tuple(t.untyped_storage()._cdata for t in reads
                 if t is not None)
    for costs in _COLLECTORS:
        costs.append((name, float(flops), float(nbytes), keys))


def _require_meta(t) -> None:
    if t.device.type != "meta":
        raise ValueError(f"the meta route takes meta tensors, got "
                         f"{t.device}")


def flash_attention(name: str, q, k, v):
    """``[B, S, H, dh]`` in q's type, as the flash kernels return it.
    Causal attention: ``4 dh H S (S+1)/2 B`` operations; q, k, v read and
    the output written once."""
    _require_meta(q)
    B, S, H, dh = q.shape
    KV = k.shape[2]
    _report(name, 4 * dh * H * S * (S + 1) // 2 * B,
            q.element_size() * B * S * dh * (2 * H + 2 * KV), q, k, v)
    return torch.empty(B, S, H, dh, dtype=q.dtype, device=q.device)


def router_topk(x, centroids, scale, top_k: int):
    """``(idx [T, top_k] int32, eff [T, top_k] float32)``, and the
    ``[T*E]`` float32 scratch the kernel's wrapper allocates. ``2D+3``
    operations a (token, expert) pair; x, the centroids and a scale read
    once, idx and eff written once."""
    _require_meta(x)
    T, D = x.shape
    E = centroids.shape[0]
    idx = torch.empty(T, top_k, dtype=torch.int32, device=x.device)
    eff = torch.empty(T, top_k, dtype=torch.float32, device=x.device)
    scratch = torch.empty(max(T, 1) * E, dtype=torch.float32,
                          device=x.device)
    del scratch
    _report("router_topk", T * E * (2 * D + 3),
            x.element_size() * T * D + 4 * E * (D + 1) + 8 * T * top_k,
            x, centroids, scale)
    return idx, eff
