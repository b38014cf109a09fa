"""Assignment-backend registry, the dense PyTorch backend, the wrapper of
the sorted CUDA kernel, and the wrappers of the language-model kernels
(``flash_attention``, ``router_topk``). Counterpart of
``repro/kernels/ops.py``.

Every backend has the same contract::

    fn(points [n,d], centers [k,d], influence [k], *,
       chunk, block_p, block_c, precision)
        -> (idx [n] int32, best_eff_sq [n], second_eff_sq [n])

Backends registered with ``supports_moments=True`` also take
``weights=[n], return_moments=True`` and then return
``(idx, best, second, csum [k,d], cw [k], rad2 [k])`` from the same pass
over the points. Every backend takes ``layout=`` (None by default); those
registered with ``supports_layout=True`` use it, and the solver builds one
(``point_layout(points, block_p)``, once per solve) only for them: the
kernel then reads the points in Hilbert order, where it can skip most
centers, while weights and results stay in the caller's order.

Registered backends:

* ``torch``     — chunked dense matmul, the CPU path (reference: ``jnp``);
* ``cuda``      — the hand-written CUDA sweep with centers sorted by
                  distance to the point bbox (reference: ``pallas``);
* ``cuda_flat`` — the same kernel in original center order with 256-point
                  tiles (reference: ``triton``);
* ``auto``      — ``$REPRO_TORCH_ASSIGN_BACKEND`` if set, else ``cuda``
                  for CUDA tensors and ``torch`` for CPU tensors.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .assign_kernel import assign_argmin_cuda, assign_reduce_cuda

_FAR = 1e30   # padded-center coordinate; the kernel never reads these rows
ENV_BACKEND = "REPRO_TORCH_ASSIGN_BACKEND"


def default_chunk(k: int) -> int:
    """Point-axis chunk of the dense backend when ``chunk=None``: a
    [chunk, k] float32 scratch of about 2 MB, clamped to [2048, 65536].
    Per-point results do not depend on the chunk."""
    return max(2048, min(65536, (1 << 19) // max(k, 1)))


# ---------------------------------------------------------------------------
# assignment-backend registry
# ---------------------------------------------------------------------------

_ASSIGN_BACKENDS: dict = {}
_ASSIGN_MOMENTS: set = set()   # backends accepting return_moments=True
_ASSIGN_LAYOUT: set = set()    # backends that use a layout


def register_assign_backend(name: str, *, supports_moments: bool = False,
                            supports_layout: bool = False):
    """Decorator: register an effective-distance assignment backend.
    ``supports_moments=True`` declares the fused assign+reduce contract,
    ``supports_layout=True`` that the backend uses ``layout=`` (every
    backend accepts it)."""
    def deco(fn):
        _ASSIGN_BACKENDS[name] = fn
        if supports_moments:
            _ASSIGN_MOMENTS.add(name)
        if supports_layout:
            _ASSIGN_LAYOUT.add(name)
        return fn
    return deco


def available_assign_backends() -> list[str]:
    return sorted(_ASSIGN_BACKENDS) + ["auto"]


def resolve_assign_backend(name: str = "auto",
                           device: torch.device | str | None = None) -> str:
    """Map ``auto`` to a concrete backend for tensors on ``device``.

    Order for ``auto``: the ``REPRO_TORCH_ASSIGN_BACKEND`` override (read
    per call; it never overrides an explicit name), then ``cuda`` on a
    CUDA device and ``torch`` anywhere else."""
    if name == "auto":
        env = os.environ.get(ENV_BACKEND)
        if env:
            if env not in _ASSIGN_BACKENDS:
                raise KeyError(
                    f"{ENV_BACKEND}={env!r} is not a registered assign "
                    f"backend; available: {available_assign_backends()}")
            return env
        dev = torch.device(device) if device is not None else None
        return "cuda" if dev is not None and dev.type == "cuda" else "torch"
    if name not in _ASSIGN_BACKENDS:
        raise KeyError(f"unknown assign backend {name!r}; "
                       f"available: {available_assign_backends()}")
    return name


def assign_backend(name: str = "auto", device=None):
    """The assignment callable for ``name`` (resolving ``auto``)."""
    return _ASSIGN_BACKENDS[resolve_assign_backend(name, device)]


def backend_supports_moments(name: str = "auto", device=None) -> bool:
    """True when ``name`` (resolved) implements fused assign+reduce."""
    return resolve_assign_backend(name, device) in _ASSIGN_MOMENTS


def backend_supports_layout(name: str = "auto", device=None) -> bool:
    """True when ``name`` (resolved) uses a ``point_layout``."""
    return resolve_assign_backend(name, device) in _ASSIGN_LAYOUT


# ---------------------------------------------------------------------------
# dense backend
# ---------------------------------------------------------------------------

def _chunk_assign(p, cn, centers, inv2, precision: str = "f32"):
    """One dense chunk of the effective-distance argmin. Returns (idx,
    best, second, onehot); ``onehot`` [C, k] marks each point's center.
    ``bf16`` rounds only the cross-term operands; sums stay float32."""
    pn = torch.sum(p * p, dim=1, keepdim=True)
    if precision == "bf16":
        cross2 = 2.0 * (p.to(torch.bfloat16).float()
                        @ centers.to(torch.bfloat16).float().T)
    else:
        cross2 = 2.0 * p @ centers.T
    sq = pn + cn[None, :] - cross2
    eff = torch.clamp_min(sq, 0.0) * inv2[None, :]
    k = eff.shape[1]
    # min + exact equality + max over (k - j) gives the FIRST index
    # attaining the min, like jnp.argmin
    best = torch.min(eff, dim=1).values
    iseq = eff == best[:, None]
    rev = torch.arange(k, 0, -1, dtype=torch.int32, device=p.device)
    idx = (k - torch.max(iseq.to(torch.int32) * rev[None, :], dim=1).values
           ).to(torch.int32)
    onehot = idx[:, None].long() == torch.arange(k, device=p.device)[None, :]
    second = torch.min(torch.where(onehot, float("inf"), eff), dim=1).values
    return idx, best, second, onehot


def _chunk_moments(onehot, p, w, best):
    """Per-chunk moment partial as one [k, d+2] matmul: columns 0..d-1
    sum w*p, column d sum w, column d+1 sum w*best. Shared by the fused
    dense backend and ``segment_moments`` so both sum in one order."""
    ww = torch.where(onehot, w[:, None], 0.0)                  # [C, k]
    stacked = torch.cat([p, torch.ones_like(p[:, :1]), best[:, None]],
                        dim=1)
    return ww.T @ stacked                                      # [k, d+2]


def _split_moments(m, d):
    return m[:, :d], m[:, d], m[:, d + 1]


def segment_moments(points, weights, idx, best_sq, k: int, *,
                    chunk: int | None = None):
    """Per-cluster weighted moments of an existing assignment: the
    unfused path for backends without moment support. Returns (csum
    [k, d], cw [k], rad2 [k]); bit-identical to the dense backend's fused
    moments for the same ``chunk``."""
    n, d = points.shape
    if chunk is None:
        chunk = default_chunk(k)
    arange_k = torch.arange(k, device=points.device)[None, :]
    total = None
    for s in range(0, max(n, 1), chunk):
        m = _chunk_moments(idx[s:s + chunk, None].long() == arange_k,
                           points[s:s + chunk], weights[s:s + chunk],
                           best_sq[s:s + chunk])
        total = m if total is None else total + m
    return _split_moments(total, d)


@register_assign_backend("torch", supports_moments=True)
def assign_argmin_torch(points, centers, influence, *,
                        chunk: int | None = None,
                        block_p: int = 1024, block_c: int = 128,
                        weights=None, return_moments: bool = False,
                        precision: str = "f32", layout=None):
    """Chunked dense path (reference: ``assign_argmin_jnp``).
    ``block_p``/``block_c``/``layout`` are accepted for the contract and
    ignored.
    With ``return_moments=True`` the moments come out of the same chunk
    loop, summed across chunks in chunk order."""
    del block_p, block_c, layout
    if return_moments and weights is None:
        raise ValueError("return_moments=True requires weights")
    k = centers.shape[0]
    if chunk is None:
        chunk = default_chunk(k)
    inv2 = 1.0 / (influence * influence)
    cn = torch.sum(centers * centers, dim=1)
    n, d = points.shape
    idx, best, second, total = [], [], [], None
    for s in range(0, max(n, 1), chunk):
        p = points[s:s + chunk]
        i, b, sec, onehot = _chunk_assign(p, cn, centers, inv2, precision)
        idx.append(i)
        best.append(b)
        second.append(sec)
        if return_moments:
            m = _chunk_moments(onehot, p, weights[s:s + chunk], b)
            total = m if total is None else total + m
    out = (torch.cat(idx), torch.cat(best), torch.cat(second))
    if not return_moments:
        return out
    return out + _split_moments(total, d)


# ---------------------------------------------------------------------------
# wrapper of the sorted CUDA kernel
# ---------------------------------------------------------------------------

def _pad_rows(x, multiple: int, value: float):
    """Pad the leading axis of ``x`` up to a multiple with ``value``
    (no copy when it already is one)."""
    pad = (-x.shape[0]) % multiple
    if pad == 0:
        return x
    fill = torch.full((pad,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, fill])


def _bbox(points):
    """(lo, hi) [d]: the points' bounding box."""
    return torch.min(points, dim=0).values, torch.max(points, dim=0).values


def _bbox_order(lo, hi, centers, inv2):
    """Stable order of the centers by effective squared distance to the
    points' bounding box [lo, hi] (paper Alg. 1 line 6)."""
    gap = torch.clamp_min(torch.maximum(lo[None] - centers,
                                        centers - hi[None]), 0.0)
    key = torch.sum(gap * gap, dim=1) * inv2
    return torch.argsort(key, stable=True)


@dataclass(frozen=True)
class PointLayout:
    """A solve's points in Hilbert order, built once by ``point_layout``.

    ``points`` [N, d] float32 holds row ``order[i]`` of the solver's
    points at row i, padded to ``N`` (a ``block_p`` multiple) with copies
    of the last row; ``order`` [N] int32 maps the padding rows to
    positions n..N-1, so results sized N and sliced to n lie in the
    solver's order. ``lo``/``hi`` [d] are the bounding box of the n
    points; the kernel takes each point tile's box itself."""
    order: torch.Tensor
    points: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    n: int
    block_p: int


def point_layout(points, block_p: int = 1024) -> PointLayout:
    """The stable Hilbert order of ``points`` [n, d] (d = 2 or 3, keys of
    ``core.sfc.hilbert_index_torch`` on the points' device), a contiguous
    float32 copy of the points in that order and their bounding box. In
    this order a tile of consecutive rows covers a small box of space,
    which is what lets the CUDA sweep skip centers."""
    from repro_torch.core.sfc import hilbert_index_torch
    n, d = points.shape
    if d not in (2, 3) or n == 0:
        raise ValueError(f"point_layout takes n > 0 points in 2 or 3 "
                         f"dimensions, got {tuple(points.shape)}")
    perm = torch.sort(hilbert_index_torch(points.to(torch.float64)),
                      stable=True).indices
    pts = points[perm].float()
    pad = (-n) % block_p
    order = torch.cat([perm, torch.arange(n, n + pad, device=perm.device)])
    pts = torch.cat([pts, pts[-1:].expand(pad, d)]).contiguous()
    lo, hi = _bbox(points)
    return PointLayout(order.to(torch.int32).contiguous(), pts, lo, hi, n,
                       block_p)


def _layout_rows(points, layout, block_p, entry):
    """(kernel points, order, lo, hi) for a sweep over ``points``: the
    layout's when one is given, else the points zero-padded in their own
    order."""
    if layout is None:
        return (_pad_rows(points, block_p, 0.0).float().contiguous(), None,
                *_bbox(points))
    if layout.n != points.shape[0] or layout.block_p != block_p:
        raise ValueError(f"{entry}: the layout was built for n={layout.n}, "
                         f"block_p={layout.block_p}; this sweep has "
                         f"n={points.shape[0]}, block_p={block_p}")
    return layout.points, layout.order, layout.lo, layout.hi


def _tile_bounds(points, centers, inv2, block_p, block_c):
    """Lower bound of the effective squared distance between each
    point-tile's bbox and each center tile: max(0, gap)^2 * inv2, the
    minimum over the tile's centers. [n/BP, k/BC]."""
    n, d = points.shape
    k = centers.shape[0]
    pt = points.reshape(n // block_p, block_p, d)
    lo = torch.min(pt, dim=1).values                   # [nPT, d]
    hi = torch.max(pt, dim=1).values
    cexp = centers.reshape(k // block_c, block_c, d)[None]
    gap = torch.clamp_min(torch.maximum(lo[:, None, None, :] - cexp,
                                        cexp - hi[:, None, None, :]), 0.0)
    d2 = torch.sum(gap * gap, dim=-1)                  # [nPT, nCT, BC]
    eff = d2 * inv2.reshape(k // block_c, block_c)[None]
    return torch.min(eff, dim=-1).values               # [nPT, nCT]


def assign_argmin(points, centers, influence, block_p: int = 1024,
                  block_c: int = 128, weights=None,
                  return_moments: bool = False, precision: str = "f32",
                  layout: PointLayout | None = None):
    """Sorted-configuration wrapper (reference: ``ops.assign_argmin``):
    centers sorted by bbox distance, padded with ``_FAR`` rows, points
    padded with zeros (zero weight), the kernel launched, and labels and
    moments mapped back to the original center order. With a ``layout``
    the kernel reads its Hilbert-ordered copy of the points and the box
    is the layout's (no reduction over the points). The sort only decides
    which center wins an exact tie, as in the reference; the kernel skips
    centers by its own per-tile bounds, whatever their order."""
    n, d = points.shape
    k = centers.shape[0]
    inv2 = 1.0 / (influence * influence)
    pts, rows, lo, hi = _layout_rows(points, layout, block_p,
                                     "assign_argmin")
    order = _bbox_order(lo, hi, centers, inv2)
    cts = _pad_rows(centers[order], block_c, _FAR).float().contiguous()
    iv2 = _pad_rows(inv2[order], block_c, 1.0).float().contiguous()
    if return_moments:
        if weights is None:
            raise ValueError("return_moments=True requires weights")
        w = _pad_rows(weights, block_p, 0.0).float().contiguous()
        idx_s, best, second, m = assign_reduce_cuda(
            pts, cts, iv2, w, k_real=k, block_p=block_p, block_c=block_c,
            precision=precision, order=rows)
        # sorted column j belongs to original center order[j]
        m_orig = torch.zeros(k, d + 2, dtype=torch.float32,
                             device=points.device)
        m_orig[order] = m.T[:k]
        idx = order[torch.clamp(idx_s[:n], 0, k - 1).long()].to(torch.int32)
        return (idx, best[:n], second[:n],
                m_orig[:, :d], m_orig[:, d], m_orig[:, d + 1])
    idx_s, best, second = assign_argmin_cuda(
        pts, cts, iv2, k_real=k, block_p=block_p, block_c=block_c,
        precision=precision, order=rows)
    idx = order[torch.clamp(idx_s[:n], 0, k - 1).long()].to(torch.int32)
    return idx, best[:n], second[:n]


@register_assign_backend("cuda", supports_moments=True, supports_layout=True)
def assign_argmin_cuda_backend(points, centers, influence, *,
                               chunk: int | None = None,
                               block_p: int = 1024, block_c: int = 128,
                               weights=None, return_moments: bool = False,
                               precision: str = "f32",
                               layout: PointLayout | None = None):
    """Registry adapter for the sorted CUDA sweep (``chunk`` ignored)."""
    del chunk
    return assign_argmin(points, centers, influence, block_p=block_p,
                         block_c=block_c, weights=weights,
                         return_moments=return_moments, precision=precision,
                         layout=layout)


def tile_prune_fraction(points, centers, influence, second_sq,
                        block_p: int = 1024, block_c: int = 128):
    """Fraction of (point-tile x center-tile) pairs whose bbox bound
    cannot beat the tile's worst converged second-best, over the points
    in the solver's order (``stats["tiles_pruned_frac"]``): the
    reference's estimate of what its TPU kernel skips at the final state,
    kept for parity. The first center tile never counts. Points are
    edge-padded so tile bboxes stay tight. What the CUDA kernel skips is
    another quantity (per center, over the Hilbert-ordered layout): it
    counts the pairs it computes (``pairs=`` of the kernel wrappers)."""
    n, d = points.shape
    inv2 = 1.0 / (influence * influence)
    order = _bbox_order(*_bbox(points), centers, inv2)
    pad_n = (-n) % block_p
    pts = points
    sec = second_sq
    if pad_n:
        pts = torch.cat([points, points[-1:].expand(pad_n, d)])
        sec = torch.cat([second_sq, second_sq[-1:].expand(pad_n)])
    cts = _pad_rows(centers[order], block_c, _FAR)
    iv2 = _pad_rows(inv2[order], block_c, 1.0)
    bounds = _tile_bounds(pts.float(), cts.float(), iv2.float(), block_p,
                          block_c)
    worst = torch.max(sec.reshape(-1, block_p), dim=1).values
    prunable = bounds >= worst[:, None]
    prunable[:, 0] = False
    return torch.mean(prunable.to(torch.float32))


# ---------------------------------------------------------------------------
# language-model kernels: causal flash attention and the MoE router
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, bq: int = 512, bk: int = 512,
                    softcap: float = 0.0):
    """Causal flash attention. q: [B, S, H, dh], k/v: [B, S, KV, dh]
    (H % KV == 0). Returns [B, S, H, dh] in q's type.

    ``bq`` and ``bk`` are the TPU kernel's tiles, kept for the reference's
    signature. On the card a bfloat16 call takes the tensor-core kernel and
    a float32 call the CUDA-core kernel (``flash_attention.kernel_for``);
    both have their own 64-key tiles and mask a ragged last tile
    themselves, so S is not padded and nothing is copied: they read the
    ``[B, S, heads, dh]`` layout through strides. With gradients on and
    an input that requires one, the same kernel runs under
    ``flash_attention.FlashAttentionFn``, whose backward recomputes the
    attention in plain PyTorch."""
    from .flash_attention import FlashAttentionFn, flash_attention_cuda
    del bq, bk
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, float(softcap or 0.0))
    return flash_attention_cuda(q, k, v, softcap)


def router_topk(x, centroids, influence, top_k: int, bt: int = 256,
                block_e: int = 128):
    """Fused balanced-k-means MoE routing. x: [T, D], centroids: [E, D],
    influence: [E]. Returns (idx [T, top_k] int32, eff [T, top_k]
    float32), ascending in eff, the lower expert index first on ties.
    eff multiplies by ``1 / influence^2``, as the reference wrapper does.

    ``bt`` and ``block_e`` are the TPU kernel's tiles, kept for the
    reference's signature. The CUDA kernel has its own and masks a ragged
    last tile of either axis itself, so neither is padded; x is handed
    over as it is (bfloat16 or float32)."""
    from .moe_router_kernel import router_topk_cuda
    del bt, block_e
    inv2 = (1.0 / (influence * influence)).float()
    return router_topk_cuda(x.contiguous(), centroids.float().contiguous(),
                            inv2.contiguous(), top_k)


def router_topk_divide(x, centroids, influence, top_k: int):
    """``router_topk`` in the reference model's arithmetic: eff is
    ``max(sq, 0) / (influence * influence)``, bit for bit the model's
    ``router_logits`` for the same ``sq``, so the top-k is its
    ``router_logits`` + ``top_k``. ``influence=None`` routes unscaled (the
    serving paths), which equals both forms at influence 1."""
    from .moe_router_kernel import router_topk_divide_cuda
    if influence is not None:
        influence = influence.float().contiguous()
    return router_topk_divide_cuda(x.contiguous(),
                                   centroids.float().contiguous(), influence,
                                   top_k)


def _counted():
    """(name, wrapper, attribute) of every counted kernel wrapper and
    plain version."""
    from . import assign_kernel as ak
    from . import flash_attention as fa
    from . import moe_router_kernel as mr
    from . import scan
    from . import triton_assign as ta
    return (
        ("assign_reduce", ak.assign_reduce_cuda, "launches"),
        ("assign_argmin", ak.assign_argmin_cuda, "launches"),
        ("assign_reduce_flat", ta.triton_assign_reduce_cuda, "launches"),
        ("assign_argmin_flat", ta.triton_assign_cuda, "launches"),
        ("assign_reduce_plain", ak.assign_reduce_plain, "calls"),
        ("assign_argmin_plain", ak.assign_argmin_plain, "calls"),
        ("prefix_sum", scan.prefix_sum, "launches"),
        ("prefix_sum_plain", scan.prefix_sum_plain, "calls"),
        ("router_topk", mr.router_topk_cuda, "launches"),
        ("router_topk_plain", mr.router_topk_plain, "calls"),
        ("flash_attention_tc", fa.flash_attention_tc, "launches"),
        ("flash_attention", fa.flash_attention_f32, "launches"),
        ("flash_attention_plain", fa.flash_attention_plain, "calls"),
    )


def launch_counts() -> dict:
    """Kernel launches and plain-version calls since the last reset."""
    return {name: getattr(fn, attr) for name, fn, attr in _counted()}


def reset_launch_counts() -> None:
    for _, fn, attr in _counted():
        setattr(fn, attr, 0)


# registering the flat backend imports this module back, so the import
# sits after every name it needs
from . import triton_assign as _triton_assign  # noqa: E402,F401
