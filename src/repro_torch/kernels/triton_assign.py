"""Flat ("cuda_flat") configuration of the assignment sweep.

Counterpart of ``repro/kernels/triton_assign.py``: centers in their
original order (no sort, no un-sort), a 1-D grid over point tiles with the
center loop inside the kernel, and one moment partial per program summed
outside the kernel. It replaces ``_triton_kernel``
(``triton_assign_pallas``) and ``_triton_moments_kernel``
(``triton_assign_reduce_pallas``). The kernel is ``csrc/assign.cu``, the
same source as the sorted configuration. Called directly, the wrappers
default to 256-point tiles (``block_p=256``, one point per thread); the
partitioner passes its ``BKMConfig.block_p`` (1024, four points per
thread) to every backend, as the reference does. With the solve's
``ops.point_layout`` the kernel reads the points in Hilbert order and
skips, per point tile, the centers that cannot be any point's best or
second (exactly, as ``csrc/assign.cu``'s header argues); the order of the
centers plays no part in that.
"""
from __future__ import annotations

import torch

from .assign_kernel import (_check_tiling, assign_argmin_plain,
                            assign_reduce_plain, launch_sweep,
                            points_per_thread)


def triton_assign_cuda(points, centers, inv2, k_real: int,
                       block_p: int = 256, block_c: int = 128,
                       precision: str = "f32", order=None, pairs=None):
    """Argmin sweep, flat configuration. Returns (idx, best, second) in
    original center order."""
    _check_tiling(points.shape[0], centers.shape[0], block_p, block_c,
                  "triton_assign_cuda")
    if points.device.type == "cpu":
        return assign_argmin_plain(points, centers, inv2, k_real, precision,
                                   order)
    idx, best, second, _ = launch_sweep(points, centers, inv2, None, k_real,
                                        points_per_thread(block_p),
                                        precision, order, pairs)
    triton_assign_cuda.launches += 1
    return idx, best, second


def triton_assign_reduce_cuda(points, centers, inv2, weights, k_real: int,
                              block_p: int = 256, block_c: int = 128,
                              precision: str = "f32", order=None,
                              pairs=None):
    """Fused sweep, flat configuration. Returns (idx, best, second,
    moments [d+2, K]); the split partials are summed with ``torch.sum``
    as the reference leaves that sum to XLA."""
    _check_tiling(points.shape[0], centers.shape[0], block_p, block_c,
                  "triton_assign_reduce_cuda")
    if points.device.type == "cpu":
        return assign_reduce_plain(points, centers, inv2, weights, k_real,
                                   precision, order)
    idx, best, second, partials = launch_sweep(
        points, centers, inv2, weights, k_real, points_per_thread(block_p),
        precision, order, pairs)
    triton_assign_reduce_cuda.launches += 1
    return idx, best, second, torch.sum(partials, dim=0)


triton_assign_cuda.launches = 0
triton_assign_reduce_cuda.launches = 0


def _pad_inputs(centers, influence, block_c):
    from .ops import _FAR, _pad_rows
    inv2 = 1.0 / (influence * influence)
    cts = _pad_rows(centers, block_c, _FAR).float().contiguous()
    iv2 = _pad_rows(inv2, block_c, 1.0).float().contiguous()
    return cts, iv2


def triton_assign_backend(points, centers, influence, *,
                          chunk: int | None = None, block_p: int = 256,
                          block_c: int = 128, weights=None,
                          return_moments: bool = False,
                          precision: str = "f32", layout=None):
    """Registry adapter (``chunk`` ignored). No center sort, so indices
    and moments come out in original center order."""
    from .ops import _layout_rows
    del chunk
    n, d = points.shape
    k = centers.shape[0]
    pts, rows, _, _ = _layout_rows(points, layout, block_p,
                                   "triton_assign_backend")
    cts, iv2 = _pad_inputs(centers, influence, block_c)
    if return_moments:
        if weights is None:
            raise ValueError("return_moments=True requires weights")
        from .ops import _pad_rows
        w = _pad_rows(weights, block_p, 0.0).float().contiguous()
        idx, best, second, m = triton_assign_reduce_cuda(
            pts, cts, iv2, w, k_real=k, block_p=block_p, block_c=block_c,
            precision=precision, order=rows)
        return (idx[:n], best[:n], second[:n],
                m.T[:k, :d], m[d, :k], m[d + 1, :k])
    idx, best, second = triton_assign_cuda(
        pts, cts, iv2, k_real=k, block_p=block_p, block_c=block_c,
        precision=precision, order=rows)
    return idx[:n], best[:n], second[:n]


def _register():
    from .ops import register_assign_backend
    register_assign_backend("cuda_flat", supports_moments=True,
                            supports_layout=True)(triton_assign_backend)


_register()
