"""Hand-written CUDA assignment sweep (sorted configuration) and its plain
PyTorch versions.

Counterpart of ``repro/kernels/assign_kernel.py``. The TPU kernels it
replaces are ``_assign_kernel`` / ``_assign_kernel_db``
(``assign_argmin_pallas``) and ``_assign_moments_kernel`` /
``_assign_moments_kernel_db`` (``assign_reduce_pallas``). The CUDA source
is ``csrc/assign.cu``; its header says what bounds the sweep on the H100
and what the design does about it.

Contract of both wrappers: ``points [N, D]`` float32, ``centers [K, D]``
float32 already sorted and padded with ``_FAR`` rows to a ``block_c``
multiple, ``inv2 [K]``, ``k_real`` the number of real centers, ``N`` a
``block_p`` multiple. ``ops.assign_argmin`` does the sort and padding.
With ``order`` (int32 [N], a permutation of ``range(N)``), row i of
``points`` is the point whose weight and outputs sit at position
``order[i]``: the solver's points in the Hilbert order of
``ops.point_layout``, while weights and outputs stay in the solver's
order.

Unlike the TPU kernel these take no ``tile_bounds``: at d = 2 and 3 the
CUDA kernel bounds each center against each point tile's bounding box
itself and skips the centers that cannot be any point's best or second
(per center, with a rounding slack), so its outputs equal those of the
unpruned sweep bit for bit. ``pairs`` (int64 [1] on the card) receives
the number of (point, center) pairs the kernel computed.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel. There is no fallback: a CUDA call that cannot launch raises.
Each wrapper counts its kernel launches in ``.launches`` and each plain
version its calls in ``.calls``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

PRECISIONS = ("f32", "bf16")
THREADS = 256          # threads per block in assign.cu


def _check_tiling(n: int, k: int, block_p: int, block_c: int,
                  entry: str) -> None:
    """Wrapper-side padding contract, as in the reference: the entry
    points take only tile-multiple shapes."""
    if n % block_p != 0:
        raise ValueError(
            f"{entry}: points axis n={n} is not a multiple of "
            f"block_p={block_p}; pad the point array (ops.assign_argmin "
            "does this) or pass a dividing block_p")
    if k % block_c != 0:
        raise ValueError(
            f"{entry}: centers axis k={k} is not a multiple of "
            f"block_c={block_c}; pad the center array with _FAR rows "
            "(ops.assign_argmin does this) or pass a dividing block_c")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path and the kernel's oracle on the card)
# ---------------------------------------------------------------------------

def _plain_sweep(points, centers, inv2, k_real, weights, precision,
                 chunk=65536):
    """The kernel's function in plain PyTorch: the dense backend's chunk
    math (``ops._chunk_assign``, ``ops._chunk_moments``) against the real
    centers only, chunked over points so the [chunk, K] scratch stays
    bounded. The padded centers k_real..K-1 are never computed and their
    moment columns stay zero, as in the kernel. Returns (idx, best,
    second, moments [d+2, K] or None)."""
    from .ops import _chunk_assign, _chunk_moments
    _check_precision(precision)
    n, d = points.shape
    creal = centers[:k_real]
    cn = torch.sum(creal * creal, dim=1)
    iv = inv2[:k_real]
    idx, best, second = [], [], []
    moments = (None if weights is None else
               torch.zeros(d + 2, centers.shape[0], dtype=torch.float32,
                           device=points.device))
    for s in range(0, n, chunk):
        p = points[s:s + chunk]
        i, b, sec, onehot = _chunk_assign(p, cn, creal, iv, precision)
        idx.append(i)
        best.append(b)
        second.append(sec)
        if weights is not None:
            moments[:, :k_real] += _chunk_moments(
                onehot, p, weights[s:s + chunk], b).T
    return torch.cat(idx), torch.cat(best), torch.cat(second), moments


def _solver_rows(points, order):
    """``points`` in the solver's order: row ``order[i]`` of the result is
    row i of ``points`` (no copy without an order)."""
    if order is None:
        return points
    out = torch.empty_like(points)
    out[order.long()] = points
    return out


def assign_argmin_plain(points, centers, inv2, k_real: int,
                        precision: str = "f32", order=None):
    """Plain version of ``assign_argmin_cuda``."""
    assign_argmin_plain.calls += 1
    return _plain_sweep(_solver_rows(points, order), centers, inv2, k_real,
                        None, precision)[:3]


def assign_reduce_plain(points, centers, inv2, weights, k_real: int,
                        precision: str = "f32", order=None):
    """Plain version of ``assign_reduce_cuda``."""
    assign_reduce_plain.calls += 1
    return _plain_sweep(_solver_rows(points, order), centers, inv2, k_real,
                        weights, precision)


# the kernel's bound constants (assign.cu): rounding slack of the update,
# of bf16 operands of p.c, and of the bounds' own arithmetic
SLACK_REL = 2.0 ** -20
BF16_REL = 2.0 ** -5
SHRINK = 2.0 ** -18


def eff_bounds_plain(lo, hi, centers, inv2, precision: str = "f32"):
    """The kernel's per-tile center bounds in plain PyTorch: for tile
    boxes ``lo``/``hi`` [T, d] and centers [K, d], (lb, ub) [T, K] with
    lb <= eff <= ub for the eff the kernel computes between any point of
    the box and the center (``assign.cu``'s header gives the slack), and
    the threshold [T]: the second smallest ub of each tile (+inf with one
    center). The kernel skips center c in tile t when lb > threshold."""
    _check_precision(precision)
    lo, hi, c = lo[:, None, :], hi[:, None, :], centers[None]
    gap = torch.clamp_min(torch.maximum(lo - c, c - hi), 0.0)
    far = torch.maximum(torch.abs(c - lo), torch.abs(hi - c))
    g2 = torch.sum(gap * gap, dim=-1)
    f2 = torch.sum(far * far, dim=-1)
    cn = torch.sum(centers * centers, dim=-1)[None]
    m = torch.sum(torch.maximum(torch.abs(lo), torch.abs(hi))
                  * torch.abs(c), dim=-1)
    pmax = torch.sum(torch.maximum(lo * lo, hi * hi), dim=-1)
    slack = SLACK_REL * (pmax + cn + 2.0 * m)
    if precision == "bf16":
        slack = slack + BF16_REL * m
    iv = inv2[None]
    lb = (g2 * (1.0 - SHRINK) - slack) * iv * (1.0 - SHRINK)
    ub = (f2 * (1.0 + SHRINK) + slack) * iv * (1.0 + SHRINK)
    ub_t = torch.where(torch.isnan(ub), float("inf"), ub)
    if ub.shape[1] < 2:
        thr = torch.full(ub.shape[:1], float("inf"), dtype=ub.dtype,
                         device=ub.device)
    else:
        thr = torch.topk(ub_t, 2, dim=1, largest=False).values[:, 1]
    return lb, ub, thr


assign_argmin_plain.calls = 0
assign_reduce_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_inputs(entry, points, centers, inv2, weights, k_real, order,
                  pairs):
    tensors = [points, centers, inv2] + ([] if weights is None
                                         else [weights])
    for t in tensors + [x for x in (order, pairs) if x is not None]:
        if t.device != points.device:
            raise ValueError(f"{entry}: all inputs must be on "
                             f"{points.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: inputs must be contiguous")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"{entry}: inputs must be float32, got "
                             f"{t.dtype}")
    n, d = points.shape
    k = centers.shape[0]
    if centers.shape != (k, d) or inv2.shape != (k,):
        raise ValueError(f"{entry}: centers {tuple(centers.shape)} / inv2 "
                         f"{tuple(inv2.shape)} do not match d={d}")
    if weights is not None and weights.shape != (n,):
        raise ValueError(f"{entry}: weights must be [{n}]")
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (n,)):
        raise ValueError(f"{entry}: order must be int32 [{n}]")
    if pairs is not None and (pairs.dtype != torch.int64
                              or pairs.shape != (1,)):
        raise ValueError(f"{entry}: pairs must be int64 [1]")
    if not 1 <= k_real <= k:
        raise ValueError(f"{entry}: k_real={k_real} outside [1, {k}]")
    if n > 2 ** 31 - 1 - 4 * THREADS:
        raise ValueError(f"{entry}: n={n} exceeds the int32 index range")


def points_per_thread(block_p: int) -> int:
    """Points each thread keeps in registers: the kernel's point tile is
    ``THREADS * ppt`` points, the largest that fits in ``block_p``."""
    for ppt in (4, 2):
        if block_p >= THREADS * ppt:
            return ppt
    return 1


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, d: int, k_pad: int, ppt: int,
                     bf16: int, fused: bool) -> int:
    """Blocks of one kernel instance resident on the whole card at once
    (occupancy per SM x SMs); asked of CUDA once per instance."""
    from .build import load_library
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        load_library().call("repro_assign_occupancy", d, k_pad, ppt, bf16,
                            int(fused), ctypes.byref(per_sm))
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return max(per_sm.value, 1) * sms


def grid_blocks(n: int, d: int, k_pad: int, ppt: int, bf16: int,
                fused: bool, device: torch.device) -> int:
    """Blocks in the launch: as many as are resident on the card at once
    (one wave), never more than the point tiles. The count fixes the
    order of the moment sums, so one card and shape always give the same
    bits."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    tiles = -(-n // (THREADS * ppt))
    return max(1, min(tiles, _resident_blocks(index, d, k_pad, ppt, bf16,
                                              bool(fused))))


def launch_sweep(points, centers, inv2, weights, k_real: int, ppt: int,
                 precision: str, order=None, pairs=None, prune: bool = True):
    """Launch ``assign.cu`` on the current stream. Returns (idx, best,
    second, partials [blocks, d+2, K] or None). Callers count launches.
    ``prune=False`` computes every pair: the checks hold the pruned kernel
    bit-equal to it, and nothing else turns it off."""
    from .build import load_library
    _check_precision(precision)
    entry = "repro_assign_argmin" if weights is None else "repro_assign_reduce"
    _check_inputs(entry, points, centers, inv2, weights, k_real, order,
                  pairs)
    n, d = points.shape
    k_pad = centers.shape[0]
    dev = points.device
    lib = load_library()
    bf16 = int(precision == "bf16")
    blocks = grid_blocks(n, d, k_pad, ppt, bf16, weights is not None, dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.float32, device=dev)
    second = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    order_p = None if order is None else order.data_ptr()
    pairs_p = None if pairs is None else pairs.data_ptr()
    if weights is None:
        lib.call(entry, points.data_ptr(), order_p, centers.data_ptr(),
                 inv2.data_ptr(), n, d, k_pad, k_real, ppt, bf16, blocks,
                 int(prune), idx.data_ptr(), best.data_ptr(),
                 second.data_ptr(), pairs_p, stream)
        return idx, best, second, None
    partials = torch.empty(blocks, d + 2, k_pad, dtype=torch.float32,
                           device=dev)
    # the kernel reads weights by row: gathered here into the layout's
    # order (one PyTorch call, far cheaper than the gather in the kernel)
    rows_w = weights if order is None else torch.index_select(weights, 0,
                                                              order)
    lib.call(entry, points.data_ptr(), order_p, centers.data_ptr(),
             inv2.data_ptr(), rows_w.data_ptr(), n, d, k_pad, k_real, ppt,
             bf16, blocks, int(prune), idx.data_ptr(), best.data_ptr(),
             second.data_ptr(), partials.data_ptr(), pairs_p, stream)
    return idx, best, second, partials


def assign_argmin_cuda(points, centers, inv2, k_real: int,
                       block_p: int = 1024, block_c: int = 128,
                       precision: str = "f32", order=None, pairs=None):
    """Effective-distance argmin, sorted configuration. Returns (idx
    [N] int32 in sorted-center space, best_eff_sq [N], second_eff_sq
    [N]). Replaces ``assign_argmin_pallas``."""
    _check_tiling(points.shape[0], centers.shape[0], block_p, block_c,
                  "assign_argmin_cuda")
    if points.device.type == "cpu":
        return assign_argmin_plain(points, centers, inv2, k_real, precision,
                                   order)
    idx, best, second, _ = launch_sweep(points, centers, inv2, None, k_real,
                                        points_per_thread(block_p),
                                        precision, order, pairs)
    assign_argmin_cuda.launches += 1
    return idx, best, second


def assign_reduce_cuda(points, centers, inv2, weights, k_real: int,
                       block_p: int = 1024, block_c: int = 128,
                       precision: str = "f32", order=None, pairs=None):
    """Fused assign+reduce, sorted configuration. Returns (idx, best,
    second, moments [d+2, K]) with the moments in sorted-center columns.
    Replaces ``assign_reduce_pallas``; the per-block partials are summed
    here, outside the kernel, with one ``torch.sum``."""
    _check_tiling(points.shape[0], centers.shape[0], block_p, block_c,
                  "assign_reduce_cuda")
    if points.device.type == "cpu":
        return assign_reduce_plain(points, centers, inv2, weights, k_real,
                                   precision, order)
    idx, best, second, partials = launch_sweep(
        points, centers, inv2, weights, k_real, points_per_thread(block_p),
        precision, order, pairs)
    assign_reduce_cuda.launches += 1
    return idx, best, second, torch.sum(partials, dim=0)


assign_argmin_cuda.launches = 0
assign_reduce_cuda.launches = 0
