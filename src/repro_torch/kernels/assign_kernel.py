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
Unlike the TPU kernel these take no ``tile_bounds``: the CUDA kernel does
not prune center tiles (at the main shape the bbox bound prunes nothing),
and its outputs equal the pruned kernel's, because the pruned tiles
cannot change any point's best or second.

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


def assign_argmin_plain(points, centers, inv2, k_real: int,
                        precision: str = "f32"):
    """Plain version of ``assign_argmin_cuda``."""
    assign_argmin_plain.calls += 1
    return _plain_sweep(points, centers, inv2, k_real, None, precision)[:3]


def assign_reduce_plain(points, centers, inv2, weights, k_real: int,
                        precision: str = "f32"):
    """Plain version of ``assign_reduce_cuda``."""
    assign_reduce_plain.calls += 1
    return _plain_sweep(points, centers, inv2, k_real, weights, precision)


assign_argmin_plain.calls = 0
assign_reduce_plain.calls = 0


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check_inputs(entry, points, centers, inv2, weights, k_real):
    tensors = [points, centers, inv2] + ([] if weights is None
                                         else [weights])
    for t in tensors:
        if t.device != points.device:
            raise ValueError(f"{entry}: all inputs must be on "
                             f"{points.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{entry}: inputs must be float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{entry}: inputs must be contiguous")
    n, d = points.shape
    k = centers.shape[0]
    if centers.shape != (k, d) or inv2.shape != (k,):
        raise ValueError(f"{entry}: centers {tuple(centers.shape)} / inv2 "
                         f"{tuple(inv2.shape)} do not match d={d}")
    if weights is not None and weights.shape != (n,):
        raise ValueError(f"{entry}: weights must be [{n}]")
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
                 precision: str):
    """Launch ``assign.cu`` on the current stream. Returns (idx, best,
    second, partials [blocks, d+2, K] or None). Callers count launches."""
    from .build import load_library
    _check_precision(precision)
    entry = "repro_assign_argmin" if weights is None else "repro_assign_reduce"
    _check_inputs(entry, points, centers, inv2, weights, k_real)
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
    if weights is None:
        lib.call(entry, points.data_ptr(), centers.data_ptr(),
                 inv2.data_ptr(), n, d, k_pad, k_real, ppt, bf16, blocks,
                 idx.data_ptr(), best.data_ptr(), second.data_ptr(), stream)
        return idx, best, second, None
    partials = torch.empty(blocks, d + 2, k_pad, dtype=torch.float32,
                           device=dev)
    lib.call(entry, points.data_ptr(), centers.data_ptr(), inv2.data_ptr(),
             weights.data_ptr(), n, d, k_pad, k_real, ppt, bf16, blocks,
             idx.data_ptr(), best.data_ptr(), second.data_ptr(),
             partials.data_ptr(), stream)
    return idx, best, second, partials


def assign_argmin_cuda(points, centers, inv2, k_real: int,
                       block_p: int = 1024, block_c: int = 128,
                       precision: str = "f32"):
    """Effective-distance argmin, sorted configuration. Returns (idx
    [N] int32 in sorted-center space, best_eff_sq [N], second_eff_sq
    [N]). Replaces ``assign_argmin_pallas``."""
    _check_tiling(points.shape[0], centers.shape[0], block_p, block_c,
                  "assign_argmin_cuda")
    if points.device.type == "cpu":
        return assign_argmin_plain(points, centers, inv2, k_real, precision)
    idx, best, second, _ = launch_sweep(points, centers, inv2, None, k_real,
                                        points_per_thread(block_p),
                                        precision)
    assign_argmin_cuda.launches += 1
    return idx, best, second


def assign_reduce_cuda(points, centers, inv2, weights, k_real: int,
                       block_p: int = 1024, block_c: int = 128,
                       precision: str = "f32"):
    """Fused assign+reduce, sorted configuration. Returns (idx, best,
    second, moments [d+2, K]) with the moments in sorted-center columns.
    Replaces ``assign_reduce_pallas``; the per-block partials are summed
    here, outside the kernel, with one ``torch.sum``."""
    _check_tiling(points.shape[0], centers.shape[0], block_p, block_c,
                  "assign_reduce_cuda")
    if points.device.type == "cpu":
        return assign_reduce_plain(points, centers, inv2, weights, k_real,
                                   precision)
    idx, best, second, partials = launch_sweep(
        points, centers, inv2, weights, k_real, points_per_thread(block_p),
        precision)
    assign_reduce_cuda.launches += 1
    return idx, best, second, torch.sum(partials, dim=0)


assign_argmin_cuda.launches = 0
assign_reduce_cuda.launches = 0
