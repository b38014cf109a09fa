"""Hilbert space-filling-curve keys and the SFC bootstrap (paper Alg. 2,
lines 4-7). Counterpart of ``repro/core/sfc.py``.

Two implementations with identical 64-bit keys (21 bits/dim in 3-D, 31
in 2-D, Skilling's transpose algorithm):

* ``hilbert_index_np`` and friends: host numpy, copied from the
  reference; the baselines use them.
* ``hilbert_index_torch``: the same arithmetic in torch int64 / float64,
  so it runs on the card. The bounding-box quantization divides by a
  per-axis span tensor (a true IEEE division, never a multiply by a
  reciprocal), so the keys equal numpy's bit for bit.

``sfc_initial_centers_torch`` is the bootstrap the partitioner runs: keys,
stable sort and the strided or weighted picks on the tensor's device.

The multi-device path adds the reference's in-graph keys: int32, 10 bits
a dimension in 3-D and 15 in 2-D, quantized against a *global* bounding
box (``hilbert_index_int32``), and the distributed bootstrap over them
(``sfc_initial_centers_sharded``, ``bootstrap="device"``).
"""
from __future__ import annotations

import numpy as np
import torch


def _axes_to_transpose_np(X: np.ndarray, bits: int) -> np.ndarray:
    """Skilling inverse-undo + Gray encode. X: [n, d] uint64."""
    X = X.copy()
    n, d = X.shape
    M = np.uint64(1) << np.uint64(bits - 1)
    Q = M
    while Q > np.uint64(1):
        Pm = Q - np.uint64(1)
        for i in range(d):
            flag = (X[:, i] & Q) != 0
            X[:, 0] = np.where(flag, X[:, 0] ^ Pm, X[:, 0])
            t = np.where(~flag, (X[:, 0] ^ X[:, i]) & Pm, np.uint64(0))
            X[:, 0] ^= t
            X[:, i] ^= t
        Q >>= np.uint64(1)
    for i in range(1, d):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(n, dtype=np.uint64)
    Q = M
    while Q > np.uint64(1):
        flag = (X[:, d - 1] & Q) != 0
        t = np.where(flag, t ^ (Q - np.uint64(1)), t)
        Q >>= np.uint64(1)
    for i in range(d):
        X[:, i] ^= t
    return X


def _interleave_np(X: np.ndarray, bits: int) -> np.ndarray:
    """Bit-interleave the transposed form into a single key."""
    n, d = X.shape
    key = np.zeros(n, dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(d):
            key = (key << np.uint64(1)) | ((X[:, i] >> np.uint64(b))
                                           & np.uint64(1))
    return key


def quantize_np(points: np.ndarray, bits: int) -> np.ndarray:
    """Scale float coords in their bounding box to the grid [0, 2^bits)."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    span = np.maximum(hi - lo, 1e-30)
    scaled = (points - lo) / span
    return np.minimum((scaled * (2 ** bits)).astype(np.uint64),
                      np.uint64(2 ** bits - 1))


def default_bits(d: int) -> int:
    return 31 if d == 2 else 21


def hilbert_index_np(points: np.ndarray, bits: int | None = None
                     ) -> np.ndarray:
    """Hilbert key per point (host). points: [n, d] float, d in {2, 3}."""
    d = points.shape[1]
    if bits is None:
        bits = default_bits(d)
    if bits * d > 63:
        raise ValueError(f"{bits} bits x {d} dims do not fit a 64-bit key")
    q = quantize_np(np.asarray(points, dtype=np.float64), bits)
    return _interleave_np(_axes_to_transpose_np(q, bits), bits)


def sfc_order(points: np.ndarray) -> np.ndarray:
    """Stable Hilbert-curve sort order of ``points`` (host)."""
    return np.argsort(hilbert_index_np(points), kind="stable")


def _picks(n: int, k: int, weights_sorted: np.ndarray | None) -> np.ndarray:
    """Sorted positions of the k initial centers: i*n/k + n/2k, or with
    weights the first position whose cumulative weight reaches
    (i + 1/2) * W/k. The prefix sum runs in float64 numpy in index order,
    the reference's order of additions."""
    if weights_sorted is None:
        idx = (np.arange(k) * n) // k + n // (2 * k)
        return np.minimum(idx, n - 1)
    cw = np.cumsum(np.asarray(weights_sorted, dtype=np.float64))
    targets = (np.arange(k) + 0.5) * (cw[-1] / k)
    return np.minimum(np.searchsorted(cw, targets), n - 1)


def sfc_initial_centers(points: np.ndarray, k: int,
                        weights: np.ndarray | None = None) -> np.ndarray:
    """Paper Alg. 2 line 7 on the host: centers at sorted positions
    i*n/k + n/2k, or equal-weight strides with node weights."""
    order = sfc_order(points)
    w = None if weights is None else np.asarray(weights)[order]
    return points[order[_picks(points.shape[0], k, w)]]


# ---------------------------------------------------------------------------
# torch version (same 64-bit keys, runs on the tensor's device)
# ---------------------------------------------------------------------------

def _axes_to_transpose_torch(cols: list, bits: int) -> list:
    """Skilling transform on a list of [n] int64 columns."""
    d = len(cols)
    Q = 1 << (bits - 1)
    while Q > 1:
        Pm = Q - 1
        for i in range(d):
            flag = (cols[i] & Q) != 0
            cols[0] = torch.where(flag, cols[0] ^ Pm, cols[0])
            t = torch.where(flag, 0, (cols[0] ^ cols[i]) & Pm)
            cols[0] = cols[0] ^ t
            cols[i] = cols[i] ^ t
        Q >>= 1
    for i in range(1, d):
        cols[i] = cols[i] ^ cols[i - 1]
    t = torch.zeros_like(cols[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        t = torch.where((cols[d - 1] & Q) != 0, t ^ (Q - 1), t)
        Q >>= 1
    return [c ^ t for c in cols]


def hilbert_index_torch(points: torch.Tensor, bits: int | None = None
                        ) -> torch.Tensor:
    """Hilbert key per point, int64, equal to ``hilbert_index_np``.
    points: [n, d] float64 on any device, d in {2, 3}."""
    d = points.shape[1]
    if bits is None:
        bits = default_bits(d)
    if bits * d > 63:
        raise ValueError(f"{bits} bits x {d} dims do not fit a 64-bit key")
    pts = points.to(torch.float64)
    lo = torch.min(pts, dim=0).values
    hi = torch.max(pts, dim=0).values
    span = torch.clamp_min(hi - lo, 1e-30)        # [d] tensor: true division
    scaled = (pts - lo) / span
    q = torch.clamp_max((scaled * float(2 ** bits)).to(torch.int64),
                        2 ** bits - 1)
    cols = _axes_to_transpose_torch([q[:, i] for i in range(d)], bits)
    key = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
    for b in range(bits - 1, -1, -1):
        for i in range(d):
            key = (key << 1) | ((cols[i] >> b) & 1)
    return key


def sfc_order_torch(points: torch.Tensor) -> torch.Tensor:
    """Stable Hilbert-curve order on the tensor's device (int64)."""
    return torch.sort(hilbert_index_torch(points), stable=True).indices


def _picks_torch(n: int, k: int, weights_sorted: torch.Tensor | None,
                 device: torch.device) -> torch.Tensor:
    """``_picks`` on ``device``, equal to it. The weighted prefix sum is
    ``kernels.scan.prefix_sum``, which adds in index order like numpy."""
    if weights_sorted is None:
        idx = ((torch.arange(k, dtype=torch.int64, device=device) * n) // k
               + n // (2 * k))
        return torch.clamp_max(idx, n - 1)
    from repro_torch.kernels.scan import prefix_sum
    cw = prefix_sum(weights_sorted)
    targets = ((torch.arange(k, dtype=torch.float64, device=device) + 0.5)
               * (cw[-1] / k))
    return torch.clamp_max(torch.searchsorted(cw, targets), n - 1)


def sfc_initial_centers_torch(points: torch.Tensor, k: int,
                              weights=None) -> torch.Tensor:
    """The bootstrap on the device of ``points`` ([n, d] float64): keys,
    stable sort and the strided or weighted picks all run there, and the
    result equals ``sfc_initial_centers`` exactly. ``weights`` ([n], a
    tensor or an array) are taken as float64 on that device."""
    order = sfc_order_torch(points)
    w = (None if weights is None else
         torch.as_tensor(weights, dtype=torch.float64,
                         device=points.device)[order])
    return points[order[_picks_torch(points.shape[0], k, w,
                                     points.device)]]


# ---------------------------------------------------------------------------
# int32 keys and the distributed bootstrap (the reference's jnp versions)
# ---------------------------------------------------------------------------

def default_bits_int32(d: int) -> int:
    return 15 if d == 2 else 10


def hilbert_index_int32(points: torch.Tensor, bits: int | None = None,
                        lo: torch.Tensor | None = None,
                        hi: torch.Tensor | None = None) -> torch.Tensor:
    """Hilbert key per point, int32, equal to the reference's
    ``hilbert_index_jnp``. points: [n, d] float32; ``lo``/``hi`` a global
    bounding box (all-reduced beforehand) so that shards quantize alike.
    The quantization divides by the span tensor (a true division)."""
    d = points.shape[1]
    if bits is None:
        bits = default_bits_int32(d)
    if bits * d > 31:
        raise ValueError(f"{bits} bits x {d} dims do not fit an int32 key")
    if lo is None:
        lo = torch.min(points, dim=0).values
    if hi is None:
        hi = torch.max(points, dim=0).values
    span = torch.clamp_min(hi - lo, 1e-30)
    scaled = (points - lo) / span
    q = torch.clamp((scaled * float(2 ** bits)).to(torch.int32), 0,
                    2 ** bits - 1)
    cols = _axes_to_transpose_torch([q[:, i] for i in range(d)], bits)
    key = torch.zeros(points.shape[0], dtype=torch.int32,
                      device=points.device)
    for b in range(bits - 1, -1, -1):
        for i in range(d):
            key = (key << 1) | ((cols[i] >> b) & 1)
    return key


def _bucket_sums(weights: torch.Tensor, bucket: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """Per-bucket sums of float32 ``weights`` as float32, the same on
    every device and in every run (no atomics): the weights stably sorted
    by bucket, a float64 prefix sum, and its differences at the run ends.
    Unit weights give the exact counts, as the reference's float32
    ``segment_sum`` does; other weights may differ from its sequential
    float32 adds by the rounding of those adds."""
    order = torch.sort(bucket, stable=True).indices
    cw = torch.cumsum(weights[order].to(torch.float64), 0)
    ends = torch.cumsum(torch.bincount(bucket.long(), minlength=n_buckets),
                        0)
    upto = torch.cat([torch.zeros(1, dtype=torch.float64,
                                  device=weights.device), cw])[ends]
    return torch.diff(upto, prepend=upto.new_zeros(1)).to(weights.dtype)


def _nearest_key(keys: torch.Tensor, splitters: torch.Tensor,
                 chunk: int = 1 << 16) -> tuple[torch.Tensor, torch.Tensor]:
    """For each splitter, the first index of the key nearest to it and
    that distance, |float32(key) - splitter| in float32 as the reference
    computes it, ties to the lowest index. The [k, n] distance matrix is
    never built: the keys are taken ``chunk`` at a time and a later chunk
    wins only with a strictly smaller distance."""
    kf = keys.to(torch.float32)
    best_d = torch.full_like(splitters, float("inf"))
    best_i = torch.zeros(splitters.shape[0], dtype=torch.int64,
                         device=keys.device)
    for s0 in range(0, kf.shape[0], chunk):
        kd = torch.abs(kf[None, s0:s0 + chunk] - splitters[:, None])
        d, i = torch.min(kd, dim=1)
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_i = torch.where(better, i + s0, best_i)
    return best_i, best_d


def sfc_initial_centers_sharded(points: torch.Tensor, weights: torch.Tensor,
                                k: int, comm, n_buckets: int = 1024
                                ) -> torch.Tensor:
    """The distributed SFC bootstrap (paper Alg. 2 lines 4-7 on a mesh),
    the reference's ``sfc_initial_centers_sharded``; ``bootstrap=
    "device"``. ``points`` [cap, d] float32 and ``weights`` [cap] are this
    rank's shard (padded slots at weight 0), ``comm`` its communicator.
    Three steps, each communicating O(k + n_buckets) numbers:

    1. int32 Hilbert keys against the global bounding box (min and max
       all-reduces);
    2. a summed weighted histogram of the keys' top bits, whose prefix
       sums place the k weighted-quantile splitter keys;
    3. for each splitter the point whose key is globally nearest (a min
       all-reduce of the distances, ties to the lowest shard id by a
       second min, the winner's coordinates by a sum).

    Returns [k, d] float32 centers, the same on every rank.
    """
    from repro_torch.core.balanced_kmeans import _f32_reciprocal
    d = points.shape[1]
    bits = default_bits_int32(d)
    shift = max(bits * d - int(np.log2(n_buckets)), 0)
    lo = comm.all_reduce(torch.min(points, dim=0).values, "min")
    hi = comm.all_reduce(torch.max(points, dim=0).values, "max")
    keys = hilbert_index_int32(points, bits=bits, lo=lo, hi=hi)

    bucket = keys >> shift
    hist = comm.all_reduce(_bucket_sums(weights, bucket, n_buckets))
    cum = torch.cumsum(hist, 0)
    total = torch.clamp_min(cum[-1], 1e-12)
    # the reference divides by the constant k under jit: a multiply by its
    # float32 reciprocal
    targets = ((torch.arange(k, dtype=cum.dtype, device=cum.device) + 0.5)
               * (total * _f32_reciprocal(k)))
    b = torch.clamp(torch.searchsorted(cum, targets), 0, n_buckets - 1)
    prev = torch.where(b > 0, cum[torch.clamp_min(b - 1, 0)],
                       torch.zeros_like(targets))
    frac = torch.clamp((targets - prev) / torch.clamp_min(hist[b], 1e-12),
                       0.0, 1.0)
    splitters = (b.to(torch.float32) + frac) * float(2 ** shift)

    # the nearest real point to each splitter: global minimum distance,
    # ties to the lowest shard id, then the shard's first index
    loc, loc_d = _nearest_key(keys, splitters)
    best_d = comm.all_reduce(loc_d, "min")
    me = comm.shard_id
    cand = torch.where(loc_d <= best_d, me, comm.size).to(torch.int32)
    winner = comm.all_reduce(cand, "min")
    contrib = torch.where((winner == me)[:, None], points[loc],
                          torch.zeros_like(points[loc]))
    return comm.all_reduce(contrib)
