"""The yardstick of the assign kernel's share of the card's bandwidth,
frozen here.

The byte count of one assign+reduce sweep is taken from the shapes of
the sweep's contract (``kernels/ops.py`` at commit 78792ac: ``fn(points,
centers, influence, weights=, return_moments=True) -> (idx, best, second,
csum, cw, rad2)``), not from what an implementation chooses to read. Each
byte that the sweep needs is counted once:

- in: the points [n, d] and weights [n] (float32), the centers [k, d] and
  the influence [k] (float32);
- out: the labels [n] (int32), the best and second effective distances
  [n] (float32; the solver's bounds read both), and the per-block moments
  [k, d + 2] (float32: the weighted coordinate sums, the weight and the
  weighted best distance).

A layout, padding, a per-thread-block partial or a second read of a point
is the implementation's own traffic and is not counted. No operation
bound is used: the pairs a pruned sweep computes are the implementation's
choice (``launch/kernel_roofline.py``'s ``cuda`` model counted them, so
its work changed with the kernel).

``PEAK_BYTES_PER_S`` holds the published HBM bandwidth of the card the
benchmark runs on, by the name ``torch.cuda.get_device_name()`` gives
(NVIDIA's H100 SXM data sheet, at the card's full power limit).
"""
from __future__ import annotations

PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

F32 = 4
I32 = 4


def sweep_bytes(n: int, d: int, k: int) -> int:
    """Bytes one fused assign+reduce sweep over n points in d dimensions
    and k centers needs to move, each counted once."""
    reads = n * d * F32 + n * F32 + k * d * F32 + k * F32
    writes = n * I32 + 2 * n * F32 + k * (d + 2) * F32
    return reads + writes


def bw_share(n: int, d: int, k: int, sweeps: int, seconds: float,
             kind: str) -> float | None:
    """The kernel's share of the card's peak bandwidth in %: the least time
    ``sweeps`` sweeps need at the card's peak bandwidth over the measured
    ``seconds``. None when the card is not in the table or nothing was
    timed."""
    peak = PEAK_BYTES_PER_S.get(kind)
    if peak is None or sweeps <= 0 or seconds <= 0:
        return None
    return 100.0 * sweeps * sweep_bytes(n, d, k) / peak / seconds
