"""Analytical + measured roofline for the partition assign kernel
(reference: ``repro/launch/kernel_roofline.py``).

``launch/roofline.py`` models the transformer stack from dry-run counts;
this module models the *partition hot loop*, the fused assign+reduce
sweep, analytically from its shape, so that predicted-vs-measured
utilization can be tracked.

The reference's backends keep its arithmetic, operation for operation:

* ``pallas`` / ``triton`` (the TPU kernels): a ``[BP, BC]`` distance tile
  per (point tile x center tile) grid step, ``2*BP*BC*d`` FLOPs plus an
  ``EPILOGUE_FLOPS_PER_CELL`` epilogue, times the live tiles
  (``1 - prune_frac``); the moments as a ``2*BP*(d+2)*K`` one-hot matmul a
  point tile; the points streamed once, the centers re-fetched per point
  tile, ``12*n`` bytes of idx/best/second and the ``4*(d+2)*K`` moment
  block;
* ``jnp`` (CPU hosts): the same FLOPs, plus ``JNP_SCRATCH_PASSES`` round
  trips of the dense ``[chunk, k]`` distance scratch.

The port's CUDA kernel (``kernels/csrc/assign.cu``) has its own:

* ``cuda`` (centers sorted by bounding box) and ``cuda_flat`` (unsorted):
  ``2d+7`` float32 operations per (point, center) pair computed (``2d``
  for p.c, 7 for the expansion, clamp, scale and the two compares), with
  ``n*k*(1-prune_frac)`` pairs computed; ``2(d+2)`` a point for the
  moments (a one-hot matmul is not what the kernel does: at the main cell
  its FLOPs alone would take longer than the kernel's measured time). Each
  input read once and each output written once: the points, the centers
  and ``inv2``, idx/best/second, with ``layout`` the layout's order, and
  fused the weights and the ``blocks`` per-block moment partials.

Arithmetic intensity AI = FLOPs / HBM bytes; predicted time =
max(FLOPs/peak, bytes/bw); utilization = predicted / measured (1.0 =
running at the roofline). Peaks are per-platform table entries
(``PLATFORMS``), deliberately coarse: utilization is tracked for
regressions, not absolute truth.
"""
from __future__ import annotations

import math

EPILOGUE_FLOPS_PER_CELL = 6.0   # norms add, scale, compare/select chain
JNP_SCRATCH_PASSES = 4.0        # eff write + argmin + mask + second-min
# the CUDA kernel's float32 operations per pair beyond the 2d of p.c
CUDA_FLOPS_PER_PAIR = 7.0

# Per-platform peaks. FLOP/s by distance-matmul precision; bytes/s HBM
# (or DRAM). The reference's rows as it has them (TPU per chip, v5e
# 197 TF bf16 / 819 GB/s, f32 at half MXU rate; cpu_host one
# container-class x86 core; gpu_a100 per device). h100: the NVIDIA H100
# SXM data sheet, dense, at 700 W: float32 on the CUDA cores, bf16 on the
# tensor cores, 3.35 TB/s HBM3 (spec figures, not measurements).
PLATFORMS = {
    "tpu_v5e": {"peak_flops": {"f32": 98.5e12, "bf16": 197e12},
                "hbm_bw": 819e9},
    "tpu_v4": {"peak_flops": {"f32": 137.5e12, "bf16": 275e12},
               "hbm_bw": 1.2e12},
    "gpu_a100": {"peak_flops": {"f32": 19.5e12, "bf16": 312e12},
                 "hbm_bw": 1.555e12},
    "h100": {"peak_flops": {"f32": 67e12, "bf16": 989e12},
             "hbm_bw": 3.35e12},
    "cpu_host": {"peak_flops": {"f32": 1.0e11, "bf16": 1.0e11},
                 "hbm_bw": 2.0e10},
}

CUDA_BACKENDS = ("cuda", "cuda_flat")


def detect_platform() -> str:
    """Map the card PyTorch sees (or the CPU) to a PLATFORMS key: an H100
    to ``h100``, an A100 to ``gpu_a100``, no card to ``cpu_host``.

    Raises:
        ValueError: a card with no row in PLATFORMS.
    """
    import torch
    if not torch.cuda.is_available():
        return "cpu_host"
    name = torch.cuda.get_device_name(0)
    if "H100" in name:
        return "h100"
    if "A100" in name:
        return "gpu_a100"
    raise ValueError(f"no roofline peaks for {name!r}; known: "
                     f"{sorted(PLATFORMS)}")


def _pad(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _block(flops, hbm_bytes):
    return {"flops": flops, "hbm_bytes": hbm_bytes,
            "ai": flops / max(hbm_bytes, 1.0)}


def _cuda_intensity(n, d, k, fused, prune_frac, blocks, layout):
    pairs = n * k * max(1.0 - prune_frac, 0.0)
    dist_flops = pairs * (2.0 * d + CUDA_FLOPS_PER_PAIR)
    mom_flops = 2.0 * (d + 2) * n if fused else 0.0
    # points, centers + inv2, idx/best/second, the layout's order
    dist_bytes = 4.0 * (n * d + k * (d + 1) + 3 * n + (n if layout else 0))
    # the weights and the per-block partials
    mom_bytes = 4.0 * (n + blocks * (d + 2) * k) if fused else 0.0
    return {"distance": _block(dist_flops, dist_bytes),
            "moments": _block(mom_flops, mom_bytes),
            "total": _block(dist_flops + mom_flops, dist_bytes + mom_bytes)}


def assign_intensity(n: int, d: int, k: int, *, block_p: int = 1024,
                     block_c: int = 128, fused: bool = True,
                     prune_frac: float = 0.0,
                     backend: str = "pallas", blocks: int | None = None,
                     layout: bool = True) -> dict:
    """FLOPs, HBM bytes and arithmetic intensity of one assign(+reduce)
    sweep, split into the distance and moment blocks. ``backend``
    selects the model: ``pallas``/``triton`` tiled kernels, the
    dense-scratch ``jnp`` path (the same FLOPs), or the port's CUDA kernel
    (``cuda``/``cuda_flat``, which alone read ``blocks``, the launch's
    blocks, default one a ``block_p`` point tile, and ``layout``)."""
    if backend in CUDA_BACKENDS:
        if blocks is None:
            blocks = -(-n // block_p)
        return _cuda_intensity(n, d, k, fused, prune_frac, blocks, layout)
    n_pad = _pad(n, block_p)
    k_pad = _pad(k, block_c)
    n_pt = n_pad // block_p
    n_ct = k_pad // block_c
    live_tiles = n_pt * n_ct * max(1.0 - prune_frac, 0.0)

    dist_flops = live_tiles * block_p * block_c * (
        2.0 * d + EPILOGUE_FLOPS_PER_CELL)
    mom_flops = n_pt * 2.0 * block_p * (d + 2) * k_pad if fused else 0.0

    bytes_points = 4.0 * n_pad * d          # streamed exactly once
    bytes_outputs = 12.0 * n_pad            # idx + best + second
    if backend == "jnp":
        # chunked dense path: the [chunk, k] scratch is written and then
        # re-traversed by the epilogue; when it exceeds cache this is
        # real DRAM traffic (the term the adaptive default_chunk shrinks)
        bytes_centers = 4.0 * (d + 1) * k   # fetched once, cache-resident
        bytes_scratch = JNP_SCRATCH_PASSES * 4.0 * n_pad * k
    else:
        # tiled kernels: centers + inv2 re-fetched per point tile
        bytes_centers = n_pt * 4.0 * (d + 1) * k_pad
        bytes_scratch = 0.0
    bytes_moments = 4.0 * (d + 2) * k_pad if fused else 0.0

    dist_bytes = bytes_points + bytes_centers + bytes_outputs + bytes_scratch
    mom_bytes = bytes_moments

    out = {"distance": _block(dist_flops, dist_bytes),
           "moments": _block(mom_flops, mom_bytes),
           "total": _block(dist_flops + mom_flops, dist_bytes + mom_bytes)}
    return out


def predict(n: int, d: int, k: int, *, platform: str | None = None,
            precision: str = "f32", block_p: int = 1024,
            block_c: int = 128, fused: bool = True,
            prune_frac: float = 0.0, backend: str = "pallas",
            blocks: int | None = None, layout: bool = True) -> dict:
    """Roofline prediction for one sweep: per-block AI, compute/memory
    times against the platform peaks, and the binding term."""
    if platform is None:
        platform = detect_platform()
    peaks = PLATFORMS[platform]
    peak_flops = peaks["peak_flops"][precision]
    bw = peaks["hbm_bw"]
    intensity = assign_intensity(n, d, k, block_p=block_p, block_c=block_c,
                                 fused=fused, prune_frac=prune_frac,
                                 backend=backend, blocks=blocks,
                                 layout=layout)
    total = intensity["total"]
    # bf16 only accelerates the distance matmul; the moment accumulation
    # and epilogue stay f32 — model the compute term per block
    dist_peak = peak_flops
    other_peak = peaks["peak_flops"]["f32"]
    compute_s = (intensity["distance"]["flops"] / dist_peak
                 + intensity["moments"]["flops"] / other_peak)
    memory_s = total["hbm_bytes"] / bw
    bound_s = max(compute_s, memory_s)
    return {
        "platform": platform, "precision": precision, "backend": backend,
        "n": n, "d": d, "k": k, "block_p": block_p, "block_c": block_c,
        "fused": fused, "prune_frac": prune_frac,
        "distance": intensity["distance"], "moments": intensity["moments"],
        "total_flops": total["flops"], "total_hbm_bytes": total["hbm_bytes"],
        "ai": total["ai"],
        "compute_s": compute_s, "memory_s": memory_s, "bound_s": bound_s,
        "bottleneck": "compute" if compute_s >= memory_s else "memory",
    }


def utilization(predicted_bound_s: float, measured_s: float) -> float:
    """Fraction of the roofline achieved (1.0 = at the bound)."""
    if not (measured_s > 0.0) or not math.isfinite(measured_s):
        return 0.0
    return predicted_bound_s / measured_s


def kernel_roofline_record(n: int, d: int, k: int, *,
                           measured_s: float | None = None,
                           platform: str | None = None,
                           precision: str = "f32", block_p: int = 1024,
                           block_c: int = 128, fused: bool = True,
                           prune_frac: float = 0.0,
                           backend: str = "pallas",
                           blocks: int | None = None,
                           layout: bool = True) -> dict:
    """The ``roofline`` record (the reference's schema): the prediction
    plus measured wall time and achieved utilization."""
    rec = predict(n, d, k, platform=platform, precision=precision,
                  block_p=block_p, block_c=block_c, fused=fused,
                  prune_frac=prune_frac, backend=backend, blocks=blocks,
                  layout=layout)
    rec["measured_s"] = measured_s
    rec["utilization"] = (None if measured_s is None
                          else utilization(rec["bound_s"], measured_s))
    return rec
