#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` (one
process per source, started together), holds every kernel entry point
against its plain PyTorch version on the card, at the shapes the
partitioner launches it with among others,
drives ``partition(problem, method="geographer")`` at n = 2^22 points and
k = 1024 blocks (unit and lognormal weights) plus the unfused and flat
paths, checks determinism and agreement with the port's CPU path,
profiles a short main-shape run (device time by kernel), serves
granite-moe-3b-a800m at full width through ``ServeEngine.run`` and through
``prefill`` -> ``extend_cache`` -> ``decode_step`` at a 4096-token prompt
(the paths of the MoE-router kernel and of the bf16 tensor-core
flash-attention kernel; the float32 CUDA-core flash kernel is held and
timed beside it), times each kernel with CUDA events against its bound,
and prints one JSON line of kernel records. Every phase raises on failure. The last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed. Without a CUDA device, or without the rest of the repository
beside it, the script exits non-zero and prints no result.

``--phases build,lm_kernels,serve,prefill`` runs a subset (the card
phase always runs); ``--quick`` drops the main-shape kernel comparisons
(a short first check of a new kernel).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("card", "build", "kernels", "lm_kernels", "main", "paths",
          "agreement", "profile", "serve", "prefill", "timing")

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # tensor cores
PEAK_F64_FLOPS = 34e12     # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

MAIN_N = 1 << 22
MAIN_K = 1024
MAIN_D = 3
EPS = 0.03
DEVICE = "cuda"

# tolerances of tests/test_kernels.py
BEST_RTOL, BEST_ATOL = 1e-4, 1e-5
MOM_RTOL, MOM_ATOL = 1e-4, 1e-4
LABELS_F32 = 0.99
BF16_FLIP_MAX, BF16_GAP_MAX = 0.05, 2.0 ** -6
# tolerances of tests/test_kernels_flash_router.py and test_arch_smoke.py.
# Flash in bfloat16 is held row by row (ref.row_relative_error: the
# largest |err| of a row over the largest |want| of that row). Measured on
# the H100 over the 12 bf16 shapes of phase_lm_kernels, the tensor-core
# kernel and SDPA both read at most 0.0084 (one bf16 ulp of a row's
# largest output is 2^-8 to 2^-7 of it): the limit 2e-2 leaves 2.4x
# headroom over both, and the broken copies of tools/flash_variants.py
# read 3.26 and 1.89 (PERF.md).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
ROUTER_TOL = 1e-4
LM_BF16_TOL = 5e-2

# granite-moe-3b-a800m serving shapes
SERVE_BATCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 6, 12, 16
SERVE_MAX_SEQ = 64
PREFILL_S, PREFILL_NEW = 4096, 16


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def phase_card(torch, ctx):
    ctx["card"] = card_line()
    # full float32 products for the plain versions (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("card", f"{ctx['card']}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build(torch, ctx):
    from repro_torch.kernels.build import build_libraries
    t0 = time.perf_counter()
    libs = build_libraries()
    log("build", f"{len(libs)} libraries in {time.perf_counter() - t0:.1f} s"
        " (one nvcc per source, started together)")
    for lib in libs.values():
        text = lib.ptxas_log
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", text)
        spilled = [s for s in spills if int(s[1]) or int(s[2])]
        entries = len(re.findall(r"Compiling entry function", text))
        log("build", f"{lib.path.name}: nvcc {lib.build_seconds:.1f} s, "
            f"{entries} kernels, max {max(regs, default=0)} registers, "
            f"{len(spilled)} with spills")
        for s in spilled:
            log("build", f"  {s[0]} bytes stack frame, {s[1]} bytes spill "
                f"stores, {s[2]} bytes spill loads")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_inputs(torch, n, k, d, spread=1.0, seed=0, zero_tail=0.0):
    import numpy as np
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, spread, (n, d))
    ctr = rng.uniform(0, spread, (k, d))
    infl = rng.uniform(0.5, 2.0, k)
    w = rng.uniform(0.5, 2.0, n)
    if zero_tail:
        w[int(n * (1 - zero_tail)):] = 0.0
    f = dict(dtype=torch.float32, device=torch.device(DEVICE))
    return (torch.tensor(pts, **f), torch.tensor(ctr, **f),
            torch.tensor(infl, **f), torch.tensor(w, **f))


def kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp, bc, layout=None):
    """Padded (and for the sorted configuration, sorted) inputs as the
    registry adapters build them: (points, centers, inv2, weights,
    order). With a ``layout`` the points are its Hilbert-ordered copy and
    ``order`` maps its rows to the caller's positions."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.triton_assign import _pad_inputs
    if layout is None:
        p, order, lo, hi = (ops._pad_rows(pts, bp, 0.0).contiguous(), None,
                            *ops._bbox(pts))
    else:
        p, order, lo, hi = layout.points, layout.order, layout.lo, layout.hi
    if sorted_:
        inv2 = 1.0 / (infl * infl)
        rank = ops._bbox_order(lo, hi, ctr, inv2)
        c = ops._pad_rows(ctr[rank], bc, ops._FAR).contiguous()
        iv = ops._pad_rows(inv2[rank], bc, 1.0).contiguous()
    else:
        c, iv = _pad_inputs(ctr, infl, bc)
    return p, c, iv, ops._pad_rows(w, bp, 0.0).contiguous(), order


def path_block_p() -> int:
    """The point tile the partitioner passes every assign backend
    (``BKMConfig.block_p``): the comparisons and timings at path shapes
    use it, so they hold the kernel instance the paths launch."""
    from repro_torch.core.balanced_kmeans import BKMConfig
    return BKMConfig(k=MAIN_K).block_p


def entry_points():
    from repro_torch.kernels import assign_kernel as ak
    from repro_torch.kernels import triton_assign as ta
    # name -> (wrapper, plain, sorted configuration, fused)
    return {
        "assign_reduce": (ak.assign_reduce_cuda, ak.assign_reduce_plain,
                          True, True),
        "assign_argmin": (ak.assign_argmin_cuda, ak.assign_argmin_plain,
                          True, False),
        "assign_reduce_flat": (ta.triton_assign_reduce_cuda,
                               ak.assign_reduce_plain, False, True),
        "assign_argmin_flat": (ta.triton_assign_cuda,
                               ak.assign_argmin_plain, False, False),
    }


def run_entry(name, inputs, k, bp, bc, precision, plain=False, pairs=None):
    wrapper, plain_fn, _, fused = entry_points()[name]
    p, c, iv, w, order = inputs
    if plain:
        return (plain_fn(p, c, iv, w, k, precision, order) if fused
                else plain_fn(p, c, iv, k, precision, order) + (None,))
    if fused:
        return wrapper(p, c, iv, w, k, block_p=bp, block_c=bc,
                       precision=precision, order=order, pairs=pairs)
    return wrapper(p, c, iv, k, block_p=bp, block_c=bc, precision=precision,
                   order=order, pairs=pairs) + (None,)


def run_unpruned(torch, name, inputs, k, bp, precision):
    """The same kernel instance with pruning off (every pair computed),
    launched directly so that no wrapper counts it."""
    from repro_torch.kernels.assign_kernel import (launch_sweep,
                                                   points_per_thread)
    fused = entry_points()[name][3]
    p, c, iv, w, order = inputs
    idx, best, second, part = launch_sweep(
        p, c, iv, w if fused else None, k, points_per_thread(bp), precision,
        order, prune=False)
    return idx, best, second, None if part is None else torch.sum(part, 0)


def moments_f64(torch, p, w, idx, best, kpad):
    """Float64 moments of the kernel's own labels: checks the kernel's
    accumulation independently of near-tie label flips."""
    d = p.shape[1]
    ok = idx >= 0
    i = idx[ok].long()
    stacked = torch.cat([p[ok], torch.ones_like(p[ok][:, :1]),
                         best[ok][:, None]], 1).double() * \
        w[ok].double()[:, None]
    m = torch.zeros(kpad, d + 2, dtype=torch.float64, device=p.device)
    m.index_add_(0, i, stacked)
    return m.T


def best_second_err(torch, kb, ks, pb, ps) -> float:
    """max |kernel - plain| over best and the finite seconds."""
    err = float(torch.max(torch.abs(kb - pb)))
    fin = torch.isfinite(ps)
    if fin.any():
        err = max(err, float(torch.max(torch.abs(ks[fin] - ps[fin]))))
    return err


def layout_inputs(torch, kind, n, k, d, adapted):
    """A layout case's points in the solver's (random) order, the
    bootstrap's centers (SFC picks: on the lattice these are lattice
    points, so exact ties abound), unit or adapted influence, weights."""
    import numpy as np
    from repro_torch.core.sfc import sfc_initial_centers_torch
    rng = np.random.default_rng(n + k + d)
    if kind == "clustered":
        mu = rng.uniform(0, 1, (64, d))
        pts = mu[rng.integers(0, 64, n)] + rng.normal(0, 0.01, (n, d))
    elif kind == "lattice":
        side = int(np.ceil(n ** (1 / d)))
        grid = np.stack(np.meshgrid(*[np.arange(side)] * d), -1)
        pts = grid.reshape(-1, d)[rng.permutation(side ** d)[:n]] * 0.125
    elif kind == "far":
        pts = rng.uniform(0, 1, (n, d)) * 1e9
    else:
        pts = rng.uniform(0, 1, (n, d))
    p64 = torch.tensor(pts, dtype=torch.float64, device=DEVICE)
    ctr = sfc_initial_centers_torch(p64, k).float().contiguous()
    infl = rng.uniform(0.8, 1.25, k) if adapted else np.ones(k)
    f = dict(dtype=torch.float32, device=torch.device(DEVICE))
    return (p64.float().contiguous(), ctr, torch.tensor(infl, **f),
            torch.tensor(rng.uniform(0.5, 2.0, n), **f))


def compare_case(torch, case):
    """Every entry point on one input, in f32 and bf16: first bit-equal
    (idx, best, second, moments) to the same kernel with pruning off, then
    against its plain version; prints the fraction of pairs it skipped. A
    layout case ("layout": the kind of points) feeds the kernel the
    Hilbert-ordered layout, where it prunes most."""
    from repro_torch.kernels.ops import _pad_rows, point_layout
    n, k, d, bp, bc = case["shape"]
    kind = case.get("layout")
    spread = 1e9 if kind == "far" else case.get("spread", 1.0)
    far = spread > 1e6
    if kind:
        pts, ctr, infl, w = layout_inputs(torch, kind, n, k, d,
                                          case.get("adapted", False))
        lay = point_layout(pts, bp)
    else:
        pts, ctr, infl, w = make_inputs(torch, n, k, d, spread,
                                        seed=n + k + d,
                                        zero_tail=case.get("zero_tail", 0.0))
        lay = None
    what = (f"{case['shape']}{f' {kind}' if kind else ''}"
            f"{' adapted' if case.get('adapted') else ''}")
    # the points in the solver's order, for the float64 moments
    p_solver = _pad_rows(pts, bp, 0.0)
    for name, (_, _, sorted_, fused) in entry_points().items():
        inputs = kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp, bc,
                               lay)
        f32_plain = None
        for precision in ("f32", "bf16"):
            pairs = torch.zeros(1, dtype=torch.int64, device=DEVICE)
            ki, kb, ks, km = run_entry(name, inputs, k, bp, bc, precision,
                                       pairs=pairs)
            skipped = 1.0 - int(pairs) / (inputs[0].shape[0] * k)
            unpruned = run_unpruned(torch, name, inputs, k, bp, precision)
            for label, a, b in zip(("idx", "best", "second", "moments"),
                                   (ki, kb, ks, km), unpruned):
                check(a is None or torch.equal(a, b),
                      f"{name} {what} {precision}: {label} differs from "
                      "the same kernel with pruning off")
            if lay is not None:
                if case.get("min_skipped") and precision == "f32":
                    check(skipped > case["min_skipped"],
                          f"{name} {what}: skipped {skipped:.4f} of the "
                          f"pairs, not above {case['min_skipped']}")
            pi, pb, ps, pm = run_entry(name, inputs, k, bp, bc, precision,
                                       plain=True)
            torch.cuda.synchronize()
            if precision == "f32":
                f32_plain = (pi, pb, ps)
            agree = float((ki == pi).float().mean())
            check(not bool(torch.isnan(kb).any() or torch.isnan(ks).any()),
                  f"{name} {what} {precision}: NaN in best/second")
            check(bool((torch.isinf(ks) == torch.isinf(ps)).all()),
                  f"{name} {what} {precision}: +inf pattern of "
                  "second differs")
            if k == 1:
                check(bool(torch.isinf(ks[:n]).all()),
                      f"{name}: k == 1 must give second = +inf")
            fin = torch.isfinite(ps)
            err = best_second_err(torch, kb, ks, pb, ps)
            # 1e9-scale coordinates cancel catastrophically in the
            # expansion; there the check is for NaN and label corruption
            rtol = 1e-2 if far else BEST_RTOL
            atol = 1e-6 * spread ** 2 if far else BEST_ATOL
            check(torch.allclose(kb, pb, rtol=rtol, atol=atol),
                  f"{name} {what} {precision}: best differs "
                  f"(max |err| {err:.3g})")
            check(torch.allclose(ks[fin], ps[fin], rtol=rtol, atol=atol),
                  f"{name} {what} {precision}: second differs")
            check(agree >= LABELS_F32,
                  f"{name} {what} {precision}: labels agree "
                  f"{agree:.6f} < {LABELS_F32}")
            mom_rel = 0.0
            if fused:
                p, ww = p_solver, inputs[3]
                ref = moments_f64(torch, p, ww, ki, kb, km.shape[1])
                check(torch.allclose(km.double(), ref, rtol=MOM_RTOL,
                                     atol=MOM_ATOL * (1 + spread ** 2)),
                      f"{name} {what} {precision}: moments "
                      "differ from the float64 sums of its labels")
                if agree == 1.0:
                    check(torch.allclose(km, pm, rtol=MOM_RTOL,
                                         atol=MOM_ATOL * (1 + spread ** 2)),
                          f"{name} {what} {precision}: moments "
                          "differ from the plain version")
                mom_rel = float(torch.max(torch.abs(km.double() - ref))
                                / torch.clamp_min(torch.max(torch.abs(ref)),
                                                  1e-30))
                if case.get("zero_tail"):
                    real = int(n * (1 - case["zero_tail"]))
                    sub = moments_f64(torch, p[:real], ww[:real],
                                      ki[:real], kb[:real], km.shape[1])
                    check(torch.allclose(km.double(), sub, rtol=MOM_RTOL,
                                         atol=MOM_ATOL),
                          f"{name}: zero-weight points changed the moments")
            if precision == "bf16" and not far and d <= 3:
                fi, fb, fs = f32_plain
                flipped = ki != fi
                frac = float(flipped.float().mean())
                # the 5% bound is the reference test's, at its shape; at
                # denser k the reference's own bf16 path flips more
                check(frac < BF16_FLIP_MAX or not case.get("bf16_rate"),
                      f"{name} {what}: bf16 flips {frac:.4f}")
                if flipped.any():
                    gap = float(torch.max(fs[flipped] - fb[flipped]))
                    check(gap <= BF16_GAP_MAX,
                          f"{name} {what}: bf16 flip off a "
                          f"near-tie (gap {gap:.3g})")
            log("kernels", f"{name} n={n} k={k} d={d} bp={bp} bc={bc} "
                f"{precision}{' far' if far else ''}"
                f"{f' layout {kind}' if kind else ''}"
                f"{' adapted' if case.get('adapted') else ''}: labels "
                f"{agree:.6f}, max |err| {err:.3g}, moments rel "
                f"{mom_rel:.3g}, skipped {skipped:.4f} of the pairs, "
                "bit-equal to pruning off")


def compare_backends(torch, case):
    """The registry adapters end to end on the card (sort, padding and
    un-sort included) against the dense torch backend, at the
    partitioner's tiles."""
    from repro_torch.kernels.ops import assign_backend, point_layout
    n, k, d, bp, bc = case["shape"]
    pts, ctr, infl, w = make_inputs(torch, n, k, d, seed=7 * n + k)
    ref = assign_backend("torch")(pts, ctr, infl, weights=w,
                                  return_moments=True)
    lay = point_layout(pts, bp)
    for name in ("cuda", "cuda_flat"):
        out = assign_backend(name)(pts, ctr, infl, block_p=bp, block_c=bc,
                                   weights=w, return_moments=True)
        # through the solve's layout: the same per-point results
        via = assign_backend(name)(pts, ctr, infl, block_p=bp, block_c=bc,
                                   weights=w, return_moments=True,
                                   layout=lay)
        for a, b in zip(out[:3], via[:3]):
            check(torch.equal(a, b), f"backend {name}: the layout changed "
                  "idx/best/second")
        for a, b in zip(out[3:], via[3:]):
            check(torch.allclose(a, b, rtol=MOM_RTOL, atol=MOM_ATOL),
                  f"backend {name}: moments through the layout")
        agree = float((out[0] == ref[0]).float().mean())
        check(agree >= LABELS_F32, f"backend {name}: labels {agree:.6f}")
        check(torch.allclose(out[1], ref[1], rtol=BEST_RTOL,
                             atol=BEST_ATOL), f"backend {name}: best")
        if agree == 1.0:
            for a, b in zip(out[3:], ref[3:]):
                check(torch.allclose(a, b, rtol=MOM_RTOL, atol=MOM_ATOL),
                      f"backend {name}: moments")
        log("kernels", f"backend {name} vs torch n={n} k={k} d={d}: "
            f"labels {agree:.6f}; with the layout: idx/best/second equal")


def compare_scan(torch):
    """The float64 prefix sum against numpy's cumsum (bit for bit: the
    kernel adds in index order) and against its plain version,
    ``torch.cumsum`` on the card, which adds in another order: both lie
    within (n - 1) * 2^-53 of the exact sum of positive weights."""
    import numpy as np
    from repro_torch.kernels.scan import prefix_sum, prefix_sum_plain
    for n, sigma in ((1, 0.5), (1000, 0.5), (2049, 2.0), (1 << 18, 0.5),
                     (MAIN_N, 0.5)):
        w = np.random.default_rng(n).lognormal(0.0, sigma, n)
        x = torch.from_numpy(w).to(DEVICE)
        got = prefix_sum(x)
        plain = prefix_sum_plain(x)
        torch.cuda.synchronize()
        check(np.array_equal(got.cpu().numpy(), np.cumsum(w)),
              f"prefix_sum n={n}: differs from np.cumsum")
        rtol = 2 * n * 2.0 ** -53
        err = float(torch.max(torch.abs(got - plain)))
        check(torch.allclose(got, plain, rtol=rtol, atol=0.0),
              f"prefix_sum n={n}: differs from torch.cumsum beyond {rtol:.3g}")
        log("kernels", f"prefix_sum n={n}: equals np.cumsum bit for bit; "
            f"max |err| against torch.cumsum {err:.3g}")


def phase_kernels(torch, quick):
    bp = path_block_p()
    cases = [
        {"shape": (2048, 32, 3, 256, 32), "bf16_rate": True},
        {"shape": (4096, 512, 2, 1024, 128)},
        {"shape": (777, 33, 2, 256, 32)},            # ragged n and k
        {"shape": (2048, 300, 3, 1024, 256)},
        {"shape": (512, 16, 16, 256, 16)},
        {"shape": (256, 8, 128, 256, 8)},
        {"shape": (300, 1, 2, 256, 128)},            # k == 1
        {"shape": (512, 9, 2, 256, 8), "spread": 1e9},   # far coordinates
        {"shape": (1000, 40, 3, 256, 32), "zero_tail": 0.25},
        {"shape": (9000, 200, 3, 4096, 128)},
        # the shapes the flat (n=2^20, k=1024) and unfused (n=2^18, k=256)
        # paths launch, at the partitioner's tile and at 256-point tiles
        # (one point per thread over several center tiles)
        {"shape": (1 << 20, MAIN_K, MAIN_D, bp, 128)},
        {"shape": (1 << 20, MAIN_K, MAIN_D, 256, 128)},
        {"shape": (1 << 18, 256, MAIN_D, bp, 128)},
        {"shape": (1 << 18, 256, MAIN_D, 256, 128)},
    ]
    # the Hilbert-ordered layout, where the kernel prunes: each is also
    # held bit-equal to the same kernel with pruning off
    cases += [
        {"shape": (1 << 20, MAIN_K, MAIN_D, bp, 128), "layout": "uniform",
         "min_skipped": 0.9},
        {"shape": (1 << 20, MAIN_K, MAIN_D, bp, 128), "layout": "uniform",
         "adapted": True},
        {"shape": (1 << 18, 256, MAIN_D, bp, 128), "layout": "clustered",
         "adapted": True},
        {"shape": (1 << 16, 64, MAIN_D, bp, 128), "layout": "lattice"},
        {"shape": (1 << 14, 32, 2, 256, 32), "layout": "lattice"},
        {"shape": (3000, 1, 2, 256, 128), "layout": "uniform"},     # k == 1
        {"shape": (100003, 100, MAIN_D, bp, 128), "layout": "uniform",
         "adapted": True},                                         # ragged
        {"shape": (4096, 9, 2, 256, 8), "layout": "far"},
    ]
    if not quick:
        cases.append({"shape": (MAIN_N, MAIN_K, MAIN_D, bp, 128)})
        cases += [{"shape": (MAIN_N, MAIN_K, MAIN_D, bp, 128),
                   "layout": "uniform", "min_skipped": 0.9},
                  {"shape": (MAIN_N, MAIN_K, MAIN_D, bp, 128),
                   "layout": "uniform", "adapted": True,
                   "min_skipped": 0.9}]
    for case in cases:
        compare_case(torch, case)
    compare_backends(torch, {"shape": (5000, 100, 3, bp, 128)})
    compare_scan(torch)
    log("kernels", "every entry point agrees with its plain version")


# ---------------------------------------------------------------------------
# phase 3b: the language-model kernels against their plain versions
# ---------------------------------------------------------------------------

def router_inputs(torch, T, E, D, seed, x_dtype, unit_influence):
    """Tokens ~N(0, 1) (the scale of RMS-normalized activations) and
    centroids at the model's init scale D^-0.5, on the card."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32,
                     device=DEVICE).to(x_dtype)
    c = torch.tensor(rng.standard_normal((E, D)) * D ** -0.5,
                     dtype=torch.float32, device=DEVICE)
    infl = (np.ones(E) if unit_influence else rng.uniform(0.5, 2.0, E))
    return x, c, torch.tensor(infl, dtype=torch.float32, device=DEVICE)


def compare_router(torch, T, E, D, K, seed, x_dtype, unit_influence):
    """ops.router_topk on the card (kernel) against the plain version on
    the same inputs: the effective distances within the tolerance, and
    each index held against the dense [T, E] distances the plain version
    sorts (ref.router_topk_disagreements: distinct experts, each named
    expert's distance, the stable order except at a tie)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_router_kernel import router_topk_plain
    from repro_torch.kernels.ref import (router_eff_ref,
                                         router_topk_disagreements)
    x, c, infl = router_inputs(torch, T, E, D, seed, x_dtype, unit_influence)
    idx, eff = ops.router_topk(x, c, infl, top_k=K)
    torch.cuda.synchronize()
    inv2 = 1.0 / (infl * infl)
    pidx, peff = router_topk_plain(x, c, inv2, K)
    full = router_eff_ref(x, c, inv2)
    torch.cuda.synchronize()
    what = f"router_topk T={T} E={E} D={D} K={K} {x_dtype}"
    err = float(torch.max(torch.abs(eff - peff)))
    check(torch.allclose(eff, peff, rtol=ROUTER_TOL, atol=ROUTER_TOL),
          f"{what}: eff differs (max |err| {err:.3g})")
    faults = router_topk_disagreements(idx, eff, full, rtol=ROUTER_TOL,
                                       atol=ROUTER_TOL)
    check(not faults, f"{what}: {'; '.join(faults)}")
    check(bool((torch.diff(eff, dim=1) >= 0).all()), f"{what}: not ascending")
    same = float((idx == pidx).float().mean())
    log("lm_kernels", f"{what}: indices equal {same:.6f} (the rest at "
        f"ties), max |eff err| {err:.3g}")


def flash_inputs(torch, B, S, H, KV, dh, dtype, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal((B, S, n, dh)),
                              dtype=torch.float32, device=DEVICE).to(dtype)
                 for n in (H, KV, KV))


def sdpa(torch, q, k, v):
    """SDPA on the [B, S, heads, dh] layout: the timing yardstick and the
    error yardstick, never on the port's path."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True).transpose(1, 2)


def compare_flash(torch, B, S, H, KV, dh, dtype, softcap=0.0, bq=512,
                  bk=512, seed=0):
    """ops.flash_attention on the card against the plain version on the
    same inputs. bfloat16 must go to the tensor-core kernel and is held
    row by row, with SDPA's error against the same plain version printed
    beside it (no softcap in SDPA); float32 must go to the CUDA-core kernel
    and is held at 2e-5 absolute. Returns (kernel error, SDPA error or
    None), per row in bf16, absolute in float32."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ref import row_relative_error
    q, k, v = flash_inputs(torch, B, S, H, KV, dh, dtype, seed)
    name = str(dtype).rsplit(".", 1)[-1]
    what = (f"flash_attention B={B} S={S} H={H} KV={KV} dh={dh} {name}"
            f"{f' softcap={softcap}' if softcap else ''}")
    kernel = "flash_attention_tc" if dtype == torch.bfloat16 \
        else "flash_attention"
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, bq=bq, bk=bk, softcap=softcap)
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    check(counts == {kernel: 1}, f"{what}: launched {counts}, expected "
          f"{kernel} once")
    want = flash_attention_plain(q, k, v, softcap)
    torch.cuda.synchronize()
    tol = FLASH_TOL[name]
    err = float(torch.max(torch.abs(got.float() - want.float())))
    check(bool(torch.isfinite(got.float()).all()), f"{what}: not finite")
    if dtype != torch.bfloat16:
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"{what}: differs from the plain version (max |err| "
              f"{err:.3g})")
        log("lm_kernels", f"{what} ({kernel}): max |err| {err:.3g} "
            f"(tolerance {tol})")
        return err, None
    rel = row_relative_error(got, want)
    ref_rel = None
    yard = "SDPA n/a (softcap)"
    if not softcap:
        ref = sdpa(torch, q, k, v)
        ref_rel = row_relative_error(ref, want)
        yard = (f"SDPA per-row {ref_rel:.3g}, max |err| "
                f"{float(torch.max(torch.abs(ref.float() - want.float()))):.3g}")
    check(rel <= tol, f"{what}: differs from the plain version (per-row "
          f"relative error {rel:.3g} > {tol}, max |err| {err:.3g})")
    log("lm_kernels", f"{what} ({kernel}): per-row relative error {rel:.3g} "
        f"(limit {tol}), max |err| {err:.3g}; {yard}")
    return rel, ref_rel


def phase_lm_kernels(torch):
    from repro_torch.configs import granite_moe_3b_a800m as granite
    cfg = granite.CONFIG
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    # the path's shapes: decode (T = batch 4) and a 4096-token prefill,
    # bf16 tokens at unit influence as the model hands them
    for T in (SERVE_BATCH, PREFILL_S):
        compare_router(torch, T, E, D, K, T, torch.bfloat16, True)
    # tests/test_kernels_flash_router.py's cases, float32 tokens
    for T, e, d, k in ((512, 8, 64, 1), (512, 16, 64, 2), (512, 40, 32, 8),
                       (300, 128, 128, 2), (512, 200, 64, 4),
                       (300, 256, 32, 8), (256, 384, 16, 2)):
        compare_router(torch, T, e, d, k, T + e, torch.float32, False)
    # flash in bf16 (the tensor-core kernel): the path's shape first, then
    # all five head dims, the softcap, GQA 3:1 and 4:1, MQA, ragged S and
    # B = 2
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kern, yard = [], []
    for B, S, h, kv, dh, cap in (
            (1, PREFILL_S, H, KV, hd, 0.0),        # the path, GQA 3:1
            (1, PREFILL_S + 4, H, KV, hd, 0.0),    # ragged S = 4100
            (2, 256, 4, 4, 32, 0.0),
            (1, 256, 2, 2, 64, 0.0),
            (1, 512, 8, 2, 64, 0.0),                # GQA 4:1
            (2, 384, 4, 1, 32, 0.0),                # MQA
            (1, 256, 4, 4, 128, 50.0),              # softcap
            (1, 300, 6, 2, 128, 0.0),               # ragged S = 300
            (1, 300, 3, 1, 16, 0.0),
            (2, 1024, 8, 2, 16, 0.0),
            (1, 320, 4, 1, 256, 0.0),               # gemma's dh
            (2, 200, 4, 2, 256, 30.0)):
        rel, ref_rel = compare_flash(torch, B, S, h, kv, dh, torch.bfloat16,
                                     cap)
        kern.append(rel)
        if ref_rel is not None:
            yard.append(ref_rel)
    log("lm_kernels", f"flash bf16 over {len(kern)} shapes: per-row "
        f"relative error at most {max(kern):.3g} (SDPA at most "
        f"{max(yard):.3g}), limit {FLASH_TOL['bfloat16']}")
    # flash in float32 (the CUDA-core kernel) at the tight tolerance: the
    # path's shape, where the outputs average thousands of values down to
    # a few hundredths, and tests/test_kernels_flash_router.py's cases
    compare_flash(torch, 1, PREFILL_S, H, KV, hd, torch.float32)
    for B, S, h, kv, dh, bq, bk, cap in (
            (2, 256, 4, 4, 32, 128, 128, 0.0),
            (1, 512, 8, 2, 64, 256, 128, 0.0),
            (2, 384, 4, 1, 32, 128, 128, 0.0),
            (1, 256, 4, 4, 128, 128, 128, 50.0),
            (1, 300, 3, 1, 16, 128, 128, 0.0),
            (2, 200, 4, 2, 256, 512, 512, 30.0)):
        compare_flash(torch, B, S, h, kv, dh, torch.float32, cap, bq, bk)
    log("lm_kernels", "the router and both flash kernels agree with their "
        "plain versions")


# ---------------------------------------------------------------------------
# phases 4-6: the partitioner
# ---------------------------------------------------------------------------

def sweeps_of(stats) -> int:
    it = int(stats["iters"])
    return int(round(float(stats["history"]["balance_iters"][:it].sum()))
               + int(stats["final_balance_iters"]))


def drive(torch, ctx, tag, problem, expect, **opts):
    """One counted run of ``partition()``: counts reset just before, read
    just after. ``expect`` maps each kernel the run must launch to its
    count (None: once a sweep); every other kernel and every plain version
    must not have run at all."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.partition import partition
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = partition(problem, **opts)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = res.stats["levels"][0]
    sweeps = sweeps_of(st)
    imb = res.imbalance()
    log(tag, f"n={problem.n} k={problem.k} {opts}: wall {wall:.2f} s, "
        f"bootstrap {st['seconds']['bootstrap']:.3f} s, k-means "
        f"{st['seconds']['kmeans']:.2f} s, iters {int(st['iters'])}, "
        f"sweeps {sweeps}, tiles_pruned_frac "
        f"{float(st['tiles_pruned_frac']):.4f}, imbalance {imb:.5f}, "
        f"counts {counts}")
    check(imb <= problem.epsilon + 1e-6,
          f"{tag}: imbalance {imb:.5f} > {problem.epsilon}")
    for name, count in counts.items():
        want = expect.get(name, 0)
        want = sweeps if want is None else want
        check(count == want, f"{tag}: {name} ran {count} times, expected "
              f"{want}")
    for name in expect:
        ctx["kernels"].setdefault(name, {}).update(launches=counts[name],
                                                   path=tag)
    return res


def phase_main(torch, ctx):
    import numpy as np
    from repro_torch.partition import PartitionProblem
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.0, 1.0, (MAIN_N, MAIN_D))
    prob = PartitionProblem(points=pts, k=MAIN_K, epsilon=EPS, seed=0)
    first = drive(torch, ctx, "main", prob, {"assign_reduce": None})
    again = drive(torch, ctx, "main-repeat", prob, {"assign_reduce": None})
    check(np.array_equal(first.labels, again.labels),
          "two identical main-path runs gave different labels")
    log("main", "two runs: labels bit-identical")
    ctx["main_state"] = (first.centers, first.influence)
    # the Hilbert layout the solve builds once (ops.point_layout), timed
    # alone on the solver's points
    from repro_torch.kernels.ops import point_layout
    solver_pts = main_state(torch, ctx)[0]
    ms = time_ms(torch, lambda: point_layout(solver_pts, path_block_p()),
                 iters=3, warmup=1)
    log("main", f"point layout (Hilbert keys, stable sort, copy, box) "
        f"built once per solve: {ms:.3f} ms at n={MAIN_N}  [{ctx['card']}]")
    w = np.random.default_rng(1).lognormal(0.0, 0.5, MAIN_N)
    wprob = PartitionProblem(points=pts, k=MAIN_K, weights=w, epsilon=EPS,
                             seed=0)
    drive(torch, ctx, "main-weighted", wprob,
          {"assign_reduce": None, "prefix_sum": 1})
    # the bootstrap on the card equals the host numpy bootstrap
    from repro_torch.core.sfc import (sfc_initial_centers,
                                      sfc_initial_centers_torch)
    sub = pts[: 1 << 18]
    for d in (2, 3):
        for weights in (None, w[: 1 << 18]):
            host = sfc_initial_centers(sub[:, :d], MAIN_K, weights)
            card = sfc_initial_centers_torch(
                torch.from_numpy(np.ascontiguousarray(sub[:, :d])).cuda(),
                MAIN_K, weights).cpu().numpy()
            check(np.array_equal(host, card),
                  f"bootstrap on the card differs from numpy (d={d})")
    log("main", "SFC bootstrap on the card equals numpy at n=2^18, "
        "d in {2, 3}, with and without weights")
    # the weighted picks at the main shape: the card's cumulative weights
    # and searchsorted against numpy's on the card's own Hilbert order
    from repro_torch.core.sfc import _picks, _picks_torch, sfc_order_torch
    pts_t = torch.from_numpy(pts).to(DEVICE)
    order = sfc_order_torch(pts_t)
    w_t = torch.from_numpy(w).to(DEVICE)[order]
    card = _picks_torch(MAIN_N, MAIN_K, w_t, pts_t.device).cpu().numpy()
    host = _picks(MAIN_N, MAIN_K, w[order.cpu().numpy()])
    check(np.array_equal(card, host), "weighted picks on the card differ "
          "from numpy's at the main shape")
    log("main", f"weighted picks at n={MAIN_N}, k={MAIN_K} equal numpy's")


def phase_paths(torch, ctx):
    import numpy as np
    from repro_torch.partition import PartitionProblem
    rng = np.random.default_rng(2)
    pts = rng.uniform(0.0, 1.0, (1 << 20, MAIN_D))
    prob = PartitionProblem(points=pts, k=MAIN_K, epsilon=EPS, seed=0)
    drive(torch, ctx, "flat", prob, {"assign_reduce_flat": None},
          backend="cuda_flat")
    small = PartitionProblem(points=pts[: 1 << 18], k=256, epsilon=EPS,
                             seed=0)
    drive(torch, ctx, "unfused", small, {"assign_argmin": None},
          fused=False)
    drive(torch, ctx, "unfused-flat", small, {"assign_argmin_flat": None},
          fused=False, backend="cuda_flat")


def phase_agreement(torch, ctx):
    import numpy as np
    from repro_torch.core import meshes
    from repro_torch.partition import PartitionProblem, partition
    for fam in ("delaunay2d", "rgg3d", "refined2d"):
        prob = PartitionProblem.from_mesh(meshes.REGISTRY[fam](1500, seed=0),
                                          k=16)
        gpu = partition(prob)
        cpu = partition(prob, device="cpu")
        agree = float(np.mean(gpu.labels == cpu.labels))
        log("agreement", f"{fam} n=1500 k=16: CUDA vs CPU labels "
            f"{agree:.4f}, imbalance {gpu.imbalance():.4f} / "
            f"{cpu.imbalance():.4f}")
        check(agree >= 0.99, f"{fam}: CUDA vs CPU agreement {agree:.4f}")
        check(max(gpu.imbalance(), cpu.imbalance()) <= EPS + 1e-6,
              f"{fam}: unbalanced")
    t0 = time.perf_counter()
    mesh = meshes.REGISTRY["delaunay3d"](131072, seed=0)
    log("quality", f"delaunay3d n={mesh.n} m={mesh.m} built in "
        f"{time.perf_counter() - t0:.1f} s")
    prob = PartitionProblem.from_mesh(mesh, k=64)
    for method in ("geographer", "sfc"):
        q = partition(prob, method=method, evaluate=True).quality
        log("quality", f"{method} k={prob.k}: totalCommVol "
            f"{q['totalCommVol']}, maxCommVol {q['maxCommVol']}, cut "
            f"{q['cut']}, imbalance {q['imbalance']:.5f}")
        check(q["imbalance"] <= EPS + 1e-6, f"{method}: unbalanced")
    # 128 points a block: geographer, the reference's included, ends above
    # eps here (ROADMAP.md queue 3); printed for the record, not gated
    res = partition(PartitionProblem.from_mesh(mesh, k=1024))
    log("quality", f"geographer k=1024: imbalance {res.imbalance():.5f}, "
        f"final_imbalance {res.stats['final_imbalance']:.5f}, iters "
        f"{int(res.stats['levels'][0]['iters'])} (not gated)")


def phase_profile(torch, ctx):
    """Where the main path's time goes: one short main-shape run (two
    movement iterations and the final balance pass) under torch.profiler,
    after an identical unprofiled run. Prints the wall time, the device's
    busy share of it, and device time by kernel."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.partition import PartitionProblem, partition
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (MAIN_N, MAIN_D))
    prob = PartitionProblem(points=pts, k=MAIN_K, epsilon=EPS, seed=0)
    partition(prob, max_iter=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = partition(prob, max_iter=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = res.stats["levels"][0]
    rows, device_s = device_rows(prof)
    log("profile", f"n={MAIN_N} k={MAIN_K} max_iter=2: wall {wall:.3f} s "
        f"(bootstrap {st['seconds']['bootstrap']:.3f} s, k-means "
        f"{st['seconds']['kmeans']:.3f} s), sweeps {sweeps_of(st)}, device "
        f"busy {device_s:.3f} s = {device_s / wall:.1%} of wall  "
        f"[{ctx['card']}]")
    log_rows("profile", rows)


def device_rows(prof):
    """(rows, device seconds) of a profile: (us, calls, name) of each
    device-side event, largest first."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key, str(e.device_type)))
    # device-side events (kernels, copies) carry the time once; keep only
    # those where the profiler tells them apart from the host ops
    on_device = [r for r in rows if r[3].endswith("CUDA")]
    rows = sorted(on_device or rows, reverse=True)
    return rows, sum(r[0] for r in rows) / 1e6


def log_rows(tag, rows, n=12):
    if not rows:
        log(tag, "the profiler recorded no device time: not measured")
    for us, count, key, _ in rows[:n]:
        log(tag, f"  {us / 1e3:10.3f} ms  {count:6d} calls  {key[:70]}")


# ---------------------------------------------------------------------------
# phases 9-10: granite-moe-3b-a800m served at full width
# ---------------------------------------------------------------------------

def granite_params(torch, ctx):
    """granite CONFIG's parameters, made on the card from a seeded
    generator once and kept for the serve and prefill phases."""
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.models import model as M
    if "lm_params" not in ctx:
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        t0 = time.perf_counter()
        ctx["lm_params"] = M.init_params(granite.CONFIG, gen, device=DEVICE)
        torch.cuda.synchronize()
        log("serve", f"{granite.CONFIG.name}: {M.param_count(ctx['lm_params']):,}"
            f" parameters (float32) made on the card in "
            f"{time.perf_counter() - t0:.1f} s")
    return granite.CONFIG, ctx["lm_params"]


def lm_counts_after(torch, ctx, tag, expect, t0, record=None):
    """Counts and wall seconds of the run started at ``t0`` (counts reset
    just before it). Every counter not in ``expect`` must be 0. The
    kernels in ``record`` (default: all of ``expect``) keep this run's
    launches for the kernels line."""
    from repro_torch.kernels.ops import launch_counts
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for name, count in counts.items():
        want = expect.get(name, 0)
        check(count == want, f"{tag}: {name} ran {count} times, expected "
              f"{want}")
    for name in expect if record is None else record:
        ctx["kernels"].setdefault(name, {}).update(launches=counts[name],
                                                   path=tag)
    return wall, counts


def phase_serve(torch, ctx):
    import numpy as np
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.serve import Request, ServeEngine
    cfg, params = granite_params(torch, ctx)
    engine = ServeEngine(cfg, None, params, batch=SERVE_BATCH,
                         max_seq=SERVE_MAX_SEQ)
    step_fn = engine.step_fn
    steps = []

    def counted(*args):
        steps.append(1)
        return step_fn(*args)

    engine.step_fn = counted
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               (SERVE_PROMPT,)).astype(np.int32),
                    max_new=SERVE_NEW) for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    engine.run(reqs)
    n_steps = len(steps)
    wall, counts = lm_counts_after(torch, ctx, "serve", {
        "router_topk": cfg.n_layers * n_steps}, t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_tok = sum(len(r.out) for r in reqs)
    for r in reqs:
        check(r.done and len(r.out) == SERVE_NEW and
              all(0 <= t < cfg.vocab_size for t in r.out),
              f"serve: request {r.uid} transcript {r.out}")
    log("serve", f"{cfg.name} batch {SERVE_BATCH}, {SERVE_REQUESTS} requests "
        f"x {SERVE_PROMPT}-token prompts, {SERVE_NEW} new tokens each: "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} tokens/s, "
        f"{n_steps} decode steps at {wall / n_steps * 1e3:.2f} ms a step, "
        f"router launches {counts['router_topk']} = {cfg.n_layers} x "
        f"{n_steps}, peak memory {peak:.2f} GiB  [{ctx['card']}]")
    for r in reqs[:2]:
        log("serve", f"request {r.uid}: {r.out}")
    profile_decode(torch, ctx, engine, step_fn)
    serve_agreement(torch)


def profile_decode(torch, ctx, engine, step_fn, steps=4):
    """Where a decode step's time goes: ``steps`` steps of the engine's
    serve step at batch 4 under torch.profiler, after the counted run.
    Prints the wall time a step, the device's busy share and device time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile
    cache = engine._fresh_cache()
    tok = torch.zeros(engine.B, 1, dtype=torch.int32, device=DEVICE)
    step_fn(engine.params, cache, tok, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in range(1, steps + 1):
            tok, cache, _ = step_fn(engine.params, cache, tok, p)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows, device_s = device_rows(prof)
    log("serve", f"profile of {steps} decode steps at batch {engine.B}: "
        f"wall {wall / steps * 1e3:.2f} ms a step under the profiler, "
        f"device busy {device_s / steps * 1e3:.2f} ms a step = "
        f"{device_s / wall:.1%} of wall, "
        f"{sum(r[1] for r in rows) // steps} device events a step  "
        f"[{ctx['card']}]")
    log_rows("serve", rows, n=10)


def serve_agreement(torch):
    """The same engine on granite SMOKE in float32, on the card (router
    kernel) and on the CPU (plain version), from one set of parameters:
    the transcripts must be equal."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine
    cfg = dataclasses.replace(granite.SMOKE, dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = _to_device(cpu, DEVICE)
    out = []
    for params in (card, cpu):
        rng = np.random.default_rng(1)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, (n,))
                        .astype(np.int32), max_new=8)
                for i, n in enumerate((5, 3, 7, 4, 6, 2))]
        ServeEngine(cfg, None, params, batch=4, max_seq=32).run(reqs)
        out.append([r.out for r in reqs])
    check(out[0] == out[1], f"serve: granite SMOKE float32 transcripts "
          f"differ between the card and the CPU: {out}")
    log("serve", "granite SMOKE float32, 6 requests at batch 4: card "
        "(router kernel) and CPU (plain version) transcripts equal")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_prefill(torch, ctx):
    import numpy as np
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.models import model as M
    cfg, params = granite_params(torch, ctx)
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, PREFILL_S)), dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, {"tokens": toks}, cfg)
    # the bf16 prefill goes through the tensor-core kernel only: the
    # float32 flash kernel must not run (lm_counts_after checks every
    # counter not named here is 0)
    wall, counts = lm_counts_after(torch, ctx, "prefill", {
        "flash_attention_tc": cfg.n_layers, "router_topk": cfg.n_layers}, t0,
        record=("flash_attention_tc", "flash_attention"))   # the router's
    # line reads serve's launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(logits.shape == (1, 1, cfg.vocab_padded) and
          bool(torch.isfinite(logits.float()).all()),
          "prefill: logits not finite or of the wrong shape")
    cache = M.extend_cache(cache, cfg, PREFILL_S + PREFILL_NEW)
    out = []
    nxt = greedy(torch, logits, cfg)
    t1 = time.perf_counter()
    for t in range(PREFILL_NEW):
        out.append(int(nxt[0, 0]))
        logits, cache = M.decode_step(params, cache, {"tokens": nxt},
                                      PREFILL_S + t, cfg)
        nxt = greedy(torch, logits, cfg)
    torch.cuda.synchronize()
    dec = time.perf_counter() - t1
    t2 = time.perf_counter()
    M.prefill(params, {"tokens": toks}, cfg)
    torch.cuda.synchronize()
    again = time.perf_counter() - t2
    log("prefill", f"{cfg.name} B=1 S={PREFILL_S}: prefill {wall:.3f} s "
        f"(repeat {again:.3f} s), flash launches: tensor cores "
        f"{counts['flash_attention_tc']} (the model's q/k/v passed its "
        f"layout checks), CUDA cores {counts['flash_attention']}; router "
        f"launches "
        f"{counts['router_topk']}, peak memory {peak:.2f} GiB; "
        f"{PREFILL_NEW} decode steps after it {dec:.3f} s, tokens {out}  "
        f"[{ctx['card']}]")
    del ctx["lm_params"]
    torch.cuda.empty_cache()
    prefill_agreement(torch, cfg, params)


def greedy(torch, logits, cfg):
    lf = logits.float()
    lf[..., cfg.vocab_size:] = float("-inf")
    return torch.argmax(lf, dim=-1).to(torch.int32)


def prefill_agreement(torch, cfg, params):
    """Two layers at full width, S = 4096: prefill (flash kernel) against
    token-by-token decode from scratch (dense attention against the
    cache), both with the router kernel. Drop-free expert capacity, as
    the reference's own decode-vs-forward test: a full-sequence MoE drops
    tokens at capacity, a one-token step never does. Prefill's last
    logits, and the logits of the steps after it fed the same tokens,
    agree within the bf16 tolerance, and the 8 greedy tokens are equal."""
    import dataclasses
    import numpy as np
    from repro_torch.models import model as M
    depth = 2
    cfg2 = dataclasses.replace(
        cfg, n_layers=depth, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    p2 = dict(params, layers={k: {kk: _index_repeats(vv, depth)
                                  for kk, vv in v.items()}
                              for k, v in params["layers"].items()})
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, PREFILL_S)), dtype=torch.int32, device=DEVICE)
    horizon = PREFILL_S + 8
    t0 = time.perf_counter()
    lp, cache_p = M.prefill(p2, {"tokens": toks}, cfg2)
    cache_p = M.extend_cache(cache_p, cfg2, horizon)
    cache_d = M.init_cache(cfg2, 1, horizon, device=DEVICE)
    for t in range(PREFILL_S):
        ld, cache_d = M.decode_step(p2, cache_d, {"tokens": toks[:, t:t + 1]},
                                    t, cfg2)
    torch.cuda.synchronize()
    errs = [float(torch.max(torch.abs(lp.float() - ld.float())))]
    check(torch.allclose(lp.float(), ld.float(), rtol=LM_BF16_TOL,
                         atol=LM_BF16_TOL),
          f"prefill vs stepwise decode: last logits differ ({errs[0]:.3g})")
    for t in range(8):
        a, b = greedy(torch, lp, cfg2), greedy(torch, ld, cfg2)
        check(torch.equal(a, b), f"prefill vs stepwise decode: greedy token "
              f"{t} differs ({int(a)} vs {int(b)})")
        lp, cache_p = M.decode_step(p2, cache_p, {"tokens": b},
                                    PREFILL_S + t, cfg2)
        ld, cache_d = M.decode_step(p2, cache_d, {"tokens": b},
                                    PREFILL_S + t, cfg2)
        errs.append(float(torch.max(torch.abs(lp.float() - ld.float()))))
        check(torch.allclose(lp.float(), ld.float(), rtol=LM_BF16_TOL,
                             atol=LM_BF16_TOL),
              f"prefill vs stepwise decode: step {t} logits differ "
              f"({errs[-1]:.3g})")
    log("prefill", f"agreement at depth {depth}, full width, S={PREFILL_S}: "
        f"prefill vs {PREFILL_S} one-token steps, max |logit err| "
        f"{max(errs):.3g} over the last prompt position and 8 steps after "
        f"(tolerance {LM_BF16_TOL}); the 8 greedy tokens equal; "
        f"{time.perf_counter() - t0:.1f} s")


def _index_repeats(tree, n):
    if isinstance(tree, dict):
        return {k: _index_repeats(v, n) for k, v in tree.items()}
    return tree[:n]


# ---------------------------------------------------------------------------
# phase 8: timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n, k, d, fused, blocks, pairs=None, layout=False):
    """Least time for one sweep: float32 operations (2d for p.c, 7 for
    the expansion, clamp, scale and the two compares, per pair computed;
    2(d+2) per point for the moments) over the CUDA-core peak, and bytes
    (each input read once, each output written once: points, centers and
    inv2, idx/best/second, with the layout its order, fused the weights
    and the per-block partials) over HBM bandwidth. ``pairs``: the pairs
    this run computed (the kernel's count); None for all n*k, the dense
    bound."""
    pairs = n * k if pairs is None else pairs
    flops = pairs * (2 * d + 7) + (2 * (d + 2) * n if fused else 0)
    nbytes = 4 * (n * d + k * (d + 1) + 3 * n + (n if layout else 0))
    if fused:
        nbytes += 4 * (n + blocks * (d + 2) * k)
    return larger_bound(flops / PEAK_F32_FLOPS, nbytes)


def larger_bound(t_ops_s: float, nbytes: int):
    t_ops = t_ops_s * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_timing(torch, ctx):
    time_assign(torch, ctx)
    time_scan(torch, ctx)
    time_lm(torch, ctx)


def main_state(torch, ctx):
    """The main cell's state for the kernel timings: its points (uniform,
    n = 2^22, seed 0) in the solver's order (the partitioner's seed-0
    permutation), the bootstrap's centers, and the main run's final
    centers and influence (a run is made here if phase main was not)."""
    import numpy as np
    from repro_torch.core.sfc import sfc_initial_centers_torch
    from repro_torch.partition import PartitionProblem, partition
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (MAIN_N, MAIN_D))
    if "main_state" not in ctx:
        res = partition(PartitionProblem(points=pts, k=MAIN_K, epsilon=EPS,
                                         seed=0))
        ctx["main_state"] = (res.centers, res.influence)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(MAIN_N))
    p64 = torch.from_numpy(pts).to(DEVICE)
    f = dict(dtype=torch.float32, device=torch.device(DEVICE))
    return (p64[perm.to(DEVICE)].float().contiguous(),
            sfc_initial_centers_torch(p64, MAIN_K).float().contiguous(),
            torch.tensor(ctx["main_state"][0], **f),
            torch.tensor(ctx["main_state"][1], **f))


def time_assign(torch, ctx):
    """The four entry points at the main cell's state, in the layout the
    solver hands them (its final centers and influence, then the
    bootstrap's centers) and in random order (nothing prunes there): the
    kernel's time in f32 and bf16, the pairs it skipped (its own count),
    the bound of the work it did beside the dense bound, the plain
    version's time, and what each backend adds around the kernel."""
    from repro_torch.kernels.assign_kernel import (grid_blocks,
                                                   points_per_thread)
    from repro_torch.kernels.ops import assign_backend, point_layout
    bp = path_block_p()
    pts, boot, final_c, final_i = main_state(torch, ctx)
    ones = torch.ones(MAIN_K, device=DEVICE)
    w = torch.ones(MAIN_N, device=DEVICE)      # the main cell's weights
    lay = point_layout(pts, bp)
    # the last state drops the order: the same pruned work with outputs
    # written and weights read in layout order, which prices the scatter
    # and gather the solver's own point order costs
    states = (("layout, final centers and influence", final_c, final_i,
               lay),
              ("layout, bootstrap centers", boot, ones, lay),
              ("random order, bootstrap centers", boot, ones, None),
              ("layout without its order (no scatter, no gather), final "
               "state", final_c, final_i, lay))
    for name, (_, _, sorted_, fused) in entry_points().items():
        blocks = grid_blocks(MAIN_N, MAIN_D, MAIN_K, points_per_thread(bp),
                             0, fused, pts.device)
        dense, _ = bound(MAIN_N, MAIN_K, MAIN_D, fused, blocks)
        rec = ctx["kernels"].setdefault(name, {})
        for i, (state, ctr, infl, layout) in enumerate(states):
            inputs = kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp,
                                   128, layout)
            if i == 3:
                inputs = inputs[:4] + (None,)
            pairs = torch.zeros(1, dtype=torch.int64, device=DEVICE)
            ki, kb, ks, _ = run_entry(name, inputs, MAIN_K, bp, 128, "f32",
                                      pairs=pairs)
            torch.cuda.synchronize()
            computed = int(pairs)
            ms = time_ms(torch, lambda: run_entry(
                name, inputs, MAIN_K, bp, 128, "f32"), iters=20)
            ms16 = time_ms(torch, lambda: run_entry(
                name, inputs, MAIN_K, bp, 128, "bf16"), iters=20)
            bnd, by = bound(MAIN_N, MAIN_K, MAIN_D, fused, blocks, computed,
                            layout is not None)
            extra = ""
            if i == 0:
                # the kernels line: the error and the times of this one
                # instance and input, the state the main path ends in
                pi, pb, ps, _ = run_entry(name, inputs, MAIN_K, bp, 128,
                                          "f32", plain=True)
                rec["max_abs_err"] = best_second_err(torch, kb, ks, pb, ps)
                rec["plain_ms"] = time_ms(torch, lambda: run_entry(
                    name, inputs, MAIN_K, bp, 128, "f32", plain=True),
                    iters=2, warmup=1)
                rec.update(ms=ms, bound_ms=bnd, bound_by=by,
                           library_ms=None)
                extra = (f", plain {rec['plain_ms']:.3f} ms, max |err| "
                         f"{rec['max_abs_err']:.3g}, labels "
                         f"{float((ki == pi).float().mean()):.6f}, launches "
                         f"{rec.get('launches')} on the {rec.get('path')} "
                         "path")
            log("timing", f"{name} n={MAIN_N} k={MAIN_K} d={MAIN_D} bp={bp} "
                f"{state}: kernel {ms:.4f} ms (bf16 {ms16:.4f} ms), skipped "
                f"{1 - computed / (MAIN_N * MAIN_K):.4f} of the pairs, bound "
                f"of the work done {bnd:.4f} ms ({by}), dense bound "
                f"{dense:.4f} ms, {blocks} blocks{extra}  [{ctx['card']}]")
    log("timing", "no single PyTorch call computes the fused argmin + "
        "best/second + moments sweep: library_ms is null")
    # what each backend adds around the fused kernel in one sweep of the
    # main path (its layout, the final state): for `cuda` the bbox sort
    # of the centers, padding and the un-sort of labels and moments; for
    # `cuda_flat` the padding and slicing
    for backend, name in (("cuda", "assign_reduce"),
                          ("cuda_flat", "assign_reduce_flat")):
        fn = assign_backend(backend)
        ms = time_ms(torch, lambda: fn(pts, final_c, final_i, block_p=bp,
                                       block_c=128, weights=w,
                                       return_moments=True, layout=lay),
                     iters=20)
        kernel = ctx["kernels"][name]["ms"]
        log("timing", f"backend {backend} sweep n={MAIN_N} k={MAIN_K} "
            f"(layout, final state): {ms:.4f} ms, of which around the "
            f"kernel {ms - kernel:.4f} ms  [{ctx['card']}]")


def time_scan(torch, ctx):
    import numpy as np
    from repro_torch.kernels.scan import prefix_sum, prefix_sum_plain
    w = np.random.default_rng(1).lognormal(0.0, 0.5, MAIN_N)
    x = torch.from_numpy(w).to(DEVICE)
    rec = ctx["kernels"].setdefault("prefix_sum", {})
    rec["max_abs_err"] = float(np.max(np.abs(prefix_sum(x).cpu().numpy()
                                             - np.cumsum(w))))
    rec["ms"] = time_ms(torch, lambda: prefix_sum(x), iters=5)
    # the plain version is the library call: one torch.cumsum
    rec["plain_ms"] = time_ms(torch, lambda: prefix_sum_plain(x), iters=20)
    rec["library_ms"] = time_ms(torch, lambda: torch.cumsum(x, dim=0),
                                iters=20)
    rec["bound_ms"], rec["bound_by"] = larger_bound(
        MAIN_N / PEAK_F64_FLOPS, 16 * MAIN_N)
    log("timing", f"prefix_sum n={MAIN_N} float64: kernel {rec['ms']:.4f} "
        f"ms, plain (torch.cumsum) {rec['plain_ms']:.4f} ms, library "
        f"{rec['library_ms']:.4f} ms, max |err| against np.cumsum "
        f"{rec['max_abs_err']:.3g}, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}), launches {rec.get('launches')} on the "
        f"{rec.get('path')} path  [{ctx['card']}]")
    # the weighted picks on the card against the host step they replaced:
    # the order to the host, numpy's gather, cumsum and searchsorted, and
    # the picks back (host clock, each ended by a synchronize)
    from repro_torch.core.sfc import _picks, _picks_torch
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    order = torch.randperm(MAIN_N, device=DEVICE, generator=gen)

    def on_card():
        return _picks_torch(MAIN_N, MAIN_K, x[order], x.device)

    def on_host():
        return torch.from_numpy(_picks(MAIN_N, MAIN_K, w[order.cpu().numpy()])
                                ).to(DEVICE)

    check(torch.equal(on_card(), on_host()),
          "weighted picks: card and host differ")
    card_ms, host_ms = wall_ms(torch, on_card), wall_ms(torch, on_host)
    log("timing", f"weighted picks n={MAIN_N} k={MAIN_K}: on the card "
        f"{card_ms:.3f} ms, the host step {host_ms:.3f} ms (median of 5, "
        f"host clock)  [{ctx['card']}]")


def wall_ms(torch, fn, iters: int = 5) -> float:
    """Median host-clock milliseconds of ``fn`` ended by a synchronize."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def time_lm(torch, ctx):
    """The language-model kernels at the path's shapes: the router at
    granite's prefill (T = 4096, bf16 tokens) and decode (T = 4), both
    flash kernels at one granite layer of a 4096-token prefill. Each row's
    error comes from the instance and inputs it times."""
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.kernels import ops
    from repro_torch.kernels.moe_router_kernel import (router_topk_cuda,
                                                       router_topk_plain)
    cfg = granite.CONFIG
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    rec = ctx["kernels"].setdefault("router_topk", {})
    for T in (SERVE_BATCH, PREFILL_S):
        x, c, infl = router_inputs(torch, T, E, D, T, torch.bfloat16, True)
        inv2 = 1.0 / (infl * infl)
        _, eff = router_topk_cuda(x, c, inv2, K)
        _, peff = router_topk_plain(x, c, inv2, K)
        err = float(torch.max(torch.abs(eff - peff)))
        ms = time_ms(torch, lambda: router_topk_cuda(x, c, inv2, K),
                     iters=50)
        wrapped = time_ms(torch, lambda: ops.router_topk(x, c, infl,
                                                         top_k=K), iters=50)
        plain = time_ms(torch, lambda: router_topk_plain(x, c, inv2, K),
                        iters=20)
        # 2 D + 3 float32 operations a (token, expert) pair; bytes: x in
        # bf16, centroids and inv2 in f32 read once, idx + eff written
        bnd, by = larger_bound(T * E * (2 * D + 3) / PEAK_F32_FLOPS,
                               2 * T * D + 4 * E * (D + 1) + 8 * T * K)
        log("timing", f"router_topk T={T} E={E} D={D} K={K} bf16: kernel "
            f"{ms:.4f} ms (through ops.router_topk {wrapped:.4f} ms), "
            f"plain {plain:.4f} ms, max |err| {err:.3g}, bound {bnd:.4f} ms "
            f"({by})  [{ctx['card']}]")
        if T == PREFILL_S:
            rec.update(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bnd,
                       bound_by=by, library_ms=None)
    log("timing", "router_topk: no single PyTorch call computes the top-k "
        "smallest effective distances (a cdist + topk is two calls and "
        "orders ties otherwise): library_ms is null")
    time_flash(torch, ctx, cfg)


def time_flash(torch, ctx, cfg):
    """One granite layer of a 4096-token prefill: the tensor-core kernel
    (bf16), SDPA on the same inputs, and the CUDA-core kernel on the same
    inputs in float32 (SDPA in float32 beside it), in turns
    (tc, SDPA, f32, SDPA f32, then the reverse) in this one run."""
    from repro_torch.kernels.flash_attention import (flash_attention_f32,
                                                     flash_attention_plain,
                                                     flash_attention_tc)
    from repro_torch.kernels.ref import row_relative_error
    B, S, H, KV, dh = 1, PREFILL_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = flash_inputs(torch, B, S, H, KV, dh, torch.bfloat16, 5)
    qf, kf, vf = (t.float() for t in (q, k, v))
    runs = {
        "flash_attention_tc": (lambda: flash_attention_tc(q, k, v), 20),
        "sdpa": (lambda: sdpa(torch, q, k, v), 20),
        "flash_attention": (lambda: flash_attention_f32(qf, kf, vf), 10),
        "sdpa_f32": (lambda: sdpa(torch, qf, kf, vf), 10),
    }
    order = list(runs)
    times = {name: [] for name in runs}
    for name in order + order[::-1]:
        fn, iters = runs[name]
        times[name].append(time_ms(torch, fn, iters=iters))
    flops = 4 * dh * H * S * (S + 1) // 2 * B
    for name, x, plain_in, peak, lib, width in (
            ("flash_attention_tc", q, (q, k, v), PEAK_BF16_FLOPS, "sdpa", 2),
            ("flash_attention", qf, (qf, kf, vf), PEAK_F32_FLOPS, "sdpa_f32",
             4)):
        fn = runs[name][0]
        got = fn()
        want = flash_attention_plain(*plain_in)
        rec = ctx["kernels"].setdefault(name, {})
        rec["max_abs_err"] = float(torch.max(torch.abs(got.float() -
                                                       want.float())))
        rel = row_relative_error(got, want)
        rec["ms"] = sum(times[name]) / len(times[name])
        rec["library_ms"] = sum(times[lib]) / len(times[lib])
        rec["plain_ms"] = time_ms(torch, lambda: flash_attention_plain(
            *plain_in), iters=3, warmup=1)
        rec["bound_ms"], rec["bound_by"] = larger_bound(
            flops / peak, width * B * S * dh * (2 * H + 2 * KV))
        log("timing", f"{name} B={B} S={S} H={H} KV={KV} dh={dh} "
            f"{str(x.dtype).rsplit('.', 1)[-1]}: kernel {rec['ms']:.4f} ms "
            f"(runs {', '.join(f'{t:.4f}' for t in times[name])}), SDPA "
            f"{rec['library_ms']:.4f} ms (runs "
            f"{', '.join(f'{t:.4f}' for t in times[lib])}), plain "
            f"{rec['plain_ms']:.3f} ms, max |err| {rec['max_abs_err']:.3g}, "
            f"per-row relative {rel:.3g}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}) = {rec['bound_ms'] / rec['ms']:.1%} of "
            f"the kernel's time, {flops / rec['ms'] / 1e9:.1f} TFLOP/s, "
            f"launches {rec.get('launches')} on the {rec.get('path')} path"
            f"  [{ctx['card']}]")


# name -> (source, the TPU kernel or host step it replaces)
KERNEL_META = {
    "assign_reduce": ("assign.cu", "src/repro/kernels/assign_kernel.py:374"),
    "assign_argmin": ("assign.cu", "src/repro/kernels/assign_kernel.py:317"),
    "assign_reduce_flat": ("assign.cu",
                           "src/repro/kernels/triton_assign.py:171"),
    "assign_argmin_flat": ("assign.cu",
                           "src/repro/kernels/triton_assign.py:132"),
    # no TPU kernel: the reference's host np.cumsum of the bootstrap
    "prefix_sum": ("scan.cu", "src/repro/core/sfc.py:221"),
    "router_topk": ("router.cu",
                    "src/repro/kernels/moe_router_kernel.py:100"),
    # bf16, the prefill's: tensor cores
    "flash_attention_tc": ("flash_attention_tc.cu",
                           "src/repro/kernels/flash_attention.py:93"),
    # float32: CUDA cores (checks only, no user path)
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:93"),
}


def kernels_json(ctx) -> str:
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    out = []
    for name, (source, replaces) in KERNEL_META.items():
        rec = ctx["kernels"].get(name, {})
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{source}",
                 "replaces": replaces}
        entry.update({k: rec.get(k) for k in keys})
        out.append(entry)
    return json.dumps({"kernels": out})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--quick", action="store_true",
                    help="skip the main-shape kernel comparisons")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    ctx = {"kernels": {}}
    phase_card(torch, ctx)
    run = {"build": lambda: phase_build(torch, ctx),
           "kernels": lambda: phase_kernels(torch, args.quick),
           "lm_kernels": lambda: phase_lm_kernels(torch),
           "main": lambda: phase_main(torch, ctx),
           "paths": lambda: phase_paths(torch, ctx),
           "agreement": lambda: phase_agreement(torch, ctx),
           "profile": lambda: phase_profile(torch, ctx),
           "serve": lambda: phase_serve(torch, ctx),
           "prefill": lambda: phase_prefill(torch, ctx),
           "timing": lambda: phase_timing(torch, ctx)}
    t_all = time.perf_counter()
    for name in PHASES[1:]:
        if name in phases:
            t0 = time.perf_counter()
            run[name]()
            log("time", f"phase {name}: {time.perf_counter() - t0:.1f} s")
    log("time", f"all phases: {time.perf_counter() - t_all:.1f} s")
    print(kernels_json(ctx))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
