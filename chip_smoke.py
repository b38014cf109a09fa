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
profiles a short main-shape run (device time by kernel), times each
kernel with CUDA events against its bound, and prints one JSON line of
kernel records. Every phase raises on failure. The last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed. Without a CUDA device, or without the rest of the repository
beside it, the script exits non-zero and prints no result.

``--phases card,build,kernels`` runs a subset; ``--quick`` drops the
main-shape kernel comparisons (a short first check of a new kernel).
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
PHASES = ("card", "build", "kernels", "main", "paths", "agreement",
          "profile", "timing")

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
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


def kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp, bc):
    """Padded (and for the sorted configuration, sorted) inputs as the
    registry adapters build them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.triton_assign import _pad_inputs
    if sorted_:
        inv2 = 1.0 / (infl * infl)
        order = ops._bbox_order(pts, ctr, inv2)
        p = ops._pad_rows(pts, bp, 0.0).contiguous()
        c = ops._pad_rows(ctr[order], bc, ops._FAR).contiguous()
        iv = ops._pad_rows(inv2[order], bc, 1.0).contiguous()
    else:
        p, c, iv = _pad_inputs(pts, ctr, infl, bp, bc)
    return p, c, iv, ops._pad_rows(w, bp, 0.0).contiguous()


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


def run_entry(name, inputs, k, bp, bc, precision, plain=False):
    wrapper, plain_fn, _, fused = entry_points()[name]
    p, c, iv, w = inputs
    if plain:
        return (plain_fn(p, c, iv, w, k, precision) if fused
                else plain_fn(p, c, iv, k, precision) + (None,))
    if fused:
        return wrapper(p, c, iv, w, k, block_p=bp, block_c=bc,
                       precision=precision)
    return wrapper(p, c, iv, k, block_p=bp, block_c=bc,
                   precision=precision) + (None,)


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


def compare_case(torch, case):
    n, k, d, bp, bc = case["shape"]
    spread = case.get("spread", 1.0)
    far = spread > 1e6
    pts, ctr, infl, w = make_inputs(torch, n, k, d, spread, seed=n + k + d,
                                    zero_tail=case.get("zero_tail", 0.0))
    for name, (_, _, sorted_, fused) in entry_points().items():
        inputs = kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp, bc)
        f32_plain = None
        for precision in ("f32", "bf16"):
            ki, kb, ks, km = run_entry(name, inputs, k, bp, bc, precision)
            pi, pb, ps, pm = run_entry(name, inputs, k, bp, bc, precision,
                                       plain=True)
            torch.cuda.synchronize()
            if precision == "f32":
                f32_plain = (pi, pb, ps)
            agree = float((ki == pi).float().mean())
            check(not bool(torch.isnan(kb).any() or torch.isnan(ks).any()),
                  f"{name} {case['shape']} {precision}: NaN in best/second")
            check(bool((torch.isinf(ks) == torch.isinf(ps)).all()),
                  f"{name} {case['shape']} {precision}: +inf pattern of "
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
                  f"{name} {case['shape']} {precision}: best differs "
                  f"(max |err| {err:.3g})")
            check(torch.allclose(ks[fin], ps[fin], rtol=rtol, atol=atol),
                  f"{name} {case['shape']} {precision}: second differs")
            check(agree >= LABELS_F32,
                  f"{name} {case['shape']} {precision}: labels agree "
                  f"{agree:.6f} < {LABELS_F32}")
            mom_rel = 0.0
            if fused:
                p, _, _, ww = inputs
                ref = moments_f64(torch, p, ww, ki, kb, km.shape[1])
                check(torch.allclose(km.double(), ref, rtol=MOM_RTOL,
                                     atol=MOM_ATOL * (1 + spread ** 2)),
                      f"{name} {case['shape']} {precision}: moments "
                      "differ from the float64 sums of its labels")
                if agree == 1.0:
                    check(torch.allclose(km, pm, rtol=MOM_RTOL,
                                         atol=MOM_ATOL * (1 + spread ** 2)),
                          f"{name} {case['shape']} {precision}: moments "
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
                      f"{name} {case['shape']}: bf16 flips {frac:.4f}")
                if flipped.any():
                    gap = float(torch.max(fs[flipped] - fb[flipped]))
                    check(gap <= BF16_GAP_MAX,
                          f"{name} {case['shape']}: bf16 flip off a "
                          f"near-tie (gap {gap:.3g})")
            log("kernels", f"{name} n={n} k={k} d={d} bp={bp} bc={bc} "
                f"{precision}{' far' if far else ''}: labels {agree:.6f}, "
                f"max |err| {err:.3g}, moments rel {mom_rel:.3g}")


def compare_backends(torch, case):
    """The registry adapters end to end on the card (sort, padding and
    un-sort included) against the dense torch backend, at the
    partitioner's tiles."""
    from repro_torch.kernels.ops import assign_backend
    n, k, d, bp, bc = case["shape"]
    pts, ctr, infl, w = make_inputs(torch, n, k, d, seed=7 * n + k)
    ref = assign_backend("torch")(pts, ctr, infl, weights=w,
                                  return_moments=True)
    for name in ("cuda", "cuda_flat"):
        out = assign_backend(name)(pts, ctr, infl, block_p=bp, block_c=bc,
                                   weights=w, return_moments=True)
        agree = float((out[0] == ref[0]).float().mean())
        check(agree >= LABELS_F32, f"backend {name}: labels {agree:.6f}")
        check(torch.allclose(out[1], ref[1], rtol=BEST_RTOL,
                             atol=BEST_ATOL), f"backend {name}: best")
        if agree == 1.0:
            for a, b in zip(out[3:], ref[3:]):
                check(torch.allclose(a, b, rtol=MOM_RTOL, atol=MOM_ATOL),
                      f"backend {name}: moments")
        log("kernels", f"backend {name} vs torch n={n} k={k} d={d}: "
            f"labels {agree:.6f}")


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
    if not quick:
        cases.append({"shape": (MAIN_N, MAIN_K, MAIN_D, bp, 128)})
    for case in cases:
        compare_case(torch, case)
    compare_backends(torch, {"shape": (5000, 100, 3, bp, 128)})
    compare_scan(torch)
    log("kernels", "every entry point agrees with its plain version")


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
    device_s = sum(r[0] for r in rows) / 1e6
    log("profile", f"n={MAIN_N} k={MAIN_K} max_iter=2: wall {wall:.3f} s "
        f"(bootstrap {st['seconds']['bootstrap']:.3f} s, k-means "
        f"{st['seconds']['kmeans']:.3f} s), sweeps {sweeps_of(st)}, device "
        f"busy {device_s:.3f} s = {device_s / wall:.1%} of wall  "
        f"[{ctx['card']}]")
    if not rows:
        log("profile", "the profiler recorded no device time: not measured")
    for us, count, key, _ in rows[:12]:
        log("profile", f"  {us / 1e3:10.3f} ms  {count:6d} calls  "
            f"{key[:70]}")


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


def bound(n, k, d, fused, blocks):
    """Least time for one sweep: float32 operations (2d for p.c, 7 for
    the expansion, clamp, scale and the two compares, per pair; 2(d+2)
    per point for the moments) over the CUDA-core peak, and bytes (each
    input read once, each output written once) over HBM bandwidth."""
    flops = n * k * (2 * d + 7) + (2 * (d + 2) * n if fused else 0)
    nbytes = 4 * (n * d + k * d + k + 3 * n)
    if fused:
        nbytes += 4 * (n + blocks * (d + 2) * k)
    return larger_bound(flops / PEAK_F32_FLOPS, nbytes)


def larger_bound(t_ops_s: float, nbytes: int):
    t_ops = t_ops_s * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_timing(torch, ctx):
    from repro_torch.kernels.assign_kernel import (grid_blocks,
                                                   points_per_thread)
    from repro_torch.kernels.ops import assign_backend
    bp = path_block_p()
    pts, ctr, infl, w = make_inputs(torch, MAIN_N, MAIN_K, MAIN_D, seed=3)
    for name, (_, _, sorted_, fused) in entry_points().items():
        inputs = kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp, 128)
        blocks = grid_blocks(MAIN_N, MAIN_D, MAIN_K, points_per_thread(bp),
                             0, fused, pts.device)
        rec = ctx["kernels"].setdefault(name, {})
        # the error and the times come from this one instance and input
        ki, kb, ks, _ = run_entry(name, inputs, MAIN_K, bp, 128, "f32")
        pi, pb, ps, _ = run_entry(name, inputs, MAIN_K, bp, 128, "f32",
                                  plain=True)
        rec["max_abs_err"] = best_second_err(torch, kb, ks, pb, ps)
        rec["ms"] = time_ms(torch, lambda: run_entry(
            name, inputs, MAIN_K, bp, 128, "f32"), iters=20)
        rec["ms_bf16"] = time_ms(torch, lambda: run_entry(
            name, inputs, MAIN_K, bp, 128, "bf16"), iters=20)
        rec["plain_ms"] = time_ms(torch, lambda: run_entry(
            name, inputs, MAIN_K, bp, 128, "f32", plain=True), iters=2,
            warmup=1)
        rec["bound_ms"], rec["bound_by"] = bound(MAIN_N, MAIN_K, MAIN_D,
                                                 fused, blocks)
        rec["library_ms"] = None
        log("timing", f"{name} n={MAIN_N} k={MAIN_K} d={MAIN_D} bp={bp}: "
            f"kernel {rec['ms']:.4f} ms (bf16 {rec['ms_bf16']:.4f} ms), "
            f"plain {rec['plain_ms']:.3f} ms, max |err| "
            f"{rec['max_abs_err']:.3g}, labels "
            f"{float((ki == pi).float().mean()):.6f}, {blocks} blocks, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), launches "
            f"{rec.get('launches')} on the {rec.get('path')} path  "
            f"[{ctx['card']}]")
    log("timing", "no single PyTorch call computes the fused argmin + "
        "best/second + moments sweep: library_ms is null")
    # what each backend adds around the fused kernel in one sweep: for
    # `cuda` the bbox sort of the centers, padding and the un-sort of
    # labels and moments; for `cuda_flat` the padding and slicing
    for backend, name in (("cuda", "assign_reduce"),
                          ("cuda_flat", "assign_reduce_flat")):
        fn = assign_backend(backend)
        ms = time_ms(torch, lambda: fn(pts, ctr, infl, block_p=bp,
                                       block_c=128, weights=w,
                                       return_moments=True), iters=20)
        kernel = ctx["kernels"][name]["ms"]
        log("timing", f"backend {backend} sweep n={MAIN_N} k={MAIN_K}: "
            f"{ms:.4f} ms, of which around the kernel {ms - kernel:.4f} ms"
            f"  [{ctx['card']}]")
    time_scan(torch, ctx)


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
    if "build" in phases:
        phase_build(torch, ctx)
    if "kernels" in phases:
        phase_kernels(torch, args.quick)
    if "main" in phases:
        phase_main(torch, ctx)
    if "paths" in phases:
        phase_paths(torch, ctx)
    if "agreement" in phases:
        phase_agreement(torch, ctx)
    if "profile" in phases:
        phase_profile(torch, ctx)
    if "timing" in phases:
        phase_timing(torch, ctx)
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
