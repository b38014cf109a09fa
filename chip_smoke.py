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
profiles a short main-shape run (device time by kernel), drives the
load-balance time series warm and cold on the main cell's points
(``simulate_loadbalance``, its scan-semantics twin and ``repartition``)
and on the repartition benchmark's mesh, the hierarchical (32 x 32)
solve of the main cell, and the partition server over the serving
benchmark's tenant fleet, warm and cold, refines with label propagation
(the rounds on the card against the CPU and the dense plain version on
the quality mesh; ``partition(refine=True)`` on a 2048 x 2048 triangle
mesh at k = 1024, and ``repartition(refine=True)`` warm on it), drives the
multi-device path (``partition(devices=1)`` over NCCL against
``partition()``; four gloo ranks sharing the card for ``devices=4`` and
``(2, 2)``, the device bootstrap, the agreement with CPU ranks,
``evaluate_sharded``, warm steps, the hierarchy, and the sharded
refinement rounds on the triangle mesh against the single card's), drives
the paper's §4.1 SFC redistribution (``make_distributed_partitioner``:
a sample sort over ``all_to_all``, strided centers, balanced k-means on
each rank's stretch of the curve) on the main cell at ``devices=1`` over
NCCL and inside the same four-rank launch, runs
the paper's §5 matrix (every method over the mesh zoo, refined and
evaluated over four ranks in one launch, every row gated), then serves
granite-moe-3b-a800m at full width through ``ServeEngine.run`` and through
``prefill`` -> ``extend_cache`` -> ``decode_step`` at a 4096-token prompt
(the paths of the MoE-router kernel and of the bf16 tensor-core
flash-attention kernel) and prefills it again with float32 activations
(the path of the float32 CUDA-core flash kernel), serves the dense decoder family and the SSM configs at published widths
(phi3-mini, phi4-mini, starcoder2, gemma3, musicgen, internvl2, llama4,
jamba and rwkv6; internvl2, llama4 and jamba cut in depth to fit the card)
through the same entry points, with launch counts per layer kind,
card-vs-CPU transcripts on each SMOKE and each SSM layer's time at
S = 4096 with its recurrence's share, trains (autograd through the flash
and router kernels, SMOKE steps card vs CPU, remat bit-equal), drives
the training loop (granite and gemma3 SMOKE through
``launch.train.main``; granite at full width through ``Trainer``:
trained, preempted by a SIGINT, its 40.5 GB checkpoint written under
``build/`` and restored into the abstract state, trained on), trains
granite over two data ranks and serves granite and gemma3 over two
``model`` ranks (``make_host_mesh(1, 2)``: heads, MLP, experts and
vocabulary split) sharing the card against one rank, times each
kernel with CUDA events against its bound, dry-runs on ``meta`` tensors
(``launch.dryrun``, no model on the card) every cell whose peak memory it
measured and gates the estimate within 10% of the measured peak (each
rank of the data=2, model=2 training runs and of the model=2 serving runs
traced alone on its own ``meta`` mesh, its collectives a step gated equal
to what its communicator counted), dry-runs granite's ``train_4k`` on a
rank of the 16 x 16 production pod (memory, fit, per-rank roofline), prints
the first MFU readings (``launch.roofline.model_flops``) of the trainer's
step and granite's prefill and the main sweep's
``kernel_roofline_record``, and prints one JSON line of kernel records.
Every phase raises on failure. The last line is ``{"ok": true,
"device": {...}}`` and is printed only when every phase passed. Without a CUDA device, or without the rest of the repository
beside it, the script exits non-zero and prints no result.

``--phases build,lm_kernels,serve,prefill`` runs a subset (the card
phase always runs); ``--quick`` drops the main-shape kernel comparisons
(a short first check of a new kernel). Every path's kernel launches are
counted from 0 just before it and read just after; the kernels line
carries them under ``launches_by_path``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("card", "build", "kernels", "lm_kernels", "main", "paths",
          "agreement", "profile", "repartition", "hierarchical", "pserve",
          "refine", "sharded", "experiments", "serve", "prefill", "archs",
          "train", "trainer", "trainer_dp", "serve_tp", "timing",
          "roofline")

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # tensor cores
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
# prefill (flash) against 4,096 one-token decode steps (dense attention)
# with float32 activations: the two attentions differ only in the order of
# float32 sums (~1e-6 of an output), which the layer and the head carry
# into the logits; 1e-3 absolute and relative leaves them two orders of
# magnitude
LM_F32_TOL = 1e-3
LM_TOL = {"bfloat16": LM_BF16_TOL, "float32": LM_F32_TOL}

# the load-balance time series on the main cell's points (T steps), and
# the full configuration of benchmarks/repartition.py: (family, n, k,
# seed, T)
REPART_T = 8
REPART_BENCH = ("delaunay2d", 30_000, 16, 5, 12)
HIER = (32, 32)
# the batched and sequential lanes held bit-identical on the main cell's
# first 2^20 points (the whole cell until the serve_tp phase, PERF.md §5)
HIER_TWIN_N = 1 << 20
HIER_CPU_N, HIER_CPU = 1 << 16, (8, 8)
# the full configuration of benchmarks/serving.py: (n, k) per tenant on
# delaunay2d meshes seeded 10 + i, tiers, slots, steps
PSERVE_TENANTS = ((7000, 16), (8192, 16), (14000, 32), (16000, 32))
PSERVE_TIERS = (2048, 4096, 8192, 16384)
PSERVE_SLOTS, PSERVE_T, PSERVE_CACHE = 2, 12, 64
# refinement: the quality mesh at k = 64 for the agreement; tri at n = 2^22
# (2048 x 2048) with k = MAIN_K, then T warm steps (2: cut from 3 for
# time, PERF.md §5), for the full size
QUALITY_N = 131072
REFINE_QUALITY_K = 64
REFINE_N = 1 << 22
REFINE_T = 2
# the multi-device path: P ranks on the one card (gloo), the 2-D mesh, the
# agreement cell (the main cell's first 2^16 points at k = 64: at k = 1024
# such a cut has 64 points a block, where the solver itself does not
# balance, ROADMAP.md queue 3 item 5), T warm steps, the hierarchy
SHARDED_P = 4
SHARDED_MESH = (2, 2)
SHARDED_AGREE_N, SHARDED_AGREE_K = 1 << 16, 64
SHARDED_T = 3
SHARDED_HIER = (8, 8)
# cut for time (PERF.md §5): the hierarchy over the ranks on the main
# cell's first 2^20 points, the sharded refinement on tri at n = 2^20
# (1024 x 1024; the single-card refine phase keeps REFINE_N)
SHARDED_HIER_N = 1 << 20
SHARDED_REFINE_N = 1 << 20
# the distributed partitioner's balance gate: the main cell's points at
# k = 64 (at k = 1024 its clustered warm-up ends unbalanced, as the
# reference's does: ROADMAP.md queue 3 item 17)
REDIST_BALANCE_K = 64
# the paper's §5 matrix: every method over the mesh zoo at n = 2^13 points
# a family (refined3d twice that) and k = 64, 128 points a block (cut
# from 2^17 and 2^16 points at k = 256, and 2^14 at k = 128, for time,
# PERF.md §5: every rank builds every mesh on the host), over SHARDED_P
# ranks; the small matrix that goes through run_matrix's own launch
EXPERIMENTS = {"n": 1 << 13, "k": 64, "seed": 0}
EXPERIMENTS_SMALL = {"n": 1 << 12, "k": 16, "seed": 0,
                     "families": ["tri", "climate25d"],
                     "methods": ["geographer", "sfc"]}

# granite-moe-3b-a800m serving shapes (4 requests, one round of the batch,
# and 8 decode steps after a prefill: cut from 6 and 16 for time, PERF.md
# §5; the archs phase takes the same)
SERVE_BATCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 4, 12, 16
SERVE_MAX_SEQ = 64
PREFILL_S, PREFILL_NEW = 4096, 8
# the cells the roofline phase dry-runs, as launch.shapes.ShapeCell's
# (name, seq, batch, mode): the engine's serve (a cache of SERVE_MAX_SEQ
# at batch SERVE_BATCH) and the prefill at B=1
SERVE_CELL = ("serve_engine", SERVE_MAX_SEQ, SERVE_BATCH, "decode")
PREFILL_CELL = ("prefill_4k", PREFILL_S, 1, "prefill")
# phi3-mini's prefill attention (B, S, H, KV, dh): the flash kernels at dh 96
PHI3_FLASH = (1, PREFILL_S, 32, 32, 96)
# PREFILL_S is a multiple of Mamba's chunk (128) and RWKV's (16). At a
# ragged S each takes the whole sequence as one chunk, as the reference
# does: jamba's Mamba chunk then holds [B, S, 16384, 16] float32 tensors
# (about 4.3 GB each at S = 4100), and RWKV's time mix overflows float32
# past S ~ 176 (ROADMAP.md queue 3 item 18).


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(tag: str, msg: str) -> None:
    print(f"[{tag}] {msg}", flush=True)


def lap(what: str, t0: float) -> float:
    """Log the host seconds since ``t0`` as a ``[time]`` line of a phase's
    part; return the clock."""
    now = time.perf_counter()
    log("time", f"{what}: {now - t0:.1f} s")
    return now


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
    log_build(libs)


def log_build(libs):
    """What ptxas said of each library's kernels: registers and spills;
    for the float32 flash kernel, each head-dim instance's."""
    for lib in libs.values():
        if lib.name == "flash_attention":
            for block in lib.ptxas_log.split("Compiling entry function")[1:]:
                dh = re.search(r"flash_fwd_kernelILi(\d+)E", block)
                regs = re.search(r"Used (\d+) registers", block)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", block)
                if dh and regs and spill:
                    log("build", f"flash_attention.cu dh {dh.group(1)}: "
                        f"{regs.group(1)} registers, {spill.group(1)} bytes "
                        f"spill stores, {spill.group(2)} bytes spill loads")
        text = lib.ptxas_log
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = re.findall(r"Function properties for (\S+)\s+"
                            r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", text)
        spilled = [s for s in spills if int(s[2]) or int(s[3])]
        entries = len(re.findall(r"Compiling entry function", text))
        log("build", f"{lib.path.name}: nvcc {lib.build_seconds:.1f} s, "
            f"{entries} kernels, max {max(regs, default=0)} registers, "
            f"{len(spilled)} with spills")
        for s in spilled:
            log("build", f"  {s[0]}: {s[1]} bytes stack frame, {s[2]} bytes "
                f"spill stores, {s[3]} bytes spill loads")


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


ROUTER_MODES = ("unit", "multiply", "divide")


def router_call(torch, mode, x, c, infl, K, plain=False):
    """The kernel (through ``ops``) or its plain version in one of the three
    modes, and the dense [T, E] distances the plain version sorts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import moe_router_kernel as mr
    from repro_torch.kernels.ref import router_eff_div_ref, router_eff_ref
    if mode == "multiply":
        inv2 = 1.0 / (infl * infl)
        if plain:
            return mr.router_topk_plain(x, c, inv2, K), \
                router_eff_ref(x, c, inv2)
        return ops.router_topk(x, c, infl, top_k=K)
    i = infl if mode == "divide" else None
    if plain:
        return mr.router_topk_divide_plain(x, c, i, K), \
            router_eff_div_ref(x, c, i)
    return ops.router_topk_divide(x, c, i, top_k=K)


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def compare_router(torch, T, E, D, K, seed, x_dtype, mode):
    """The kernel on the card against the plain version on the same inputs
    in one mode: the effective distances within the tolerance, each index
    held against the dense [T, E] distances the plain version sorts
    (ref.router_topk_disagreements: distinct experts, each named expert's
    distance, the stable order except at a tie), and a second launch
    bit-identical to the first."""
    from repro_torch.kernels.ref import router_topk_disagreements
    x, c, infl = router_inputs(torch, T, E, D, seed, x_dtype,
                               mode == "unit")
    idx, eff = router_call(torch, mode, x, c, infl, K)
    idx2, eff2 = router_call(torch, mode, x, c, infl, K)
    (pidx, peff), full = router_call(torch, mode, x, c, infl, K, plain=True)
    torch.cuda.synchronize()
    what = (f"router_topk T={T} E={E} D={D} K={K} "
            f"{str(x_dtype).rsplit('.', 1)[-1]} {mode}")
    check(torch.equal(idx, idx2) and same_bits(torch, eff, eff2),
          f"{what}: two launches differ")
    err = float(torch.max(torch.abs(eff - peff)))
    check(torch.allclose(eff, peff, rtol=ROUTER_TOL, atol=ROUTER_TOL),
          f"{what}: eff differs (max |err| {err:.3g})")
    faults = router_topk_disagreements(idx, eff, full, rtol=ROUTER_TOL,
                                       atol=ROUTER_TOL)
    check(not faults, f"{what}: {'; '.join(faults)}")
    check(bool((torch.diff(eff, dim=1) >= 0).all()), f"{what}: not ascending")
    same = float((idx == pidx).float().mean())
    log("lm_kernels", f"{what}: indices equal {same:.6f} (the rest at "
        f"ties), max |eff err| {err:.3g}, repeat bit-identical")
    return err


def router_planted(torch, T, K, x_dtype):
    """Planted near-ties (ref.router_near_tie_case: integer-valued inputs,
    exact dot products) at granite's widths: the divide form must equal the
    reference's arithmetic (the plain divide on the card) bit for bit in
    idx and eff, and the multiply form must rank every planted pair the
    other way, so that a kernel that multiplied would fail here."""
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.kernels.ref import router_near_tie_case
    cfg = granite.CONFIG
    E, D = cfg.moe.n_experts, cfg.d_model
    x, c, infl = (torch.from_numpy(a).to(DEVICE) for a in
                  router_near_tie_case(T, E, D, seed=T + K))
    x = x.to(x_dtype)
    idx, eff = router_call(torch, "divide", x, c, infl, K)
    midx, _ = router_call(torch, "multiply", x, c, infl, K)
    (pidx, peff), _ = router_call(torch, "divide", x, c, infl, K, plain=True)
    torch.cuda.synchronize()
    what = (f"router_topk planted near-ties T={T} E={E} D={D} K={K} "
            f"{str(x_dtype).rsplit('.', 1)[-1]}")
    check(torch.equal(idx, pidx) and same_bits(torch, eff, peff),
          f"{what}: the divide form differs from the reference's arithmetic")
    check(bool((midx[:, 1] != pidx[:, 1]).all()),
          f"{what}: the multiply form did not flip every planted pair")
    log("lm_kernels", f"{what}: divide form bit-equal to the reference's "
        "arithmetic; the multiply form flips every planted pair")


def router_exact_ties(torch, T, x_dtype):
    """Each centroid twice (expert e and e + E/2): the kernel computes the
    twins' distances alike, so they tie exactly, and the lower index must
    come first in every pair of the top-k."""
    from repro_torch.configs import granite_moe_3b_a800m as granite
    cfg = granite.CONFIG
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    x, c, _ = router_inputs(torch, T, E // 2, D, T + 1, x_dtype, True)
    c = torch.cat([c, c]).contiguous()
    idx, eff = router_call(torch, "unit", x, c, None, K)
    torch.cuda.synchronize()
    what = (f"router_topk exact ties T={T} E={E} D={D} K={K} "
            f"{str(x_dtype).rsplit('.', 1)[-1]}")
    check(same_bits(torch, eff[:, 0::2], eff[:, 1::2]),
          f"{what}: twin experts do not tie exactly")
    # at |x|^2 ~ D the distances are coarse, so distinct experts can tie
    # too: the rule is that indices rise across every exact tie
    tie = eff[:, 1:] == eff[:, :-1]
    check(bool((idx[:, 1:] > idx[:, :-1])[tie].all() and
               (idx[:, 0] < E // 2).all()),
          f"{what}: the higher index came first at a tie")
    log("lm_kernels", f"{what}: every twin pair tied, indices rise across "
        f"all {int(tie.sum())} exact ties")


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


def arch_flash_shapes():
    """(B, S, H, KV, dh) of a 4096-token prefill of each config of the
    archs phase that has full-attention layers, and of rank 0's part of
    each serve_tp config's at model=SERVE_TP_RANKS (its query heads and
    the KV heads they read, as layers._rank_kv chooses them), once each:
    the flash kernel's shapes on those paths."""
    from repro_torch import configs
    from repro_torch.dist.rules import local_range, resolve_rules
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.models.layers import _rank_kv

    class Rank0(Mesh):
        """serve_tp's mesh as its rank 0 sees it, outside a rank."""

        def coordinate(self, name):
            return 0

    base = make_host_mesh(1, SERVE_TP_RANKS, device="cpu")
    mesh = Rank0(base.axis_names, base.extents, base.device)
    shapes = []
    for cfg, ranks in ([(configs.get_config(a), False)
                        for a, _, _ in ARCH_CELLS] +
                       [(serve_tp_config(a), True) for a in SERVE_TP_ARCHS]):
        if not any(s.attn == "full" for s in cfg.pattern):
            continue
        H, KV = cfg.n_heads, cfg.n_kv_heads
        if ranks:
            rules = resolve_rules(mesh, cfg, "prefill", batch_size=1)
            h0, h1 = local_range(rules, "heads", H)
            sel = _rank_kv(cfg, rules)
            k0, k1 = (local_range(rules, "kv_heads", KV) if sel is None
                      else sel if isinstance(sel, tuple) else (0, len(sel)))
            H, KV = h1 - h0, k1 - k0
        shape = (1, PREFILL_S, H, KV, cfg.hd)
        if shape not in shapes:
            shapes.append(shape)
    return shapes


def phase_lm_kernels(torch):
    from repro_torch.configs import granite_moe_3b_a800m as granite
    cfg = granite.CONFIG
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    # the router first (tools/router_variants.py's mutants fail here):
    # planted near-ties and exact ties on both forms of the kernel (decode
    # at T <= 32, tiled above), then every mode at granite's widths on both
    # sides of the threshold in bf16 and float32, then the reference
    # tests' float32 cases (E up to 384, top_k up to 8) in every mode and
    # at decode sizes
    for T in (4, 48, PREFILL_S):
        for x_dtype in (torch.bfloat16, torch.float32):
            for k in (2, K):
                router_planted(torch, T, k, x_dtype)
            router_exact_ties(torch, T, x_dtype)
    errs = []
    # a trainer_dp microbatch's tokens (data=1 and model=2: 2 x 4096)
    T_MB = TRAINER_DP_B // TRAIN_MICRO * TRAIN_S
    for T in (1, SERVE_BATCH, 31, 33, 48, PREFILL_S, PREFILL_S + 4, T_MB):
        for x_dtype in (torch.bfloat16, torch.float32):
            for mode in ROUTER_MODES:
                errs.append(compare_router(torch, T, E, D, K, T, x_dtype,
                                           mode))
    for T, e, d, k in ((512, 8, 64, 1), (512, 16, 64, 2), (512, 40, 32, 8),
                       (300, 128, 128, 2), (512, 200, 64, 4),
                       (300, 256, 32, 8), (256, 384, 16, 2),
                       (4, 384, 16, 2), (31, 200, 64, 4), (2, 8, 64, 1)):
        for mode in ROUTER_MODES:
            errs.append(compare_router(torch, T, e, d, k, T + e,
                                       torch.float32, mode))
    # D off the 16-byte copies: the tiled form's synchronous staging
    for T, e, d, k, x_dtype in ((100, 24, 30, 4, torch.float32),
                                (100, 24, 100, 4, torch.bfloat16),
                                (5, 24, 30, 4, torch.bfloat16)):
        for mode in ROUTER_MODES:
            errs.append(compare_router(torch, T, e, d, k, T + d, x_dtype,
                                       mode))
    # llama4's MoE layer (E = 128, top-1, D = 5120) at its serve, decode
    # and prefill token counts; jamba's (E = 16, top-2, D = 8192) at its
    # serve_tp decode (T = 1), serve (T = 4) and prefill ones
    from repro_torch.configs import jamba_1p5_large_398b as jamba
    from repro_torch.configs import llama4_maverick_400b_a17b as llama4
    for mod, tokens in ((llama4, (1, SERVE_BATCH, PREFILL_S)),
                        (jamba, (1, SERVE_BATCH, PREFILL_S))):
        m = mod.CONFIG.moe
        for T in tokens:
            for mode in ROUTER_MODES:
                errs.append(compare_router(torch, T, m.n_experts,
                                           mod.CONFIG.d_model, m.top_k, T,
                                           torch.bfloat16, mode))
    log("lm_kernels", f"router: {len(errs)} cases agree with the plain "
        f"version (max |eff err| {max(errs):.3g}, tolerance {ROUTER_TOL}), "
        "each launched twice with the same bits")
    # flash in bf16 (the tensor-core kernel): the path's shape first, then
    # all five head dims, the softcap, GQA 3:1 and 4:1, MQA, ragged S and
    # B = 2
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kern, yard = [], []
    MB = TRAINER_DP_B // TRAIN_MICRO
    for B, S, h, kv, dh, cap in (
            (1, PREFILL_S, H, KV, hd, 0.0),        # the path, GQA 3:1
            (MB, TRAIN_S, H, KV, hd, 0.0),         # trainer_dp's data=1
            (MB, TRAIN_S, H // TRAINER_DP_RANKS,   # a model=2 rank's
             KV // TRAINER_DP_RANKS, hd, 0.0),
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
            (2, 200, 4, 2, 256, 30.0),
            (2, 300, 6, 2, 96, 30.0)) + tuple(      # ragged S at dh 96
                shape + (0.0,) for shape in arch_flash_shapes()):
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
    # the float32 prefill's ragged S = 4100 and trainer_dp's microbatch
    # (2 x 4096) at granite's heads
    compare_flash(torch, 1, PREFILL_S + 4, H, KV, hd, torch.float32)
    compare_flash(torch, MB, TRAIN_S, H, KV, hd, torch.float32)
    for B, S, h, kv, dh, bq, bk, cap in (
            (2, 256, 4, 4, 32, 128, 128, 0.0),
            (1, 512, 8, 2, 64, 256, 128, 0.0),
            (2, 384, 4, 1, 32, 128, 128, 0.0),
            (1, 256, 4, 4, 128, 128, 128, 50.0),
            (1, 300, 3, 1, 16, 128, 128, 0.0),
            (2, 200, 4, 2, 256, 512, 512, 30.0),
            PHI3_FLASH + (512, 512, 0.0),
            (2, 300, 6, 2, 96, 512, 512, 30.0)):
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
    mesh = quality_mesh(ctx)
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
    # the raw events against the profiler's own sums on this profile
    sums = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and str(e.device_type).endswith("CUDA"):
            sums[e.key] = (us, e.count)
    # a nanosecond a call of slack for the two sums' rounding
    same = len(sums) == len(rows) and all(
        name in sums and sums[name][1] == calls
        and abs(sums[name][0] - us) <= 1e-6 * us + 1e-3 * calls
        for us, calls, name, _ in rows)
    log("profile", f"device_rows: {len(rows)} kernels, the same sums and "
        f"counts as key_averages: {same}")
    check(same, "device_rows differs from the profiler's key_averages")


def device_rows(prof):
    """(rows, device seconds) of a profile: (us, calls, name, device) of
    each kernel or copy the device ran, summed by name, largest first.
    Read from the profiler's raw events: building its operator trees
    (``key_averages``) took 109 s for the ~250,000 launches of the
    hierarchy on an H100."""
    sums: dict = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and not (
                e.is_user_annotation() or e.is_hidden_event()):
            us, calls = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (us + e.duration_ns() / 1e3, calls + 1)
    rows = sorted(((us, calls, name, "CUDA")
                   for name, (us, calls) in sums.items()), reverse=True)
    return rows, sum(r[0] for r in rows) / 1e6


def log_rows(tag, rows, n=12):
    if not rows:
        log(tag, "the profiler recorded no device time: not measured")
    for us, count, key, _ in rows[:n]:
        log(tag, f"  {us / 1e3:10.3f} ms  {count:6d} calls  {key[:70]}")


# ---------------------------------------------------------------------------
# phases 7b-7d: the load-balance time series, the hierarchical solve and
# the partition server
# ---------------------------------------------------------------------------

def run_counted(torch, ctx, tag, fn, allowed=("assign_reduce",)):
    """``fn()`` with every launch counter set to 0 just before it and read
    just after. The assign kernel must have launched; nothing outside
    ``allowed`` (no plain version) may have run. Returns (result, wall
    seconds, the nonzero counts), and keeps the counts for the kernels
    line under the path's tag."""
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: c for name, c in launch_counts().items() if c}
    check(counts.get("assign_reduce", 0) > 0,
          f"{tag}: the assign kernel never launched")
    check(set(counts) <= set(allowed),
          f"{tag}: launched {counts}, only {allowed} expected")
    ctx["paths"][tag] = counts
    return out, wall, counts


def profile_call(torch, ctx, tag, fn):
    """Where one call's time goes: ``fn`` under torch.profiler (after the
    counted runs), its wall time, the device's busy share and device time
    by kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    rows, device_s = device_rows(prof)
    log(tag, f"profile: wall {wall:.3f} s under the profiler, device busy "
        f"{device_s:.3f} s = {device_s / wall:.1%} of wall, "
        f"{sum(r[1] for r in rows)} device events (read in "
        f"{time.perf_counter() - t1:.1f} s)  [{ctx['card']}]")
    log_rows(tag, rows, n=10)


def host_profile(torch, tag, fn, n=12):
    """Where one call's host time goes: ``fn`` under cProfile, the
    functions with the most self time (a blocking read of the device
    shows as the time of the call that reads)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    total = sum(v[2] for v in stats.values())
    log(tag, f"host profile: {total:.3f} s of self time under cProfile")
    for (path, line, name), (_, calls, tt, ct, _) in sorted(
            stats.items(), key=lambda kv: -kv[1][2])[:n]:
        log(tag, f"  {tt * 1e3:9.2f} ms self {ct * 1e3:9.2f} ms cum "
            f"{calls:7d} calls  {Path(path).name}:{line}({name})")


def log_sim(tag, sim, wall, counts, card):
    for r in sim["per_step"]:
        log(tag, f"step {r['step']}: iters {r['iters']}, migration "
            f"fraction {r['migration_fraction']:.6f}, imbalance "
            f"{r['imbalance']:.6f}, {r['time_s']:.4f} s, assign launches "
            f"{r['kernel_launches'].get('assign_reduce', 0)}")
    s = sim["summary"]
    log(tag, f"n={sim['n']} k={sim['k']} T={sim['steps']} {sim['mode']}: "
        f"mean iters {s['mean_iters']:.3f}, mean migration "
        f"{s['mean_migration_fraction']:.6f}, max imbalance "
        f"{s['max_imbalance']:.6f}, steps {s['total_time_s']:.3f} s "
        f"(mean {s['total_time_s'] / sim['steps']:.4f} s a step), wall "
        f"{wall:.3f} s with step 0, launches {counts}  [{card}]")
    for r in sim["per_step"]:
        check(r["imbalance"] <= EPS + 1e-6,
              f"{tag}: step {r['step']} imbalance {r['imbalance']:.6f}")


def phase_repartition(torch, ctx):
    """The load-balance time series on the main cell's points under the
    drifting hotspot, T steps warm and cold through
    ``simulate_loadbalance``; its scan-semantics twin from the same cold
    start (equal to the warm run: its iterations and final labels); then
    ``repartition`` of an unchanged problem; then the full configuration
    of benchmarks/repartition.py with its claims. (No second warm run held
    bit-equal to the first, for time: the scan's equality holds the same
    run; PERF.md §5.)"""
    import numpy as np
    from repro_torch.core import meshes
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.timeseries import (simulate_loadbalance,
                                             simulate_loadbalance_scan)
    from repro_torch.partition import PartitionProblem, partition, repartition
    from repro_torch.partition.repartition import WARM_DELTA_TOL
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (MAIN_N, MAIN_D))
    prob = PartitionProblem(points=pts, k=MAIN_K, epsilon=EPS, seed=0)
    wl = meshes.DriftingHotspot()
    boot = ("assign_reduce", "prefix_sum")   # weighted cold starts
    sims = {}
    for tag, mode in (("repartition-warm", "warm"),
                      ("repartition-cold", "cold")):
        sims[tag], wall, counts = run_counted(
            torch, ctx, tag,
            lambda: simulate_loadbalance(prob, wl, REPART_T, mode=mode),
            boot)
        log_sim(tag, sims[tag], wall, counts, ctx["card"])
    warm = sims["repartition-warm"]
    sw, sc = warm["summary"], sims["repartition-cold"]["summary"]
    mig = (sw["mean_migration_fraction"]
           / max(sc["mean_migration_fraction"], 1e-9))
    log("repartition", f"main cell, cold/warm mean iters "
        f"{sc['mean_iters'] / max(sw['mean_iters'], 1e-9):.3f}, warm/cold "
        f"migration {mig:.4f}, seconds a step warm {sw['total_time_s'] / REPART_T:.4f} / cold "
        f"{sc['total_time_s'] / REPART_T:.4f}  [{ctx['card']}]")
    # the scan's semantics from the same cold start, on the permuted points
    dev_pts = torch.from_numpy(pts).to(DEVICE)
    prev = partition(prob.replace(
        weights=wl.weights_at(dev_pts, 0).cpu().numpy()))
    perm = np.random.default_rng(prob.seed).permutation(MAIN_N)
    cfg = BKMConfig(k=MAIN_K, epsilon=EPS, warmup=False,
                    delta_tol=WARM_DELTA_TOL)
    ((_, _, lab), recs), wall, counts = run_counted(
        torch, ctx, "repartition-scan",
        lambda: simulate_loadbalance_scan(
            pts[perm], prev.centers, prev.influence, prev.labels[perm], wl,
            REPART_T, cfg))
    host_iters = [r["iters"] for r in warm["per_step"]]
    host_mig = [r["migration_fraction"] for r in warm["per_step"]]
    check(recs["iters"].tolist() == host_iters,
          f"repartition-scan: iters {recs['iters'].tolist()} against the "
          f"host loop's {host_iters}")
    check(np.allclose(recs["migration_fraction"].numpy(), host_mig,
                      rtol=1e-5, atol=1e-7),
          "repartition-scan: migration differs from the host loop's")
    check(np.array_equal(lab.cpu().numpy(),
                         warm["final_result"].labels[perm]),
          "repartition-scan: final labels differ from the host loop's")
    rel = np.abs(recs["migration_fraction"].numpy() - host_mig) / host_mig
    log("repartition", f"scan semantics: iters {host_iters} as the host "
        f"loop, migration within rtol 1e-5 (max rel {float(rel.max()):.3g}),"
        f" final labels equal, balance retries "
        f"{recs['balance_retries'].tolist()}, {wall:.3f} s, launches "
        f"{counts}  [{ctx['card']}]")
    # an unchanged problem is a fixed point
    prob_t = prob.replace(
        weights=wl.weights_at(dev_pts, REPART_T).cpu().numpy())
    res, wall, counts = run_counted(
        torch, ctx, "repartition-fixed-point",
        lambda: repartition(prob_t, warm["final_result"]))
    check(res.stats["iters"] == 0 and
          res.stats["migration"]["volume"] == 0.0,
          f"repartition: unchanged problem took {res.stats['iters']} "
          f"iterations, migrated {res.stats['migration']['volume']}")
    log("repartition", f"unchanged problem: 0 iterations, 0 migration, "
        f"{wall:.3f} s, launches {counts}")
    prob_1 = prob.replace(weights=wl.weights_at(dev_pts, 1).cpu().numpy())
    profile_call(torch, ctx, "repartition",
                 lambda: repartition(prob_1, prev))
    host_profile(torch, "repartition", lambda: repartition(prob_1, prev))
    # the full configuration of benchmarks/repartition.py
    fam, n, k, seed, steps = REPART_BENCH
    bprob = PartitionProblem.from_mesh(meshes.REGISTRY[fam](n, seed=seed),
                                       k, epsilon=EPS, seed=seed)
    bench = {}
    for mode in ("warm", "cold"):
        tag = f"repartition-bench-{mode}"
        bench[mode], wall, counts = run_counted(
            torch, ctx, tag,
            lambda: simulate_loadbalance(bprob, wl, steps, mode=mode), boot)
        log_sim(tag, bench[mode], wall, counts, ctx["card"])
    sw, sc = bench["warm"]["summary"], bench["cold"]["summary"]
    iters_ratio = sc["mean_iters"] / max(sw["mean_iters"], 1e-9)
    mig_ratio = (sw["mean_migration_fraction"]
                 / max(sc["mean_migration_fraction"], 1e-9))
    check(iters_ratio >= 3.0, f"repartition bench: cold/warm iters "
          f"{iters_ratio:.3f} < 3")
    check(mig_ratio <= 0.30, f"repartition bench: warm/cold migration "
          f"{mig_ratio:.4f} > 0.30")
    log("repartition", f"{fam} n={n} k={k} T={steps}: cold/warm mean iters "
        f"{sc['mean_iters']:.3f} / {sw['mean_iters']:.3f} = "
        f"{iters_ratio:.3f} (claim >= 3), warm/cold migration "
        f"{mig_ratio:.4f} (claim <= 0.30), every step balanced  "
        f"[{ctx['card']}]")


def phase_hierarchical(torch, ctx):
    """``partition(main problem, hierarchy=(32, 32))`` batched; then on
    the main cell's first HIER_TWIN_N points the batched run and the
    one-lane-a-call refinement: bit-identical (both at full size until
    the serve_tp phase, for time: PERF.md §5); then the card against the
    port on the CPU at n = 2^16, (8, 8). (No run under the profiler, for
    time: its device busy share, 3.6-4.2%, is in PERF.md.)"""
    import numpy as np
    from repro_torch.partition import PartitionProblem, partition
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (MAIN_N, MAIN_D))
    runs = {}
    t0 = time.perf_counter()
    for tag, n, batched in (("hierarchical", MAIN_N, True),
                            ("hierarchical-twin", HIER_TWIN_N, True),
                            ("hierarchical-sequential", HIER_TWIN_N, False)):
        prob = PartitionProblem(points=pts[:n], k=HIER[0] * HIER[1],
                                epsilon=EPS, seed=0)
        runs[tag], wall, counts = run_counted(
            torch, ctx, tag,
            lambda: partition(prob, hierarchy=HIER, batched=batched))
        res = runs[tag]
        coarse, fine = res.stats["levels"]
        imb = res.imbalance()
        log(tag, f"n={n} k={prob.k} hierarchy={HIER}: wall "
            f"{wall:.3f} s = coarse {coarse['seconds']:.3f} s (imbalance "
            f"{coarse['imbalance']:.5f} at eps {coarse['epsilon']}) + "
            f"refine {fine['seconds']:.3f} s (of it the host's batch and "
            f"bootstraps {fine['prep_seconds']:.3f} s); lanes' iters "
            f"{fine['iters']}; "
            f"final imbalance {imb:.6f}; launches {counts}  [{ctx['card']}]")
        check(imb <= EPS + 1e-6, f"{tag}: imbalance {imb:.6f}")
    a, b = runs["hierarchical-twin"], runs["hierarchical-sequential"]
    check(np.array_equal(a.labels, b.labels) and
          np.array_equal(a.centers, b.centers) and
          np.array_equal(a.influence, b.influence),
          "hierarchical: the sequential run differs from the batched one")
    log("hierarchical", f"n={HIER_TWIN_N}: the batched run and the "
        "sequential one: labels, centers and influence bit-identical")
    t0 = lap("hierarchical: the three runs", t0)
    lane_layout(torch, ctx, "hierarchical", pts[: MAIN_N // HIER[0]])
    hierarchical_agreement(torch, ctx, pts[:HIER_CPU_N])
    lap("hierarchical: lane layout and the CPU agreement", t0)


def lane_layout(torch, ctx, tag, pts):
    """The point layout one lane builds (``ops.point_layout``: Hilbert
    keys, stable sort, copy, box), at a lane's size: host clock around
    the call and a synchronize, and the device time by CUDA events."""
    from repro_torch.kernels.ops import point_layout
    p = torch.tensor(pts, dtype=torch.float32, device=DEVICE)
    host = wall_ms(torch, lambda: point_layout(p, path_block_p()))
    dev = time_ms(torch, lambda: point_layout(p, path_block_p()), iters=5)
    log(tag, f"point layout of one lane, n={len(pts)} d={pts.shape[1]}: "
        f"{host:.3f} ms by the host clock (median of 5), {dev:.3f} ms by "
        f"CUDA events  [{ctx['card']}]")


def hierarchical_agreement(torch, ctx, pts):
    """The card against the port on the CPU at n = 2^16, (8, 8), stage by
    stage: the coarse cut, then the refinement lanes from the same coarse
    labels, each at least 0.99 in agreement. End to end the two differ
    more: a lane whose block lost or gained a few points to a coarse
    near-tie settles in another local optimum (the reference against the
    port on the CPU reads the same on this instance; PERF.md, PR 17), so
    the composition is printed, not gated."""
    import numpy as np
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.sfc import sfc_initial_centers
    from repro_torch.partition import (PartitionProblem,
                                       batched_balanced_kmeans,
                                       build_refinement_batch, partition)
    k1, k2 = HIER_CPU
    small = PartitionProblem(points=pts, k=k1 * k2, epsilon=EPS, seed=0)
    coarse = small.replace(k=k1, epsilon=EPS / 2)
    t0 = time.perf_counter()
    gpu_c, _, _ = run_counted(torch, ctx, "hierarchical-agreement",
                              lambda: partition(coarse))
    cpu_c = partition(coarse, device="cpu")
    t0 = lap("hierarchical agreement: the coarse cut, card and CPU", t0)
    agree_c = float(np.mean(gpu_c.labels == cpu_c.labels))
    bpts, bw, gather, counts = build_refinement_batch(pts, None,
                                                      gpu_c.labels, k1)
    c0 = np.stack([sfc_initial_centers(bpts[b, :counts[b]], k2,
                                       np.ones(counts[b]))
                   for b in range(k1)])
    cfg = BKMConfig(k=k2, epsilon=EPS, warmup=False)
    target = small.total_weight / (k1 * k2)
    lanes = [batched_balanced_kmeans(bpts, bw, c0, cfg, target, device=dev)
             for dev in (DEVICE, "cpu")]
    real = np.arange(bpts.shape[1])[None, :] < counts[:, None]
    agree_r = float(np.mean((lanes[0][0].cpu().numpy() ==
                             lanes[1][0].numpy())[real]))
    iters = [lane[3]["iters"].cpu().tolist() for lane in lanes]
    t0 = lap("hierarchical agreement: the lanes, card and CPU", t0)
    gpu = partition(small, hierarchy=HIER_CPU)
    cpu = partition(small, hierarchy=HIER_CPU, device="cpu")
    lap("hierarchical agreement: end to end, card and CPU", t0)
    agree = float(np.mean(gpu.labels == cpu.labels))
    log("hierarchical", f"n={len(pts)} hierarchy={HIER_CPU}, CUDA vs CPU: "
        f"coarse labels {agree_c:.4f}; refinement lanes from the same "
        f"coarse labels {agree_r:.4f} (iters {iters[0]} / {iters[1]}); "
        f"end to end {agree:.4f} (not gated), imbalance "
        f"{gpu.imbalance():.5f} / {cpu.imbalance():.5f}")
    check(agree_c >= 0.99,
          f"hierarchical: coarse CUDA vs CPU agreement {agree_c:.4f}")
    check(agree_r >= 0.99,
          f"hierarchical: refinement CUDA vs CPU agreement {agree_r:.4f}")


def pserve_fleet():
    from repro_torch.core import meshes
    from repro_torch.partition import PartitionProblem
    return [PartitionProblem(points=meshes.REGISTRY["delaunay2d"](
        n, seed=10 + i).points, k=k, epsilon=EPS, seed=10 + i)
        for i, (n, k) in enumerate(PSERVE_TENANTS)]


def serve_stream(server, stream, order=None):
    """Serve every step's requests (in ``order``); per step (seconds,
    responses by tenant)."""
    out = []
    for batch in stream:
        if order is not None:
            batch = [batch[i] for i in order]
        t0 = time.perf_counter()
        resp = server.serve(batch)
        out.append((time.perf_counter() - t0,
                    {r.tenant: r for r in resp}))
    return out


def phase_pserve(torch, ctx):
    """The serving benchmark's fleet through ``PartitionServer``, T steps
    of the drifting hotspot, warm (cache) and cold (no cache); the cold
    request at n == cap against ``partition()``, the warm hit against
    ``repartition()``, interleaving, and padded duplicates."""
    import numpy as np
    from repro_torch.core import meshes
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.partition import (bucket_balanced_kmeans, partition,
                                       repartition)
    from repro_torch.serve import PartitionServer, request_stream
    probs = pserve_fleet()
    wl = meshes.DriftingHotspot()
    runs = {}
    for mode, cache in (("warm", PSERVE_CACHE), ("cold", 0)):
        server = PartitionServer(tiers=PSERVE_TIERS, slots=PSERVE_SLOTS,
                                 cache_slots=cache)
        stream = list(request_stream(probs, wl, PSERVE_T))
        steps, wall, counts = run_counted(
            torch, ctx, f"pserve-{mode}",
            lambda: serve_stream(server, stream))
        runs[mode] = (steps, server)
        for t, (dt, resp) in enumerate(steps):
            for r in resp.values():
                check(r.balanced, f"pserve {mode}: step {t} tenant "
                      f"{r.tenant} imbalance {r.imbalance:.6f}")
            log(f"pserve-{mode}", f"step {t}: {dt:.4f} s, iters "
                f"{[resp[i].iters for i in range(len(probs))]}, warm "
                f"{sum(r.warm for r in resp.values())}")
        steady = [dt for dt, _ in steps[2:]]
        log(f"pserve-{mode}", f"{len(probs)} tenants x {PSERVE_T} steps, "
            f"tiers {PSERVE_TIERS}, slots {PSERVE_SLOTS}, cache {cache}: "
            f"wall {wall:.3f} s, steady state (steps >= 2) "
            f"{np.mean(steady):.4f} s a step, server stats {server.stats}, "
            f"launches {counts}  [{ctx['card']}]")
    warm_steps, warm_server = runs["warm"]
    hits = warm_server.stats["warm_hits"]
    check(hits == len(probs) * (PSERVE_T - 1),
          f"pserve: {hits} warm hits, expected {len(probs)} x "
          f"{PSERVE_T - 1}")
    steady = {m: np.mean([dt for dt, _ in runs[m][0][2:]]) for m in runs}
    last = list(request_stream(probs, wl, PSERVE_T + 1))[-1]
    profile_call(torch, ctx, "pserve-warm",
                 lambda: warm_server.serve(last))
    host_profile(torch, "pserve-warm", lambda: warm_server.serve(
        list(request_stream(probs, wl, PSERVE_T + 2))[-1]))
    log("pserve", f"warm hits {hits} = {len(probs)} x {PSERVE_T - 1}; "
        f"steady-state seconds a step warm {steady['warm']:.4f} / cold "
        f"{steady['cold']:.4f}  [{ctx['card']}]")
    # the tenant at n == cap: cold step 0 is partition(), warm step 1 is
    # repartition() from it
    tenant = next(i for i, (n, _) in enumerate(PSERVE_TENANTS)
                  if n in PSERVE_TIERS)
    p = probs[tenant]
    dev_pts = torch.from_numpy(p.points).to(DEVICE)
    w0, w1 = (wl.weights_at(dev_pts, t).cpu().numpy() for t in (0, 1))
    prev = partition(p.replace(weights=w0))
    nxt = repartition(p.replace(weights=w1), prev)
    r0, r1 = warm_steps[0][1][tenant], warm_steps[1][1][tenant]
    check(np.array_equal(r0.labels, prev.labels),
          "pserve: the cold request at n == cap differs from partition()")
    check(r1.warm and np.array_equal(r1.labels, nxt.labels) and
          r1.iters == nxt.stats["iters"],
          "pserve: the warm hit differs from repartition()")
    log("pserve", f"tenant {tenant} (n = cap = {p.n}): cold step equals "
        f"partition() bit for bit, warm hit equals repartition() bit for "
        f"bit with {r1.iters} iterations")
    # the same stream interleaved otherwise: the same responses
    order = list(range(len(probs)))[::-1]
    other = serve_stream(
        PartitionServer(tiers=PSERVE_TIERS, slots=PSERVE_SLOTS,
                        cache_slots=PSERVE_CACHE),
        list(request_stream(probs, wl, 3)), order)
    for t, (_, resp) in enumerate(other):
        for i, r in resp.items():
            w = warm_steps[t][1][i]
            check(np.array_equal(r.labels, w.labels) and r.iters == w.iters,
                  f"pserve: interleaved step {t} tenant {i} differs")
    log("pserve", "the first 3 steps served in reverse order: the same "
        "labels and iterations")
    # padded duplicates take their source's label (n < cap)
    small = next(i for i, (n, _) in enumerate(PSERVE_TENANTS)
                 if n not in PSERVE_TIERS)
    server = PartitionServer(tiers=PSERVE_TIERS, slots=1)
    req = list(request_stream(probs, wl, 1))[0][small]
    cap = server.tier_for(req.n)
    _, spts, sw, c0, _, _ = server._prep_slot(req, cap, None)
    (A, *_), _, _ = run_counted(
        torch, ctx, "pserve-duplicates",
        lambda: bucket_balanced_kmeans(spts[None], sw[None], c0[None],
                                       BKMConfig(k=req.k, epsilon=EPS),
                                       counts=[req.n]))
    lab = A[0].cpu().numpy()
    check(np.array_equal(lab, lab[np.arange(cap) % req.n]),
          "pserve: a padded duplicate and its source got different labels")
    log("pserve", f"tenant {small} (n={req.n}, cap {cap}): every padded "
        "duplicate has its source's label")
    lane_layout(torch, ctx, "pserve", spts)


# ---------------------------------------------------------------------------
# phase 7e: label-propagation refinement
# ---------------------------------------------------------------------------

def quality_mesh(ctx):
    """The quality mesh, delaunay3d at n = 131,072, built once."""
    if "quality_mesh" not in ctx:
        from repro_torch.core import meshes
        t0 = time.perf_counter()
        mesh = meshes.REGISTRY["delaunay3d"](QUALITY_N, seed=0)
        log("quality", f"delaunay3d n={mesh.n} m={mesh.m} built in "
            f"{time.perf_counter() - t0:.1f} s")
        ctx["quality_mesh"] = mesh
    return ctx["quality_mesh"]


def tri_mesh(ctx):
    """The refine cell's mesh, tri at n = 2^22 (2048 x 2048), built once."""
    if "tri_mesh" not in ctx:
        from repro_torch.core import meshes
        t0 = time.perf_counter()
        mesh = meshes.REGISTRY["tri"](REFINE_N, seed=0)
        log("refine", f"{mesh.name} n={mesh.n} m={mesh.m} built in "
            f"{time.perf_counter() - t0:.1f} s")
        ctx["tri_mesh"] = mesh
    return ctx["tri_mesh"]


def timed(torch, fn):
    """(fn(), host seconds) around work ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def round_inputs(prob, labels, node_order=None):
    """The rounds' inputs as ``label_prop_refine`` makes them: canonical
    labels, CSR, quantized weights, keys, k, limit, the round cap."""
    import numpy as np
    from repro_torch.partition.refine import (DEFAULT_MAX_ROUNDS,
                                              _canonicalize, _node_keys,
                                              refinement_quantization)
    keys = _node_keys(prob, node_order)
    iw, limit = refinement_quantization(prob)
    lc, _ = _canonicalize(np.asarray(labels, np.int64), keys, prob.k)
    return (lc, prob.indptr, prob.indices, iw, keys, prob.k, limit,
            DEFAULT_MAX_ROUNDS)


def no_better_move(torch, prob, labels, chunk=1 << 18) -> bool:
    """True when no admissible single move lowers the edge cut. Moving v
    from block a to block b changes the cut by H[v, a] - H[v, b] (H: the
    count of v's neighbours in a block), so no admissible b
    (``iw[v] <= budget[b]``) may have H[v, b] > H[v, a]. Dense histograms
    of ``chunk`` nodes at a time on the card, independent of the rounds'
    sparse form."""
    import numpy as np
    from repro_torch.partition import refinement_budgets
    iw, budget = refinement_budgets(prob, labels)
    lab = torch.from_numpy(np.asarray(labels, np.int64)).to(DEVICE)
    iw_t = torch.from_numpy(iw).to(DEVICE)
    budget_t = torch.from_numpy(budget).to(DEVICE)
    indptr = np.asarray(prob.indptr, np.int64)
    nbr = lab[torch.from_numpy(np.asarray(prob.indices, np.int64))
              .to(DEVICE)]
    for lo in range(0, prob.n, chunk):
        hi = min(lo + chunk, prob.n)
        e0, e1 = int(indptr[lo]), int(indptr[hi])
        row = torch.repeat_interleave(
            torch.arange(hi - lo, device=DEVICE),
            torch.from_numpy(np.diff(indptr[lo:hi + 1])).to(DEVICE),
            output_size=e1 - e0)
        H = torch.zeros((hi - lo, prob.k), dtype=torch.int32, device=DEVICE)
        H.index_put_((row, nbr[e0:e1]),
                     torch.ones(e1 - e0, dtype=torch.int32, device=DEVICE),
                     accumulate=True)
        own = H.gather(1, lab[lo:hi, None])
        adm = budget_t[None, :] >= iw_t[lo:hi, None]
        if bool(((H > own) & adm).any()):
            return False
    return True


def refine_agreement(torch, ctx):
    """The rounds on the card against the port's rounds on the CPU and the
    dense plain version on the card, from geographer's labels of the
    quality mesh at k = 64: unit and lognormal weights, and a permuted
    node order. Labels, rounds, moves and gains bit-equal."""
    import numpy as np
    from repro_torch.partition import PartitionProblem, partition
    from repro_torch.partition.refine import _lp_rounds, _lp_rounds_plain
    mesh = quality_mesh(ctx)
    unit = PartitionProblem.from_mesh(mesh, k=REFINE_QUALITY_K, epsilon=EPS)
    w = np.random.default_rng(1).lognormal(0.0, 0.5, mesh.n)
    perm = np.random.default_rng(2).permutation(mesh.n)
    for tag, prob, order in (("unit", unit, None),
                             ("lognormal", unit.replace(weights=w), None),
                             ("unit, permuted node_order", unit, perm)):
        args = round_inputs(prob, partition(prob, device=DEVICE).labels,
                            order)
        card, t_card = timed(torch, lambda: _lp_rounds(*args, device=DEVICE))
        cpu, t_cpu = timed(torch, lambda: _lp_rounds(*args, device="cpu"))
        plain, t_plain = timed(
            torch, lambda: _lp_rounds_plain(*args, device=DEVICE))
        for name, other in (("the CPU", cpu), ("the plain version", plain)):
            check(np.array_equal(card[0], other[0]) and
                  card[1:] == other[1:],
                  f"refine agreement ({tag}): the card's rounds "
                  f"{card[1:]} differ from {name}'s {other[1:]}")
        log("refine", f"agreement, {mesh.name} k={prob.k} {tag}: rounds "
            f"{card[1]}, moves {card[2]}, gain {card[4]}; card, CPU and "
            f"plain bit-equal (card {t_card:.3f} s, CPU {t_cpu:.3f} s, "
            f"plain on the card {t_plain:.3f} s)  [{ctx['card']}]")


def refine_full(torch, ctx):
    """``partition(tri n = 2^22, k = 1024, refine=True)`` twice on the card:
    converged, the cut not raised and fallen by the accepted gains,
    balanced, no admissible positive-gain move left, bit-identical; then
    each part of the refinement timed on its own."""
    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.partition import PartitionProblem, partition
    from repro_torch.partition.refine import (_canonicalize, _lp_rounds,
                                              label_prop_refine)
    mesh = tri_mesh(ctx)
    prob = PartitionProblem.from_mesh(mesh, k=MAIN_K, epsilon=EPS)
    runs = {}
    for tag in ("refine", "refine-repeat"):
        runs[tag], wall, counts = run_counted(
            torch, ctx, tag, lambda: partition(prob, refine=True,
                                               device=DEVICE))
        st = runs[tag].stats["refine"]
        log(tag, f"partition({mesh.name}, k={prob.k}, refine=True): wall "
            f"{wall:.3f} s, rounds {st['rounds']}, moves {st['moves']}, "
            f"converged {st['converged']}, cut {st['cut_before']} -> "
            f"{st['cut_after']}, imbalance {runs[tag].imbalance():.6f}, "
            f"launches {counts}  [{ctx['card']}]")
    res = runs["refine"]
    st = res.stats["refine"]
    check(np.array_equal(res.labels, runs["refine-repeat"].labels),
          "refine: two runs gave different labels")
    check(st["converged"], f"refine: not converged in {st['rounds']} rounds")
    check(st["cut_after"] <= st["cut_before"],
          f"refine: cut rose {st['cut_before']} -> {st['cut_after']}")
    imb = res.imbalance()
    check(imb <= EPS + 1e-6, f"refine: imbalance {imb:.6f} > {EPS}")
    # the parts, each on its own
    base, t_solve = timed(torch, lambda: partition(prob, device=DEVICE))
    (out, info), t_lp = timed(torch, lambda: label_prop_refine(
        prob, base.labels, device=DEVICE))
    check(np.array_equal(out, res.labels), "refine: label_prop_refine of "
          "the solve's labels differs from partition(refine=True)")
    check(info["gain"] == st["cut_before"] - st["cut_after"],
          f"refine: accepted gains {info['gain']} against the cut's fall "
          f"{st['cut_before'] - st['cut_after']}")
    args, t_prep = timed(torch, lambda: round_inputs(prob, base.labels))
    _, t_canon = timed(torch, lambda: _canonicalize(
        base.labels.astype(np.int64), args[4], prob.k))
    _, t_rounds = timed(torch, lambda: _lp_rounds(*args, device=DEVICE))
    _, t_cut = timed(torch, lambda: metrics.edge_cut(
        res.labels, prob.indptr, prob.indices))
    t_refine = t_lp + 2 * t_cut
    log("refine", f"{mesh.name} k={prob.k}: solve {t_solve:.3f} s, "
        f"refinement {t_refine:.3f} s = label_prop_refine {t_lp:.3f} s "
        f"(rounds on the card {t_rounds:.3f} s for {st['rounds']} rounds, "
        f"{t_rounds / st['rounds'] * 1e3:.2f} ms a round with the edges' "
        f"copy; host: keys, quantization and canonicalization "
        f"{t_prep:.3f} s, of it canonicalization {t_canon:.3f} s) + host "
        f"edge_cut 2 x {t_cut:.3f} s; host share "
        f"{(t_prep + 2 * t_cut) / t_refine:.1%}  [{ctx['card']}]")
    check(no_better_move(torch, prob, res.labels),
          "refine: an admissible positive-gain move remains")
    q0 = metrics.evaluate_problem(prob, base.labels)
    q1 = metrics.evaluate_problem(prob, res.labels)
    log("refine", f"{mesh.name} k={prob.k}: cut {q0['cut']} -> {q1['cut']}"
        f" ({1 - q1['cut'] / q0['cut']:.2%} fewer), totalCommVol "
        f"{q0['totalCommVol']} -> {q1['totalCommVol']}, maxCommVol "
        f"{q0['maxCommVol']} -> {q1['maxCommVol']}, imbalance "
        f"{q0['imbalance']:.6f} -> {q1['imbalance']:.6f}; cut fell by the "
        "accepted gains; no admissible positive-gain move left (dense "
        "check)")
    profile_call(torch, ctx, "refine", lambda: label_prop_refine(
        prob, base.labels, device=DEVICE))
    return mesh, res


def hotspot_weights(torch, mesh, steps):
    """The drifting hotspot's weights at t = 0..steps on ``mesh`` (the
    workload is defined on the unit square; the grid spans [0, 2048))."""
    from repro_torch.core import meshes
    wl = meshes.DriftingHotspot()
    pts = torch.from_numpy(mesh.points).to(DEVICE)
    lo, hi = pts.min(0).values, pts.max(0).values
    unit = (pts - lo) / (hi - lo)
    return [wl.weights_at(unit, t).cpu().numpy() for t in range(steps + 1)]


def refine_warm(torch, ctx, mesh, start):
    """``repartition(..., refine=True)`` over T steps of the drifting
    hotspot on the same mesh, from the refined unit-weight partition
    ``start``, twice: every step balanced, the migration counted over the
    refined labels, the two series bit-identical."""
    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.partition import PartitionProblem, repartition
    from repro_torch.partition.refine import refinement_quantization
    prob = PartitionProblem.from_mesh(mesh, k=MAIN_K, epsilon=EPS)
    ws = hotspot_weights(torch, mesh, REFINE_T)
    _, limit = refinement_quantization(prob.replace(weights=ws[1]))
    log("refine-warm", f"weights {ws[1].min():.3f}-{ws[1].max():.3f}; "
        f"refinement limit {limit} quantized units a block (float weights: "
        f"floor((1+eps) W/k) less a margin of n = {prob.n} units, W ~ 2^30;"
        " 0 leaves every budget at 0)")

    def series():
        out, secs = [start], []
        for t in range(1, REFINE_T + 1):
            res, sec = timed(torch, lambda: repartition(
                prob.replace(weights=ws[t]), out[-1], refine=True,
                device=DEVICE))
            out.append(res)
            secs.append(sec)
        return out, secs

    runs = {}
    for tag in ("refine-warm", "refine-warm-repeat"):
        (steps, secs), wall, counts = run_counted(torch, ctx, tag, series)
        runs[tag] = steps
        for t in range(1, REFINE_T + 1):
            res = steps[t]
            st = res.stats["refine"]
            imb = res.imbalance()
            mig = res.stats["migration"]["fraction"]
            want = float(metrics.migration_fraction(
                steps[t - 1].labels, res.labels, ws[t]))
            log(tag, f"step {t}: iters {res.stats['iters']}, retries "
                f"{res.stats['balance_retries']}, rounds {st['rounds']}, "
                f"moves {st['moves']}, cut {st['cut_before']} -> "
                f"{st['cut_after']}, imbalance {imb:.6f}, migration "
                f"{mig:.6f}, {secs[t - 1]:.3f} s")
            check(imb <= EPS + 1e-6, f"{tag}: step {t} imbalance {imb:.6f}")
            check(st["cut_after"] <= st["cut_before"],
                  f"{tag}: step {t} cut rose")
            check(mig == want, f"{tag}: step {t} migration {mig} is not "
                  f"that of the refined labels, {want}")
        log(tag, f"{mesh.name} k={MAIN_K} T={REFINE_T} warm with refine: "
            f"wall {wall:.3f} s, mean {np.mean(secs):.3f} s a step, "
            f"launches {counts}  [{ctx['card']}]")
    for a, b in zip(runs["refine-warm"], runs["refine-warm-repeat"]):
        check(np.array_equal(a.labels, b.labels),
              "refine-warm: two series gave different labels")
    log("refine", "warm: every step balanced, migration over the refined "
        "labels, two series bit-identical")


def phase_refine(torch, ctx):
    refine_agreement(torch, ctx)
    refine_warm(torch, ctx, *refine_full(torch, ctx))


# ---------------------------------------------------------------------------
# phase 8b: the multi-device path over torch.distributed
# ---------------------------------------------------------------------------

def rank_run(torch, fn, allowed=("assign_reduce",)):
    """Inside a rank of a launch: ``fn()`` with the launch counts set to 0
    just before it and read just after, the host clock around it ended by
    a synchronize, and this rank's all-reduces over the world group. The
    assign kernel must have launched on this rank, unless ``allowed`` is
    empty (then no kernel may run), and nothing outside ``allowed``. Every
    rank's numbers go into one [P, 4] table by one sum all-reduce (row r:
    wall s, assign launches, all-reduces, all-reduce s of rank r). Returns
    (fn's value, the table as a list, this rank's nonzero counts)."""
    from repro_torch.dist import current
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    comm = current()
    torch.cuda.synchronize()
    reset_launch_counts()
    before = comm.counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: c for name, c in launch_counts().items() if c}
    after = comm.counters()
    check(counts.get("assign_reduce", 0) > 0 or not allowed,
          f"rank {comm.rank}: the assign kernel never launched")
    check(set(counts) <= set(allowed),
          f"rank {comm.rank}: launched {counts}, only {allowed} expected")
    # on the rank's device: NCCL reduces only CUDA tensors
    row = torch.zeros(comm.size, 4, dtype=torch.float64, device=DEVICE)
    row[comm.rank] = torch.tensor(
        [wall, counts.get("assign_reduce", 0),
         after["all_reduces"] - before["all_reduces"],
         after["seconds"] - before["seconds"]], dtype=torch.float64)
    return out, comm.all_reduce(row).tolist(), counts


def run_summary(res, table, counts):
    """What a rank sends home of one partition run: its numbers, not its
    labels (the labels stay in the ranks and are compared there)."""
    st = res.stats["levels"][0]
    return {"imbalance": res.imbalance(), "iters": int(st["iters"]),
            "sweeps": sweeps_of(st), "backend": st["backend"],
            "seconds": st["seconds"], "collectives": st["collectives"],
            "table": table, "counts": counts}


def same_result(np, a, b) -> bool:
    return (np.array_equal(a.labels, b.labels)
            and np.array_equal(a.centers, b.centers)
            and np.array_equal(a.influence, b.influence))


REDIST_COLS = ("wall", "assign_reduce", "sweeps", "all_reduces",
               "all_reduce_s", "all_gathers", "all_to_alls", "all_to_all_s",
               "all_to_all_bytes", "redistribute_s", "centers_s", "kmeans_s",
               "count", "offset", "gates")


def redistribute_on_rank(torch, points):
    """Inside a launch of P ranks: ``make_distributed_partitioner(P)`` on
    the main cell, this rank's rows of ``points`` (the reference's deal),
    twice at P=1 and once at P>1 (cut for time), and once at k =
    ``REDIST_BALANCE_K`` for the balance gate (no
    third run under the profiler, for time: its device busy share is in
    PERF.md). Gates, on every rank:
    row 1 launched once a sweep and nothing else ran, two runs bit-equal,
    the valid keys (recomputed on the card) sorted and inside the rank's
    splitter range, the offset the prefix of the counts; on rank 0, over
    every rank's slots all-gathered in rank order (the curve order): the
    valid points equal the input as a multiset and the initial centers
    equal bit for bit the points at the int64 strided positions. Returns
    (every rank's numbers as a [P, len(REDIST_COLS)] table, rank 0's
    summary)."""
    import numpy as np
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.partitioner import make_distributed_partitioner
    from repro_torch.core.sfc import hilbert_index_int32
    from repro_torch.dist import current
    comm = current()
    P, r = comm.size, comm.rank
    rows = points.shape[0] // P
    shard = points[r * rows:(r + 1) * rows]
    run = make_distributed_partitioner(P, BKMConfig(k=MAIN_K, epsilon=EPS))
    t0 = time.perf_counter()
    first, _, counts = rank_run(torch, lambda: run(shard, return_stats=True))
    # the repeat, bit-equal, at P=1 (NCCL); cut at P=4 for time (PERF.md
    # §5: the four ranks' determinism is held by devices=4 against (2, 2))
    again = rank_run(torch, lambda: run(shard, return_stats=True))[0] \
        if P == 1 else first
    # the balance gate's cell: the same points at k = 64 (queue 3 item 17)
    coarse, _, _ = rank_run(torch, lambda: make_distributed_partitioner(
        P, BKMConfig(k=REDIST_BALANCE_K, epsilon=EPS))(shard))
    A, rp, rv, centers, infl, imb, dropped, st = first
    parts = {"solves": time.perf_counter() - t0}
    t0 = time.perf_counter()
    red = st["redistribution"]
    gates = {"repeat": all(np.array_equal(a, b)
                           for a, b in zip(first[:7], again[:7]))}
    on_card = torch.from_numpy(rp[rv]).to(DEVICE)
    keys = hilbert_index_int32(
        on_card, lo=torch.from_numpy(red["lo"]).to(DEVICE),
        hi=torch.from_numpy(red["hi"]).to(DEVICE)).cpu().numpy()
    s = red["splitters"]
    gates["keys"] = bool(keys.size == 0 or (
        np.all(np.diff(keys) >= 0)
        and (r == 0 or keys[0] >= s[r - 1])
        and (r == P - 1 or keys[-1] < s[r])))
    every = comm.all_gather(torch.tensor([red["count"]], device=DEVICE))
    gates["offset"] = red["offset"] == int(every[:r].sum())
    gates["launches"] = counts.get("assign_reduce", 0) == sweeps_of(st)
    slots = [comm.all_gather(torch.from_numpy(x).to(DEVICE))
             for x in (rp, rv)]
    summary = None
    if r == 0:
        curve = slots[0][slots[1]]              # rank order: curve order
        want = torch.tensor(np.asarray(points, np.float32), device=DEVICE)
        n = curve.shape[0]
        gates["multiset"] = n == want.shape[0] and torch.equal(
            rows_sorted(torch, curve), rows_sorted(torch, want))
        gpos = (np.arange(MAIN_K, dtype=np.int64) * n) // MAIN_K \
            + n // (2 * MAIN_K)
        gates["centers"] = np.array_equal(red["centers0"],
                                          curve[gpos].cpu().numpy())
        parts["gates"] = time.perf_counter() - t0
        summary = {"imbalance": float(imb), "dropped": int(dropped),
                   "seconds": parts,
                   "balance_k_imbalance": float(coarse[5]),
                   "iters": int(st["iters"]), "cap": red["cap"],
                   "backend": st["backend"], "gates": gates}
    sec, col = st["seconds"], st["collectives"]
    row = torch.zeros(P, len(REDIST_COLS), dtype=torch.float64,
                      device=DEVICE)
    row[r] = torch.tensor(
        [0.0, counts.get("assign_reduce", 0), sweeps_of(st),
         col["all_reduces"], col["seconds"], col["all_gathers"],
         col["all_to_alls"], col["all_to_all_seconds"],
         col["all_to_all_bytes"], sec["redistribute"], sec["centers"],
         sec["kmeans"], red["count"], red["offset"],
         all(gates.values())], dtype=torch.float64)
    row[r, 0] = sum(sec.values())
    return comm.all_reduce(row).tolist(), summary


def rows_sorted(torch, x):
    """The rows of ``x`` [n, d] in lexicographic order: stable sorts from
    the last column to the first, on x's device."""
    for j in reversed(range(x.shape[1])):
        x = x[torch.sort(x[:, j], stable=True).indices]
    return x


@contextlib.contextmanager
def rank_cpu_threads(torch, ranks):
    """A rank's CPU work on its share of the host's cores: ``ranks``
    processes of a launch each running every core's worth of intra-op
    threads oversubscribe the host (the card-vs-CPU agreements inside
    the four-rank launch took 24.5 to 54.2 s from one machine to the next
    with every core's worth a rank)."""
    import os
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or ranks) // ranks))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def redistribute_extras(torch, points):
    """Inside the ``devices=4`` launch: the card against CPU ranks on the
    first ``SHARDED_AGREE_N`` points at k = ``SHARDED_AGREE_K``
    (``warmup=False``): the redistribution bit-equal, the labels of the
    valid slots compared; then a curve-ordered copy of the cell (sorted by
    the int32 key, dealt in contiguous blocks) through the redistribution
    alone: its ``n_dropped`` beside the count of the reference's rule (the
    points past ``cap`` for each destination, summed)."""
    import numpy as np
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.partitioner import (make_distributed_partitioner,
                                              redistribute)
    from repro_torch.core.sfc import hilbert_index_int32
    from repro_torch.dist import current
    comm = current()
    P, r = comm.size, comm.rank
    sub = points[:SHARDED_AGREE_N]
    rows = sub.shape[0] // P
    mine = sub[r * rows:(r + 1) * rows]
    cfg = BKMConfig(k=SHARDED_AGREE_K, epsilon=EPS, warmup=False)
    t0 = time.perf_counter()
    card = make_distributed_partitioner(P, cfg)(mine)
    t1 = time.perf_counter()
    with rank_cpu_threads(torch, P):
        cpu = make_distributed_partitioner(P, cfg, device="cpu")(mine)
    t2 = time.perf_counter()
    same = all(np.array_equal(card[i], cpu[i]) for i in (1, 2))
    valid = card[2]
    agree = comm.all_reduce(torch.tensor(
        [float(np.sum(card[0][valid] == cpu[0][valid])), float(valid.sum()),
         float(same)], dtype=torch.float64, device=DEVICE)).tolist()
    pts = torch.tensor(np.asarray(points, np.float32), device=DEVICE)
    order = torch.sort(hilbert_index_int32(pts), stable=True).indices
    rows = pts.shape[0] // P
    mine = pts[order[r * rows:(r + 1) * rows]]
    t3 = time.perf_counter()
    red = redistribute(mine, torch.ones(rows, device=DEVICE), comm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t3
    dest = torch.searchsorted(red.splitters, hilbert_index_int32(
        mine, lo=red.lo, hi=red.hi), right=True)
    excess = torch.clamp_min(torch.bincount(dest, minlength=P) - red.cap, 0)
    rule = int(comm.all_reduce(excess.sum()))
    return {"seconds": {"card": t1 - t0, "cpu": t2 - t1,
                        "curve": time.perf_counter() - t2},
            "agree": agree[0] / agree[1], "valid": int(agree[1]),
            "same": agree[2] == P, "cpu_imbalance": float(cpu[5]),
            "card_imbalance": float(card[5]),
            "curve": {"dropped": red.dropped, "rule": rule, "wall": wall,
                      "cap": red.cap}}


def log_redistribute(ctx, tag, table, summary, extras=None):
    """The home side of ``redistribute_on_rank`` (and, at P=4, of
    ``redistribute_extras``): per-rank numbers, the gates, the paths."""
    card = ctx["card"]
    P = len(table)
    for r, row in enumerate(table):
        v = dict(zip(REDIST_COLS, row))
        log(tag, f"rank {r}: {v['wall']:.3f} s = redistribution "
            f"{v['redistribute_s']:.3f} s (all_to_all {int(v['all_to_alls'])}"
            f" calls, {v['all_to_all_s']:.3f} s, "
            f"{int(v['all_to_all_bytes'])} bytes) + centers "
            f"{v['centers_s']:.3f} s + k-means {v['kmeans_s']:.3f} s; "
            f"sweeps {int(v['sweeps'])}, row-1 launches "
            f"{int(v['assign_reduce'])}; all-reduces {int(v['all_reduces'])}"
            f" ({v['all_reduce_s']:.3f} s), all-gathers "
            f"{int(v['all_gathers'])}; valid slots {int(v['count'])} at "
            f"offset {int(v['offset'])}  [{card}]")
        ctx["paths"][f"{tag} rank {r}"] = {
            "assign_reduce": int(v["assign_reduce"])}
        check(v["gates"] == 1, f"{tag} rank {r}: a gate failed "
              f"(rank 0's: {summary['gates']})")
    s = summary
    log(tag, f"n={MAIN_N} k={MAIN_K} devices={P} ({s['backend']}): cap "
        f"{s['cap']}, {P * s['cap']} slots a rank, dropped {s['dropped']}, "
        f"iters {s['iters']}, imbalance {s['imbalance']:.6f}; gates "
        f"{s['gates']}  [{card}]")
    for part, sec in s["seconds"].items():
        log("time", f"{tag}: {part}: {sec:.1f} s")
    check(all(s["gates"].values()), f"{tag}: gates {s['gates']}")
    check(s["dropped"] == 0, f"{tag}: {s['dropped']} points dropped")
    # at k = 1024 the warm-up on each rank's curve prefix ends unbalanced,
    # as the reference's does (ROADMAP.md queue 3 item 17): printed above;
    # the balance is gated at k = 64, where the reference balances
    log(tag, f"the same points at k={REDIST_BALANCE_K}: imbalance "
        f"{s['balance_k_imbalance']:.6f}")
    check(s["balance_k_imbalance"] <= EPS + 1e-6,
          f"{tag}: imbalance {s['balance_k_imbalance']:.6f} at "
          f"k={REDIST_BALANCE_K}")
    if extras is None:
        return
    e = extras
    log(tag, f"first {SHARDED_AGREE_N} points, k={SHARDED_AGREE_K}, "
        f"warmup=False: card vs CPU ranks redistribution bit-equal "
        f"{e['same']}, labels {e['agree']:.4f} of {e['valid']} valid "
        f"slots, imbalance {e['card_imbalance']:.5f} / "
        f"{e['cpu_imbalance']:.5f}")
    check(e["same"], f"{tag}: card and CPU redistributions differ")
    check(e["agree"] >= 0.99, f"{tag}: card vs CPU labels {e['agree']:.4f}")
    check(max(e["card_imbalance"], e["cpu_imbalance"]) <= EPS + 1e-6,
          f"{tag}: the agreement cell unbalanced")
    c = e["curve"]
    log(tag, f"curve-ordered copy (contiguous blocks of the int32 key "
        f"order): n_dropped {c['dropped']} (the reference's rule: "
        f"{c['rule']}; n/2 = {MAIN_N // 2}), cap {c['cap']}, "
        f"redistribution {c['wall']:.3f} s on rank 0  [{card}]")
    check(c["dropped"] == c["rule"],
          f"{tag}: curve-ordered n_dropped {c['dropped']} != {c['rule']}")
    for part, sec in e["seconds"].items():
        log("time", f"{tag} extras: {part}: {sec:.1f} s")


def sharded_one(prob):
    """Rank body of the ``devices=1`` launch (NCCL): one solve, whose
    labels come home to be held against the single-device run (that
    equality also holds the launch's determinism). Then the distributed
    partitioner at P=1 (``redistribute_on_rank``)."""
    import torch
    from repro_torch.partition import partition
    res, table, counts = rank_run(torch, lambda: partition(prob, devices=1))
    return (res.labels, res.centers, res.influence,
            run_summary(res, table, counts),
            redistribute_on_rank(torch, prob.points))


REFINE_KEYS = ("rounds", "moves", "converged", "cut_before", "cut_after")


def refine_on_ranks(torch, tri):
    """Inside the ``devices=4`` launch: the sharded refinement rounds on
    the refine cell from geographer's labels, at P and over the (2, 2)
    mesh, held against the single-card ``refine()`` of the same labels
    (``tri``: the problem, the labels, the single card's labels and
    stats, the drifting hotspot's weights at t = 1); the rounds alone,
    timed on every rank (no profiled repeat, for time: the device busy
    share of a round is in PERF.md); ``partition(devices=P,
    refine=True)`` against ``refine(partition(devices=P), devices=P)``;
    one warm ``repartition(devices=P, refine=True)`` step, its refined cut
    against its own unrefined one (``cut_before``)."""
    import numpy as np
    from repro_torch.dist import current
    from repro_torch.eval import ShardedGraph
    from repro_torch.partition import partition, refine, repartition
    from repro_torch.partition.refine import _lp_rounds_sharded
    comm = current()
    P = comm.size
    prob, base = tri["prob"], tri["base"]
    out = {}
    graph, t_graph = timed(torch, lambda: ShardedGraph.from_problem(prob, P))
    for tag, devices in (("refine-P", P), ("refine-mesh", SHARDED_MESH)):
        res, table, _ = rank_run(torch, lambda: refine(
            prob, base, devices=devices, graph=graph), allowed=())
        st = res.stats["refine"]
        out[tag] = {"equal": bool(np.array_equal(res.labels, tri["labels"])
                                  and all(st[key] == tri["stats"][key]
                                          for key in REFINE_KEYS)),
                    "stats": {key: st[key] for key in REFINE_KEYS
                              + ("devices",)},
                    "table": table}
    # the rounds alone, timed on every rank
    lc, _, _, iw, keys, k, limit, max_rounds = round_inputs(prob, base)
    args = (lc, iw, keys, k, limit, max_rounds)
    torch.cuda.synchronize()
    before = comm.counters()
    t0 = time.perf_counter()
    rounds = _lp_rounds_sharded(graph, *args, comm, device=DEVICE)[1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = comm.counters()
    row = torch.zeros(P, 5, dtype=torch.float64, device=DEVICE)
    row[comm.rank] = torch.tensor(
        [wall, rounds, after["all_reduces"] - before["all_reduces"],
         after["seconds"] - before["seconds"],
         after["bytes"] - before["bytes"]], dtype=torch.float64)
    out["rounds"] = {"table": comm.all_reduce(row).tolist(),
                     "graph_s": t_graph}
    # the front doors: the sharded solve refined over the same ranks
    composed, table, counts = rank_run(
        torch, lambda: partition(prob, devices=P, refine=True))
    solved = partition(prob, devices=P)
    again = refine(prob, solved, devices=P, graph=graph)
    out["compose"] = {
        "equal": bool(np.array_equal(composed.labels, again.labels)
                      and composed.stats["refine"] == again.stats["refine"]),
        "stats": {key: composed.stats["refine"][key]
                  for key in REFINE_KEYS},
        "imbalance": composed.imbalance(), "table": table, "counts": counts}
    step_prob = prob.replace(weights=tri["w1"])
    step, table, counts = rank_run(torch, lambda: repartition(
        step_prob, composed, devices=P, refine=True),
        allowed=("assign_reduce", "prefix_sum"))
    out["warm"] = {
        "stats": {key: step.stats["refine"][key] for key in REFINE_KEYS},
        "imbalance": step.imbalance(), "iters": step.stats["iters"],
        "table": table, "counts": counts}
    return out


def log_refine_on_ranks(ctx, out):
    """The home side of ``refine_on_ranks``: its numbers and gates."""
    card = ctx["card"]
    for tag in ("refine-P", "refine-mesh"):
        r = out[tag]
        walls = ", ".join(f"{row[0]:.3f}" for row in r["table"])
        log(f"sharded-{tag}", f"tri n={SHARDED_REFINE_N} k={MAIN_K}, devices="
            f"{r['stats']['devices']}: {r['stats']}; refine() wall per "
            f"rank {walls} s, all-reduces per rank "
            f"{[int(row[2]) for row in r['table']]}  [{card}]")
        check(r["equal"], f"sharded {tag}: labels or stats differ from the "
              "single-card refine()")
    check(out["refine-mesh"]["stats"]["devices"] == list(SHARDED_MESH),
          f"devices={SHARDED_MESH} recorded as "
          f"{out['refine-mesh']['stats']['devices']}")
    rr = out["rounds"]
    for rank, row in enumerate(rr["table"]):
        wall, rounds, calls, ar_s, nbytes = row
        log("sharded-refine-rounds", f"rank {rank}: {int(rounds)} rounds in "
            f"{wall:.3f} s = {wall / rounds * 1e3:.2f} ms a round; "
            f"{int(calls)} all-reduces ({calls / rounds:.0f} a round) taking "
            f"{ar_s:.3f} s = {ar_s / wall:.1%} of the rounds; "
            f"{int(nbytes / rounds)} bytes a round  [{card}]")
        check(calls == 4 * rounds, f"rank {rank}: {int(calls)} all-reduces "
              f"in {int(rounds)} rounds, want 4 a round")
    log("sharded-refine-rounds", f"ShardedGraph of the cell built in "
        f"{rr['graph_s']:.3f} s (rank 0)")
    c = out["compose"]
    walls = ", ".join(f"{row[0]:.3f}" for row in c["table"])
    log("sharded-refine-compose", f"partition(devices={SHARDED_P}, "
        f"refine=True): {c['stats']}, imbalance {c['imbalance']:.6f}; wall "
        f"per rank {walls} s, launches {c['counts']}  [{card}]")
    check(c["equal"], "partition(devices=P, refine=True) differs from "
          "refine(partition(devices=P), devices=P)")
    check(c["imbalance"] <= EPS + 1e-6,
          f"sharded compose: imbalance {c['imbalance']:.6f}")
    w = out["warm"]
    walls = ", ".join(f"{row[0]:.3f}" for row in w["table"])
    log("sharded-refine-warm", f"repartition(devices={SHARDED_P}, "
        f"refine=True), DriftingHotspot t=1: iters {w['iters']}, "
        f"{w['stats']}, imbalance "
        f"{w['imbalance']:.6f}; wall per rank {walls} s  [{card}]")
    check(w["imbalance"] <= EPS + 1e-6,
          f"sharded warm refine: imbalance {w['imbalance']:.6f}")
    check(w["stats"]["cut_after"] <= w["stats"]["cut_before"],
          f"sharded warm refine: cut {w['stats']['cut_after']} above the "
          f"unrefined {w['stats']['cut_before']}")
    for tag in ("compose", "warm"):
        for r, row in enumerate(out[tag]["table"]):
            ctx["paths"][f"sharded-refine-{tag} rank {r}"] = {
                "assign_reduce": int(row[1])}


def sharded_suite(prob, sub, qprob, qlabels, tri):
    """Rank body of the ``devices=4`` launch (four gloo ranks on the one
    card): every P=4 gate of the phase, the comparisons made in the
    ranks, the distributed partitioner last. Returns rank 0's summary."""
    import numpy as np
    import torch
    from repro_torch.core import meshes
    from repro_torch.core.timeseries import simulate_loadbalance
    from repro_torch.dist import current
    from repro_torch.eval import evaluate_sharded
    from repro_torch.partition import partition
    comm = current()
    P = comm.size
    out = {"backend": comm.backend,
           "rank_device": torch.cuda.current_device(), "seconds": {}}
    clock = [time.perf_counter()]

    def mark(part):
        # rank 0's host seconds of each part of the launch
        now = time.perf_counter()
        out["seconds"][part] = now - clock[0]
        clock[0] = now
    # gloo reduces CUDA tensors: sum, min and max on the card
    x = torch.tensor([comm.rank + 1.0, -float(comm.rank)], device=DEVICE)
    out["probe"] = {op: comm.all_reduce(x, op).cpu().tolist()
                    for op in ("sum", "min", "max")}
    runs = {}
    for tag, devices, opts in (("flat", P, {}), ("mesh", SHARDED_MESH, {}),
                               ("device-bootstrap", P,
                                {"bootstrap": "device"})):
        res, table, counts = rank_run(
            torch, lambda: partition(prob, devices=devices, **opts))
        runs[tag] = res
        out[tag] = run_summary(res, table, counts)
    out["mesh"]["equal"] = same_result(np, runs["flat"], runs["mesh"])
    out["device-bootstrap"]["blocks_used"] = int(
        len(np.unique(runs["device-bootstrap"].labels)))
    del runs
    mark("devices=4, (2, 2), device bootstrap")
    # agreement: the card against CPU ranks on the same deal
    card, table, counts = rank_run(
        torch, lambda: partition(sub, devices=P, warmup=False))
    with rank_cpu_threads(torch, P):
        cpu = partition(sub, devices=P, warmup=False, device="cpu")
    out["agreement"] = {
        "card": run_summary(card, table, counts),
        "cpu_imbalance": cpu.imbalance(),
        "agree": float(np.mean(card.labels == cpu.labels))}
    # sharded evaluation on the quality mesh
    quality, table, counts = rank_run(
        torch, lambda: evaluate_sharded(qprob, qlabels, P), allowed=())
    out["evaluate"] = {"quality": quality, "table": table}
    mark("agreement with CPU ranks, evaluate_sharded")
    # warm repartitioning: a cold step 0, then T warm steps
    sim, table, counts = rank_run(
        torch, lambda: simulate_loadbalance(prob, meshes.DriftingHotspot(),
                                            SHARDED_T, devices=P),
        allowed=("assign_reduce", "prefix_sum"))
    sim.pop("final_result")
    out["repartition"] = {"sim": sim, "table": table, "counts": counts}
    mark("simulate_loadbalance")
    # the hierarchy: the coarse cut over all ranks, the lanes flat or over
    # the refine axis
    hier = {}
    hprob = prob.replace(points=prob.points[:SHARDED_HIER_N],
                         k=SHARDED_HIER[0] * SHARDED_HIER[1])
    for tag, devices in (("hier-flat", P), ("hier-mesh", SHARDED_MESH)):
        res, table, counts = rank_run(
            torch, lambda: partition(hprob, hierarchy=SHARDED_HIER,
                                     devices=devices))
        hier[tag] = res
        coarse, fine = res.stats["levels"]
        out[tag] = {"imbalance": res.imbalance(), "table": table,
                    "counts": counts, "coarse_s": coarse["seconds"],
                    "refine_s": fine["seconds"],
                    "prep_s": fine["prep_seconds"],
                    "refine_devices": fine["refine_devices"]}
    out["hier-mesh"]["equal"] = same_result(np, hier["hier-flat"],
                                            hier["hier-mesh"])
    del hier
    mark("the hierarchy (8, 8) flat and over (2, 2)")
    out["refine"] = refine_on_ranks(torch, tri)
    mark("the sharded refinement")
    out["redistribute"] = (*redistribute_on_rank(torch, prob.points),
                           redistribute_extras(torch, prob.points))
    mark("the distributed partitioner")
    return out


def log_run(tag, s, card):
    """One sharded run's numbers: wall and solve seconds per rank, sweeps
    and row-1 launches per rank, all-reduces per balance iteration and
    their time, the backend."""
    walls = ", ".join(f"{r[0]:.3f}" for r in s["table"])
    launches = [int(r[1]) for r in s["table"]]
    ars = [int(r[2]) for r in s["table"]]
    ar_s = ", ".join(f"{r[3]:.3f}" for r in s["table"])
    sec = s["seconds"]
    log(tag, f"backend {s['backend']}: wall per rank {walls} s (rank 0: "
        f"deal and bootstrap {sec['bootstrap']:.3f} s, k-means "
        f"{sec['kmeans']:.3f} s, labels home {sec['labels_home']:.3f} s); "
        f"iters {s['iters']}, sweeps {s['sweeps']}, assign launches per "
        f"rank {launches}; all-reduces per rank {ars} "
        f"({ars[0] / max(s['sweeps'], 1):.2f} a balance iteration), their "
        f"seconds per rank {ar_s}; imbalance {s['imbalance']:.6f}  [{card}]")
    check(all(n == s["sweeps"] for n in launches),
          f"{tag}: assign launches {launches} != sweeps {s['sweeps']}")


def phase_sharded(torch, ctx):
    """The multi-device path: ``partition(devices=1)`` over NCCL against
    ``partition()`` on the main cell, and the distributed partitioner at
    P=1; then one launch of four gloo ranks sharing the card for
    ``devices=4``, ``(2, 2)``, the device bootstrap, the agreement
    with CPU ranks, ``evaluate_sharded``, warm repartitioning, the
    hierarchy, the sharded refinement rounds on the refine cell
    (``refine_on_ranks``) and the distributed partitioner at P=4
    (``redistribute_on_rank``, ``redistribute_extras``)."""
    import numpy as np
    from repro_torch.core import metrics
    from repro_torch.dist import launch
    from repro_torch.partition import PartitionProblem, partition, refine
    log("sharded", f"backend rule: devices=1 -> "
        f"{launch.choose_backend('cuda', 1)}, devices={SHARDED_P} -> "
        f"{launch.choose_backend('cuda', SHARDED_P)} "
        f"({torch.cuda.device_count()} card(s))")
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (MAIN_N, MAIN_D))
    prob = PartitionProblem(points=pts, k=MAIN_K, epsilon=EPS, seed=0)
    single = partition(prob)
    t0 = time.perf_counter()
    labels, centers, infl, s, redist = launch.launch(
        sharded_one, 1, args=(prob,), device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    log_run("sharded-1", s, ctx["card"])
    ctx["paths"]["sharded-1"] = s["counts"]
    log_redistribute(ctx, "redistribute-1", *redist)
    log("sharded-1", f"launch of 1 rank: {wall:.1f} s with the process "
        f"start")
    check(s["backend"] == launch.choose_backend("cuda", 1),
          f"devices=1 ran on {s['backend']}")
    check(np.array_equal(labels, single.labels)
          and np.array_equal(centers, single.centers)
          and np.array_equal(infl, single.influence),
          "devices=1 differs from partition() on the card")
    log("sharded-1", "labels, centers and influence bit-equal to "
        "partition() on the card")
    sub = PartitionProblem(points=pts[:SHARDED_AGREE_N], k=SHARDED_AGREE_K,
                           epsilon=EPS, seed=0)
    qprob = PartitionProblem.from_mesh(quality_mesh(ctx), k=REFINE_QUALITY_K)
    qlabels = partition(qprob).labels
    from repro_torch.core import meshes
    t0 = time.perf_counter()
    tmesh = meshes.REGISTRY["tri"](SHARDED_REFINE_N, seed=0)
    log("sharded-refine", f"{tmesh.name} n={tmesh.n} m={tmesh.m} built in "
        f"{time.perf_counter() - t0:.1f} s")
    tprob = PartitionProblem.from_mesh(tmesh, k=MAIN_K, epsilon=EPS)
    tbase = partition(tprob).labels
    want, t_want = timed(torch, lambda: refine(tprob, tbase))
    log("sharded-refine", f"single-card refine() of geographer's labels on "
        f"tri n={tprob.n} k={MAIN_K}: {want.stats['refine']}, "
        f"{t_want:.3f} s  [{ctx['card']}]")
    tri = {"prob": tprob, "base": tbase, "labels": want.labels,
           "stats": want.stats["refine"],
           "w1": hotspot_weights(torch, tmesh, 1)[1]}
    t0 = time.perf_counter()
    out = launch.launch(sharded_suite, SHARDED_P,
                        args=(prob, sub, qprob, qlabels, tri), device="cuda",
                        timeout=900)
    wall = time.perf_counter() - t0
    log("sharded", f"launch of {SHARDED_P} ranks on card(s) "
        f"{out['rank_device']}: {wall:.1f} s with the process starts; "
        f"backend {out['backend']}; gloo all-reduce of CUDA tensors "
        f"{out['probe']}")
    check(out["backend"] == launch.choose_backend("cuda", SHARDED_P),
          "the launch did not follow the backend rule")
    want = {"sum": [10.0, -6.0], "min": [1.0, -3.0], "max": [4.0, 0.0]}
    check(out["probe"] == want, f"gloo all-reduce on the card gave "
          f"{out['probe']}, want {want}")
    for tag in ("flat", "mesh", "device-bootstrap"):
        s = out[tag]
        log_run(f"sharded-{tag}", s, ctx["card"])
        check(s["imbalance"] <= EPS + 1e-6,
              f"sharded {tag}: imbalance {s['imbalance']:.6f}")
        for r in range(SHARDED_P):
            ctx["paths"][f"sharded-{tag} rank {r}"] = {
                "assign_reduce": int(s["table"][r][1])}
    check(out["mesh"]["equal"], "devices=(2, 2) differs from devices=4")
    check(out["device-bootstrap"]["blocks_used"] == MAIN_K,
          "device bootstrap left blocks empty")
    log("sharded", "devices=4 and devices=(2, 2): labels, centers and "
        "influence bit-identical; every run balanced")
    a = out["agreement"]
    log_run("sharded-agreement", a["card"], ctx["card"])
    log("sharded-agreement", f"first {SHARDED_AGREE_N} points, k="
        f"{SHARDED_AGREE_K}, warmup=False, {SHARDED_P} ranks: card vs CPU "
        f"ranks labels {a['agree']:.4f}, imbalance "
        f"{a['card']['imbalance']:.5f} / {a['cpu_imbalance']:.5f}")
    check(a["agree"] >= 0.99, f"sharded agreement {a['agree']:.4f}")
    host = metrics.evaluate_problem(qprob, qlabels)
    got = out["evaluate"]["quality"]
    walls = ", ".join(f"{r[0]:.3f}" for r in out["evaluate"]["table"])
    log("sharded-evaluate", f"delaunay3d n={qprob.n} k={qprob.k}: "
        f"{got}; wall per rank {walls} s  [{ctx['card']}]")
    check(got == host, f"evaluate_sharded {got} != host {host}")
    rep = out["repartition"]
    sim = rep["sim"]
    for r in sim["per_step"]:
        log("sharded-repartition", f"step {r['step']}: iters {r['iters']}, "
            f"migration {r['migration_fraction']:.6f}, imbalance "
            f"{r['imbalance']:.6f}, {r['time_s']:.3f} s (rank 0)")
        check(r["imbalance"] <= EPS + 1e-6,
              f"sharded repartition step {r['step']} unbalanced")
    walls = ", ".join(f"{r[0]:.3f}" for r in rep["table"])
    log("sharded-repartition", f"T={SHARDED_T} warm after a cold step 0: "
        f"wall per rank {walls} s, assign launches per rank "
        f"{[int(r[1]) for r in rep['table']]}, all-reduces per rank "
        f"{[int(r[2]) for r in rep['table']]}  [{ctx['card']}]")
    for r in range(SHARDED_P):
        ctx["paths"][f"sharded-repartition rank {r}"] = {
            "assign_reduce": int(rep["table"][r][1])}
    for tag in ("hier-flat", "hier-mesh"):
        h = out[tag]
        walls = ", ".join(f"{r[0]:.3f}" for r in h["table"])
        log(f"sharded-{tag}", f"hierarchy={SHARDED_HIER}: wall per rank "
            f"{walls} s (rank 0: coarse {h['coarse_s']:.3f} s, refine "
            f"{h['refine_s']:.3f} s of which the host's batch and "
            f"bootstraps {h['prep_s']:.3f} s), lanes over "
            f"{h['refine_devices']}, assign launches per rank "
            f"{[int(r[1]) for r in h['table']]}, imbalance "
            f"{h['imbalance']:.6f}  [{ctx['card']}]")
        check(h["imbalance"] <= EPS + 1e-6, f"sharded {tag} unbalanced")
    check(out["hier-mesh"]["equal"],
          "hierarchy over (2, 2) differs from devices=4")
    log("sharded", f"hierarchy={SHARDED_HIER}: devices=(2, 2) bit-equal to "
        f"devices={SHARDED_P}")
    log_refine_on_ranks(ctx, out["refine"])
    table, summary, extras = out["redistribute"]
    log_redistribute(ctx, f"redistribute-{SHARDED_P}", table, summary,
                     extras)
    for part, sec in out["seconds"].items():
        log("time", f"sharded, the {SHARDED_P}-rank launch: {part}: "
            f"{sec:.1f} s")
    log("sharded", f"refine(devices={SHARDED_P}) and devices={SHARDED_MESH}"
        " bit-equal to the single-card refine(); partition(devices=, "
        "refine=True) equal to its parts; the warm refined step balanced")


# ---------------------------------------------------------------------------
# phase 8c: the paper's §5 matrix over the ranks
# ---------------------------------------------------------------------------

UNTIMED = ("time_partition_s", "time_refine_s", "time_eval_s")
_RECORDED: dict = {}


def untimed(rows):
    return [{key: v for key, v in r.items() if key not in UNTIMED}
            for r in rows]


def experiments_suite(kw, small_kw):
    """Rank body of the matrix's launch (four gloo ranks on the one card):
    ``run_matrix(**kw)`` on this rank, the launch counts set to 0 just
    before it and read just after, each family's mesh build timed and
    each ``refine`` call of the matrix recorded (its base labels and its
    result), then the gates on rank 0: every row's integer metrics equal
    to ``evaluate_problem`` of its labels, every refined row equal to the
    single-card ``refine()`` of its base labels (labels and stats), its cut
    not above its base row's. Then ``run_matrix(**small_kw)``, whose rows
    the caller holds against the same call's own launch."""
    import numpy as np
    import torch
    from repro_torch.core import meshes, metrics
    from repro_torch.dist import current
    from repro_torch.eval import experiments
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.partition import refine
    comm = current()
    # per rank: the rank's refine calls and mesh seconds (keyed by rank, as
    # ranks that are threads of one process share this module)
    seen = _RECORDED[("refine", comm.rank)] = []
    mesh_s = _RECORDED[("mesh_s", comm.rank)] = {}
    mesh_fns = dict(meshes.REGISTRY)

    def recording(problem, res, *args, **kwargs):
        out = refine(problem, res, *args, **kwargs)
        _RECORDED[("refine", current().rank)].append(
            (problem, np.asarray(res.labels), out))
        return out

    def timed_build(fam):
        def build(*args, **kwargs):
            t0 = time.perf_counter()
            mesh = mesh_fns[fam](*args, **kwargs)
            _RECORDED[("mesh_s", current().rank)][fam] = \
                time.perf_counter() - t0
            return mesh
        return build

    experiments.refine = recording
    meshes.REGISTRY.update({fam: timed_build(fam) for fam in mesh_fns})
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        before = comm.counters()
        t0 = time.perf_counter()
        matrix = experiments.run_matrix(device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: c for name, c in launch_counts().items() if c}
        after = comm.counters()
    finally:
        experiments.refine = refine
        meshes.REGISTRY.update(mesh_fns)
    table = torch.zeros(comm.size, 4, dtype=torch.float64, device=DEVICE)
    table[comm.rank] = torch.tensor(
        [wall, counts.get("assign_reduce", 0),
         after["all_reduces"] - before["all_reduces"],
         after["seconds"] - before["seconds"]], dtype=torch.float64)
    table = comm.all_reduce(table).tolist()
    out = {"matrix": matrix, "wall": wall, "table": table, "counts": counts,
           "mesh_s": mesh_s, "failures": []}
    if comm.rank == 0:
        t0 = time.perf_counter()
        rows = matrix["rows"]
        base_rows = [r for r in rows if not r["refined"]]
        refined_rows = [r for r in rows if r["refined"]]
        check(len(seen) == len(refined_rows) == len(base_rows),
              f"{len(seen)} refine calls for {len(refined_rows)} refined "
              "rows")
        bad = out["failures"]
        for (problem, labels, got), brow, rrow in zip(seen, base_rows,
                                                      refined_rows):
            cell = f"{brow['family']}/{brow['tool']}"
            for row, lab in ((brow, labels), (rrow, got.labels)):
                host = metrics.evaluate_problem(problem, lab)
                if any(row[key] != v for key, v in host.items()):
                    bad.append(f"{cell}: row {row['tool']} is not the "
                               f"metrics of its labels: {host}")
            single = refine(problem, labels, device=DEVICE)
            st, want = got.stats["refine"], single.stats["refine"]
            if not (np.array_equal(got.labels, single.labels)
                    and all(st[key] == want[key] for key in REFINE_KEYS)
                    and (rrow["refine_rounds"], rrow["refine_moves"],
                         rrow["refine_converged"]) == (
                             want["rounds"], want["moves"],
                             want["converged"])):
                bad.append(f"{cell}: the sharded refinement {st} differs "
                           f"from the single card's {want}")
            if rrow["cut"] > brow["cut"]:
                bad.append(f"{cell}: refined cut {rrow['cut']} above "
                           f"{brow['cut']}")
        out["gates_s"] = time.perf_counter() - t0
    out["small"] = untimed(experiments.run_matrix(device=DEVICE,
                                                  **small_kw)["rows"])
    return out


def phase_experiments(torch, ctx):
    """The paper's §5 matrix: every method over the mesh zoo, each cell
    refined, evaluated and refined over four gloo ranks sharing the card,
    the whole matrix in one launch; then a small matrix through
    ``run_matrix``'s own launch, held against the same call inside the
    ranks."""
    from repro_torch.dist import launch
    from repro_torch.eval import experiments
    card = ctx["card"]
    kw = dict(EXPERIMENTS, eval_devices=SHARDED_P)
    small_kw = dict(EXPERIMENTS_SMALL, eval_devices=SHARDED_P)
    t0 = time.perf_counter()
    out = launch.launch(experiments_suite, SHARDED_P, args=(kw, small_kw),
                        device="cuda", timeout=900)
    wall = time.perf_counter() - t0
    m = out["matrix"]
    rows = m["rows"]
    for fam in m["families"]:
        log("experiments", f"{fam}: mesh built in {out['mesh_s'][fam]:.2f} "
            f"s on each rank (rank 0's clock)")
    for base, ref in zip(rows[::2], rows[1::2]):
        log("experiments", f"{base['family']:>10} {base['tool']:>12}: n="
            f"{base['n']} cut {base['cut']} -> {ref['cut']}, totalCommVol "
            f"{base['totalCommVol']} -> {ref['totalCommVol']}, maxCommVol "
            f"{base['maxCommVol']} -> {ref['maxCommVol']}, imbalance "
            f"{base['imbalance']:.5f} -> {ref['imbalance']:.5f}, rounds "
            f"{ref['refine_rounds']}, moves {ref['refine_moves']}; "
            f"partition {base['time_partition_s']:.3f} s, refine "
            f"{ref['time_refine_s']:.3f} s, eval {base['time_eval_s']:.3f} "
            f"+ {ref['time_eval_s']:.3f} s")
    summary = m["summary"]
    for tool, ratios in summary["geo_over_tool"].items():
        log("experiments", f"geographer / {tool}: " + ", ".join(
            f"{met} {ratios[met]:.4f}" for met in experiments.CELL_METRICS)
            + "; refined geographer / " + tool + ": " + ", ".join(
            f"{met} {summary['geo_refined_over_tool'][tool][met]:.4f}"
            for met in experiments.CELL_METRICS))
    log("experiments", f"all_balanced {summary['all_balanced']}, "
        f"geographer_all_balanced {summary['geographer_all_balanced']}, "
        f"refined_imbalance_ok {summary['refined_imbalance_ok']}")
    unbalanced = [f"{r['family']}/{r['tool']} {r['imbalance']:.5f}"
                  for r in rows if not r["balanced"]]
    log("experiments", f"unbalanced rows: {unbalanced or 'none'}")
    part = sum(r["time_partition_s"] for r in rows[::2])
    ref_s = sum(r["time_refine_s"] for r in rows[1::2])
    ev = sum(r["time_eval_s"] for r in rows)
    mesh = sum(out["mesh_s"].values())
    walls = ", ".join(f"{r[0]:.1f}" for r in out["table"])
    log("experiments", f"{len(rows)} rows over {len(m['families'])} "
        f"families x {len(m['methods'])} methods, n={m['n']} k={m['k']} "
        f"eval_devices={m['eval_devices']}: launch {wall:.1f} s; run_matrix "
        f"per rank {walls} s; rank 0: meshes {mesh:.1f} s, partition "
        f"{part:.1f} s, refine {ref_s:.1f} s, evaluation {ev:.1f} s, the "
        f"rest {out['wall'] - mesh - part - ref_s - ev:.1f} s; gates "
        f"{out['gates_s']:.1f} s; launch and process starts "
        f"{wall - max(r[0] for r in out['table']) - out['gates_s']:.1f} s "
        f"at most; all-reduces per rank {[int(r[2]) for r in out['table']]}"
        f" taking {[round(r[3], 2) for r in out['table']]} s  [{card}]")
    launches = [int(r[1]) for r in out["table"]]
    log("experiments", f"assign launches per rank {launches} (rank 0 "
        f"solves every cell); rank 0's counts {out['counts']}")
    for r, n in enumerate(launches):
        ctx["paths"][f"experiments rank {r}"] = {"assign_reduce": n}
    check(launches[0] > 0 and not any(launches[1:]),
          f"experiments: assign launches per rank {launches}")
    check(set(out["counts"]) <= {"assign_reduce", "prefix_sum"},
          f"experiments: launched {out['counts']}")
    check(not out["failures"], "experiments: " + "; ".join(
        out["failures"][:5]))
    check(len(rows) == 2 * len(m["families"]) * len(m["methods"]) == 72,
          f"experiments: {len(rows)} rows")
    check(summary["refined_imbalance_ok"],
          "experiments: a refinement worsened the balance")
    log("experiments", "every row's metrics equal evaluate_problem of its "
        "labels; every refined row equal to the single-card refine() of "
        "its base labels, its cut not above its base row's; refined "
        "imbalance ok")
    t0 = time.perf_counter()
    small = experiments.run_matrix(device="cuda", **small_kw)
    t_small = time.perf_counter() - t0
    check(untimed(small["rows"]) == out["small"],
          "run_matrix's own launch differs from the same matrix run inside "
          "the ranks")
    log("experiments", f"run_matrix({small_kw}) through its own launch: "
        f"{t_small:.1f} s with the process starts; rows equal to the same "
        "call inside the ranks")


# ---------------------------------------------------------------------------
# phases 9-10: granite-moe-3b-a800m served at full width
# ---------------------------------------------------------------------------

def granite_params(torch, ctx):
    """granite CONFIG's parameters, made on the card from a seeded
    generator once and kept for the serve and prefill phases."""
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.models import model as M
    if "lm_params" not in ctx:
        ctx["lm_base"] = torch.cuda.memory_allocated()
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
    keep_peak(torch, ctx, "serve", "granite_moe_3b_a800m", SERVE_CELL,
              ctx["lm_base"])
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
    router = [r for r in rows if "router_" in r[2]]
    check(bool(router), "serve profile: no router kernel on the device")
    router_ms = sum(r[0] for r in router) / steps / 1e3
    log("serve", f"router kernel device time {router_ms:.4f} ms a decode "
        f"step, "
        f"{sum(r[1] for r in router) // steps} launches a step "
        f"({', '.join(sorted({router_name(r[2]) for r in router}))})  "
        f"[{ctx['card']}]")


def serve_agreement(torch, arch="granite_moe_3b_a800m"):
    """The same engine on ``arch``'s SMOKE in float32, on the card (its
    kernels) and on the CPU (the plain versions), from one set of
    parameters: the transcripts (codebook 0 for codebook configs) must be
    equal. An embeddings config, which the engine does not serve, runs 8
    serve steps over seeded embeddings instead, and its logits must agree
    within 1e-4."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import make_serve_step
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    card = _to_device(cpu, DEVICE)
    if cfg.input_mode == "embeddings":
        emb = torch.tensor(np.random.default_rng(1).standard_normal(
            (3, 8, cfg.d_model)), dtype=torch.float32)
        step = make_serve_step(cfg)
        logits = []
        for params, dev in ((card, DEVICE), (cpu, "cpu")):
            cache = M.init_cache(cfg, 3, 8, device=dev)
            out = []
            for t in range(8):
                _, cache, lg = step(params, cache, emb[:, t:t + 1].to(dev),
                                    t)
                out.append(lg.float().cpu())
            logits.append(torch.cat(out, dim=1))
        err = float(torch.max(torch.abs(logits[0] - logits[1])))
        check(torch.allclose(logits[0], logits[1], rtol=1e-4, atol=1e-4),
              f"serve: {cfg.name} float32 decode logits differ between the "
              f"card and the CPU (max |err| {err:.3g})")
        log("serve", f"{cfg.name} float32, 8 steps at batch 3 from seeded "
            f"embeddings: card and CPU logits agree (max |err| {err:.3g}, "
            "tolerance 1e-4)")
        return
    shape = () if cfg.input_mode == "tokens" else (cfg.n_codebooks,)
    out = []
    for params in (card, cpu):
        rng = np.random.default_rng(1)
        reqs = [Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, (n, *shape)).astype(np.int32), max_new=8)
                for i, n in enumerate((5, 3, 7, 4, 6, 2))]
        ServeEngine(cfg, None, params, batch=4, max_seq=32).run(reqs)
        out.append([r.out for r in reqs])
    check(out[0] == out[1], f"serve: {cfg.name} float32 transcripts "
          f"differ between the card and the CPU: {out}")
    log("serve", f"{cfg.name} float32, 6 requests at batch 4: card "
        "(kernels) and CPU (plain versions) transcripts equal")


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
        record=("flash_attention_tc",))   # the router's line reads serve's
    # launches, the float32 kernel's prefill_f32's
    keep_path(ctx, "prefill", counts)
    keep_peak(torch, ctx, "prefill", "granite_moe_3b_a800m", PREFILL_CELL,
              ctx["lm_base"])
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
    ctx["prefill_s"] = again
    log("prefill", f"{cfg.name} B=1 S={PREFILL_S}: prefill {wall:.3f} s "
        f"(repeat {again:.3f} s), flash launches: tensor cores "
        f"{counts['flash_attention_tc']} (the model's q/k/v passed its "
        f"layout checks), CUDA cores {counts['flash_attention']}; router "
        f"launches "
        f"{counts['router_topk']}, peak memory {peak:.2f} GiB; "
        f"{PREFILL_NEW} decode steps after it {dec:.3f} s, tokens {out}  "
        f"[{ctx['card']}]")
    del logits, cache
    prefill_f32(torch, ctx, cfg, params, toks)
    del ctx["lm_params"]
    torch.cuda.empty_cache()
    prefill_agreement(torch, cfg, params)
    prefill_agreement(torch, cfg, params, dtype="float32")


def prefill_f32(torch, ctx, cfg, params, toks):
    """granite's prefill with float32 activations (``cfg.dtype =
    "float32"``), full width and depth, B=1, on the phase's parameters and
    tokens: flash through the CUDA-core kernel once a layer, the
    tensor-core kernel never (counted from 0). Its logits must be finite;
    prints its wall s, peak GiB and, from one profiled call, the float32
    flash kernel's share of the device time."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.models import model as M
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, _ = M.prefill(params, {"tokens": toks}, cfg32)
    wall, counts = lm_counts_after(torch, ctx, "prefill_f32", {
        "flash_attention": cfg.n_layers, "router_topk": cfg.n_layers}, t0,
        record=("flash_attention",))
    keep_path(ctx, "prefill_f32", counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(logits.shape == (1, 1, cfg.vocab_padded) and
          logits.dtype == torch.float32 and
          bool(torch.isfinite(logits).all()),
          "prefill_f32: logits not finite, or of the wrong shape or type")
    del logits
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        M.prefill(params, {"tokens": toks}, cfg32)
        torch.cuda.synchronize()
        again = time.perf_counter() - t1
    rows, device_s = device_rows(prof)
    flash = [r for r in rows if "flash_fwd_kernel<" in r[2]]
    check(sum(r[1] for r in flash) == cfg.n_layers,
          f"prefill_f32 profile: {sum(r[1] for r in flash)} float32 flash "
          f"kernels on the device, expected {cfg.n_layers}")
    flash_s = sum(r[0] for r in flash) / 1e6
    log("prefill", f"{cfg.name} float32 B=1 S={PREFILL_S}: prefill "
        f"{wall:.3f} s, flash launches: CUDA cores "
        f"{counts['flash_attention']}, tensor cores "
        f"{counts['flash_attention_tc']}; router launches "
        f"{counts['router_topk']}, peak memory {peak:.2f} GiB; one profiled "
        f"call {again:.3f} s, device busy {device_s:.3f} s = "
        f"{device_s / again:.1%} of it, the float32 flash kernel "
        f"{flash_s * 1e3:.2f} ms ({flash_s * 1e3 / cfg.n_layers:.4f} ms a "
        f"layer) = {flash_s / device_s:.1%} of the device time  "
        f"[{ctx['card']}]")
    log_rows("prefill", rows, n=8)


def greedy(torch, logits, cfg):
    lf = logits.float()
    lf[..., cfg.vocab_size:] = float("-inf")
    return torch.argmax(lf, dim=-1).to(torch.int32)


def prefill_agreement(torch, cfg, params, depth=1, tag="prefill", first=0,
                      dtype=None):
    """``depth`` layers at full width (a depth below one pattern period
    keeps the period's positions from ``first`` on), S = 4096: prefill
    (flash kernel in
    the full layers, the band in sliding-window ones) against
    token-by-token decode from scratch (dense attention against the
    cache, windowed in sliding-window layers), both with the router
    kernel in MoE layers. Drop-free expert capacity, as the reference's
    own decode-vs-forward test: a full-sequence MoE drops tokens at
    capacity, a one-token step never does. Prefill's last logits, and the
    logits of the steps after it fed the same tokens, agree within the
    tolerance of the activations' type (``dtype``, default the
    config's: ``LM_TOL``), and the 8 greedy tokens are equal."""
    import dataclasses
    import numpy as np
    from repro_torch.models import model as M
    pattern = cfg.pattern[first:first + min(depth, cfg.period)]
    cfg2 = dataclasses.replace(cfg, n_layers=depth, pattern=pattern,
                               dtype=dtype or cfg.dtype)
    tol = LM_TOL[cfg2.dtype]
    if cfg.moe is not None:
        cfg2 = dataclasses.replace(cfg2, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    reps = depth // len(pattern)
    p2 = dict(params, layers={
        f"pos{i}": {kk: _index_repeats(vv, reps) for kk, vv in
                    params["layers"][f"pos{first + i}"].items()}
        for i in range(len(pattern))})
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
    check(torch.allclose(lp.float(), ld.float(), rtol=tol, atol=tol),
          f"prefill vs stepwise decode ({cfg2.dtype}): last logits differ "
          f"({errs[0]:.3g})")
    for t in range(8):
        a, b = greedy(torch, lp, cfg2), greedy(torch, ld, cfg2)
        check(torch.equal(a, b), f"prefill vs stepwise decode "
              f"({cfg2.dtype}): greedy token {t} differs ({int(a)} vs "
              f"{int(b)})")
        lp, cache_p = M.decode_step(p2, cache_p, {"tokens": b},
                                    PREFILL_S + t, cfg2)
        ld, cache_d = M.decode_step(p2, cache_d, {"tokens": b},
                                    PREFILL_S + t, cfg2)
        errs.append(float(torch.max(torch.abs(lp.float() - ld.float()))))
        check(torch.allclose(lp.float(), ld.float(), rtol=tol, atol=tol),
              f"prefill vs stepwise decode ({cfg2.dtype}): step {t} logits "
              f"differ ({errs[-1]:.3g})")
    log(tag, f"{cfg.name} {cfg2.dtype} agreement at depth {depth} (pattern "
        f"positions {first}-{first + len(pattern) - 1}), full width, "
        f"S={PREFILL_S}: "
        f"prefill vs {PREFILL_S} one-token steps, max |logit err| "
        f"{max(errs):.3g} over the last prompt position and 8 steps after "
        f"(tolerance {tol}); the 8 greedy tokens equal; "
        f"{time.perf_counter() - t0:.1f} s")


def _index_repeats(tree, n):
    if isinstance(tree, dict):
        return {k: _index_repeats(v, n) for k, v in tree.items()}
    return tree[:n]


# ---------------------------------------------------------------------------
# phase 11: the dense decoder family served at full width
# ---------------------------------------------------------------------------

# (arch, layers run or None for all, why) in the order the phase serves
# them, each at its published widths
ARCH_CELLS = (
    ("phi3_mini_3p8b", None, "fits"),
    ("phi4_mini_3p8b", None, "fits"),
    ("starcoder2_7b", None, "fits"),
    ("gemma3_1b", None, "fits"),
    ("musicgen_large", None, "fits"),
    ("internvl2_76b", 2, "80 layers of float32 weights (~280 GB) do not fit "
     "one card"),
    ("llama4_maverick_400b_a17b", 2, "one (dense, MoE) pattern period in "
     "bfloat16; 400B parameters do not fit one card"),
    ("jamba_1p5_large_398b", 5, "pattern positions 0-4 (mamba + dense, "
     "mamba + MoE twice each, attention + dense: every layer kind) in "
     "bfloat16, 24.0e9 parameters; one period of 8 is 45.2e9 (84 GiB) and "
     "does not fit one 80 GB card"),
    ("rwkv6_3b", None, "fits"),
)
# prefill-vs-stepwise agreements at full width: arch -> (depth, first
# pattern position): gemma3's positions 4-5, the last sliding-window layer
# of its period and the global one; jamba's position 0, a Mamba layer
# with a dense MLP (granite's agreement holds the MoE path). The depths
# keep the whole script under 900 s: a one-token step costs 2-3.3 ms a
# layer on the H100, so the 4,096 steps take 8-14 s a layer.
ARCH_AGREEMENTS = {"gemma3_1b": (2, 4), "phi3_mini_3p8b": (1, 0),
                   "jamba_1p5_large_398b": (1, 0), "rwkv6_3b": (1, 0)}


def arch_batch(torch, cfg, B, S, seed):
    """A [B, S] batch for ``cfg``'s input mode on the card, from a seeded
    numpy generator: token ids, codebook ids [B, S, n] or embeddings
    [B, S, D] in the activation dtype."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        return {"embeddings": torch.tensor(
            rng.standard_normal((B, S, cfg.d_model), dtype=np.float32),
            device=DEVICE).to(cfg.act_dtype)}
    shape = (B, S) if cfg.input_mode == "tokens" else (B, S, cfg.n_codebooks)
    return {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, shape),
                                   dtype=torch.int32, device=DEVICE)}


def arch_layers(cfg, field, kind) -> int:
    """How many of ``cfg``'s layers have ``spec.<field> == kind``."""
    return sum(getattr(s, field) == kind for s in cfg.pattern) * \
        cfg.n_repeats


def keep_path(ctx, tag, counts):
    ctx["paths"][tag] = {n: c for n, c in counts.items() if c}


def keep_peak(torch, ctx, tag, arch, cell, base, cfg_overrides=None,
              hp=None):
    """The peak of a run the roofline phase dry-runs: the bytes allocated
    at its peak (``max_memory_allocated`` since the run's reset) above
    ``base``, the bytes allocated before the run's parameters or state
    were made; with what ``dryrun.run_cell`` needs to build the cell."""
    ctx.setdefault("peaks", {})[tag] = {
        "arch": arch, "cell": cell, "cfg_overrides": cfg_overrides,
        "hp": hp, "measured": torch.cuda.max_memory_allocated() - base}


def keep_rank_peaks(ctx, tag, arch, cell, mesh, measured, moved, hp=None,
                    cfg_overrides=None):
    """The peaks of a run over ranks that the roofline phase dry-runs
    rank by rank on its own ``meta`` mesh (``make_host_mesh(*mesh)``):
    each rank's bytes allocated at its peak above its base, and the
    collectives its communicator counted a step (None where the run
    did not keep them)."""
    ctx.setdefault("rank_peaks", {})[tag] = {
        "arch": arch, "cell": cell, "mesh": mesh, "hp": hp,
        "cfg_overrides": cfg_overrides, "measured": measured,
        "moved": moved}


def serve_arch(torch, ctx, cfg, params, origin):
    """``ServeEngine.run`` at granite's serve shapes (batch SERVE_BATCH,
    SERVE_REQUESTS x 12-token prompts, 16 new tokens; codebook prompts
    [12, n]). The
    engine takes no embeddings config: that one steps ``make_serve_step``
    through the engine's rounds (two groups of 12 + 16 positions) over
    seeded embeddings, with the engine's one host read a step. The router
    must launch once a MoE layer a step, flash never. ``origin``: (arch,
    the config's cut as ``cfg_overrides``, the bytes allocated before the
    parameters were made) for the roofline phase."""
    import numpy as np
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import make_serve_step
    n_moe = arch_layers(cfg, "mlp", "moe")
    tag = f"archs-{cfg.name}-serve"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if cfg.input_mode == "embeddings":
        step = make_serve_step(cfg)
        emb = arch_batch(torch, cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW,
                         0)["embeddings"]
        n_steps, outs = 0, []
        reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(-(-SERVE_REQUESTS // SERVE_BATCH)):
            cache = M.init_cache(cfg, SERVE_BATCH, SERVE_MAX_SEQ,
                                 device=DEVICE)
            for p in range(SERVE_PROMPT + SERVE_NEW):
                nxt, cache, _ = step(params, cache, emb[:, p:p + 1], p)
                n_steps += 1
                if p >= SERVE_PROMPT:
                    outs.append(nxt.cpu().numpy().reshape(-1))
        n_tok = SERVE_REQUESTS * SERVE_NEW
        check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
              f"{tag}: tokens out of the vocabulary")
        first = [int(o[0]) for o in outs[:SERVE_NEW]]
    else:
        engine = ServeEngine(cfg, None, params, batch=SERVE_BATCH,
                             max_seq=SERVE_MAX_SEQ)
        step_fn = engine.step_fn
        n_steps = 0

        def counted(*args):
            nonlocal n_steps
            n_steps += 1
            return step_fn(*args)

        engine.step_fn = counted
        rng = np.random.default_rng(0)
        shape = (SERVE_PROMPT,) if cfg.input_mode == "tokens" else \
            (SERVE_PROMPT, cfg.n_codebooks)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, shape)
                        .astype(np.int32), max_new=SERVE_NEW)
                for i in range(SERVE_REQUESTS)]
        reset_launch_counts()
        t0 = time.perf_counter()
        engine.run(reqs)
        n_tok = sum(len(r.out) for r in reqs)
        for r in reqs:
            check(r.done and len(r.out) == SERVE_NEW and
                  all(0 <= t < cfg.vocab_size for t in r.out),
                  f"{tag}: request {r.uid} transcript {r.out}")
        first = reqs[0].out
    wall, counts = lm_counts_after(torch, ctx, tag, {
        "router_topk": n_moe * n_steps}, t0, record=())
    keep_path(ctx, tag, counts)
    keep_peak(torch, ctx, tag, origin[0], SERVE_CELL, origin[2],
              cfg_overrides=origin[1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("archs", f"{cfg.name} serve: batch {SERVE_BATCH}, {SERVE_REQUESTS} "
        f"requests x {SERVE_PROMPT}-position prompts, {SERVE_NEW} new tokens"
        f" each: {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.2f} "
        f"tokens/s, {n_steps} steps at {wall / n_steps * 1e3:.2f} ms a step;"
        f" router launches {counts['router_topk']} = {n_moe} x {n_steps}, "
        f"flash launches {counts['flash_attention_tc']}; peak memory "
        f"{peak:.2f} GiB; request 0: {first}  [{ctx['card']}]")


def prefill_arch(torch, ctx, cfg, params, origin):
    """``prefill`` at B=1, S=4096 (tensor-core flash once a full-attention
    layer, the band in sliding-window layers, the router once a MoE
    layer), then ``extend_cache`` and PREFILL_NEW greedy decode steps
    (seeded embeddings for the embeddings config)."""
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.models import model as M
    n_full = arch_layers(cfg, "attn", "full")
    n_moe = arch_layers(cfg, "mlp", "moe")
    tag = f"archs-{cfg.name}-prefill"
    batch = arch_batch(torch, cfg, 1, PREFILL_S, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, batch, cfg)
    wall, counts = lm_counts_after(torch, ctx, tag, {
        "flash_attention_tc": n_full, "router_topk": n_moe}, t0, record=())
    keep_path(ctx, tag, counts)
    keep_peak(torch, ctx, tag, origin[0], PREFILL_CELL, origin[2],
              cfg_overrides=origin[1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    heads = (cfg.n_codebooks,) if cfg.input_mode == "codebooks" else ()
    check(tuple(logits.shape) == (1, 1, *heads, cfg.vocab_padded) and
          bool(torch.isfinite(logits.float()).all()),
          f"{tag}: logits not finite or of the wrong shape "
          f"{tuple(logits.shape)}")
    cache = M.extend_cache(cache, cfg, PREFILL_S + PREFILL_NEW)
    out = []
    t1 = time.perf_counter()
    for t in range(PREFILL_NEW):
        nxt = greedy(torch, logits, cfg)
        out.append(nxt.reshape(-1).tolist())
        step = (arch_batch(torch, cfg, 1, 1, 100 + t)
                if cfg.input_mode == "embeddings" else {"tokens": nxt})
        logits, cache = M.decode_step(params, cache, step, PREFILL_S + t,
                                      cfg)
    torch.cuda.synchronize()
    dec = time.perf_counter() - t1
    check(bool(torch.isfinite(logits.float()).all()),
          f"{tag}: decode logits not finite")
    log("archs", f"{cfg.name} prefill B=1 S={PREFILL_S}: {wall:.3f} s, "
        f"flash launches {counts['flash_attention_tc']} = {n_full} "
        f"full-attention layers (of {cfg.n_layers}), router launches "
        f"{counts['router_topk']} = {n_moe} MoE layers, peak memory "
        f"{peak:.2f} GiB; {PREFILL_NEW} decode steps after it {dec:.3f} s "
        f"= {dec / PREFILL_NEW * 1e3:.2f} ms a step, tokens "
        f"{[o[0] for o in out]}  [{ctx['card']}]")
    return wall


def ssm_layer_profile(torch, ctx, cfg, params, prefill_s):
    """Where an SSM config's prefill goes: its first SSM layer alone at
    B=1, S=4096 (repeat 0's weights, seeded activations), and the layer's
    chunked recurrence alone (``ssm._ssm_scan`` / ``ssm._rwkv_scan``, on
    seeded inputs of the path's shapes and ranges): the host-clock
    milliseconds of each (median of 3, ended by a synchronize), its device
    time and device kernels by the profiler, and the share of the
    prefill's ``prefill_s`` that the config's SSM layers take at that
    time."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm as SSM
    i, spec = next((j, sp) for j, sp in enumerate(cfg.pattern)
                   if sp.attn in ("mamba", "rwkv"))
    kind = spec.attn
    n_layers = arch_layers(cfg, "attn", kind)
    p = {k: v[0] for k, v in params["layers"][f"pos{i}"][
        "mamba" if kind == "mamba" else "rwkv_t"].items()}
    S, D = PREFILL_S, cfg.d_model
    gen = torch.Generator(device=DEVICE).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    x = randn(1, S, D).to(cfg.act_dtype)
    if kind == "mamba":
        di, ds, csz = cfg.mamba_expand * D, cfg.mamba_d_state, 128
        # dt as the layer makes it: softplus around the -4.6 bias
        dt = F.softplus(randn(1, S, di) - 4.6)
        b, xs, c = randn(1, S, ds), randn(1, S, di), randn(1, S, ds)
        a = -torch.exp(p["a_log"].float())

        def layer():
            return SSM.mamba_apply(p, x, cfg)

        def recurrence():
            return SSM._ssm_scan(dt, b, xs, c, a, csz)
    else:
        dh = cfg.rwkv_head_dim
        H, csz = D // dh, SSM.RWKV_CHUNK
        r, k, v = (randn(1, S, H, dh) for _ in range(3))
        # w_log as the layer makes it: -exp(w0 + lora) around w0 = -0.7
        wlog = torch.clamp(-torch.exp(-0.7 + 0.1 * randn(1, S, H, dh)),
                           min=SSM.W_LOG_MIN)
        u = p["u"].float()

        def layer():
            return SSM.rwkv_time_mix(p, x, cfg)

        def recurrence():
            return SSM._rwkv_scan(r, k, v, wlog, u)

    out = {}
    for name, fn in (("layer", layer), ("recurrence", recurrence)):
        ms = wall_ms(torch, fn, iters=3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows, device_s = device_rows(prof)
        out[name] = (ms, device_s * 1e3, sum(r_[1] for r_ in rows))
    (lms, ldev, lk), (rms, rdev, rk) = out["layer"], out["recurrence"]
    log("archs", f"{cfg.name} {kind} layer at B=1 S={S}: {lms:.2f} ms "
        f"(device {ldev:.2f} ms, {lk} device kernels), its recurrence over "
        f"{S // csz} chunks {rms:.2f} ms (device {rdev:.2f} ms, {rk} "
        f"kernels); {n_layers} {kind} layers x {lms:.2f} ms = "
        f"{n_layers * lms / (prefill_s * 1e3):.1%} of the prefill's "
        f"{prefill_s * 1e3:.1f} ms, the recurrences "
        f"{n_layers * rms / (prefill_s * 1e3):.1%}  [{ctx['card']}]")


def cut_config(cfg, depth):
    """(``cfg`` cut to its first ``depth`` layers, the cut as
    ``dataclasses.replace`` arguments); ``(cfg, None)`` for None. A cut
    below one pattern period keeps the period's first positions."""
    import dataclasses
    if depth is None:
        return cfg, None
    cut = {"n_layers": depth, "pattern": cfg.pattern[:min(depth, cfg.period)]}
    return dataclasses.replace(cfg, **cut), cut


def phase_archs(torch, ctx):
    """The dense-family and SSM configs at their published widths, one
    after another (ARCH_CELLS; a cut below one pattern period keeps the
    period's first positions), each with parameters made on the card from
    a seeded generator and freed before the next: the engine's serve
    shapes, a 4096-token prefill with decode after it, each SSM layer's
    time beside the prefill's, the prefill-vs-stepwise agreements of
    ARCH_AGREEMENTS, and the card against the CPU on the config's
    SMOKE."""
    from repro_torch import configs
    from repro_torch.models import model as M
    for arch, depth, why in ARCH_CELLS:
        t0 = time.perf_counter()
        cfg, cut = cut_config(configs.get_config(arch), depth)
        origin = (arch, cut, torch.cuda.memory_allocated())
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        params = M.init_params(cfg, gen, device=DEVICE)
        torch.cuda.synchronize()
        log("archs", f"{cfg.name}: {cfg.n_layers} layers "
            f"({'all' if depth is None else why}), pattern "
            f"{[f'{sp.attn}+{sp.mlp}' for sp in cfg.pattern]}, d_model "
            f"{cfg.d_model}, {M.param_count(params):,} parameters "
            f"({cfg.param_dtype}) made on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        serve_arch(torch, ctx, cfg, params, origin)
        wall = prefill_arch(torch, ctx, cfg, params, origin)
        if any(sp.attn in ("mamba", "rwkv") for sp in cfg.pattern):
            ssm_layer_profile(torch, ctx, cfg, params, wall)
        if arch in ARCH_AGREEMENTS:
            depth, first = ARCH_AGREEMENTS[arch]
            prefill_agreement(torch, cfg, params, depth, tag="archs",
                              first=first)
        del params
        torch.cuda.empty_cache()
        serve_agreement(torch, arch)
        lap(f"archs {cfg.name}", t0)


# ---------------------------------------------------------------------------
# phase 12: the training step (autograd through the kernels, card vs CPU)
# ---------------------------------------------------------------------------

# granite CONFIG trained at full width (the trainer phase): batch TRAIN_B x
# TRAIN_S tokens in TRAIN_MICRO microbatches
TRAIN_B, TRAIN_S, TRAIN_MICRO = 2, 4096, 2
TRAINER_CELL = ("trainer_a", TRAIN_S, TRAIN_B, "train")
# card against CPU in float32 (SMOKE): losses and grad norms within 1e-5
# relative; gradients, parameters and moments within 1e-4 of each leaf's
# largest value (cuBLAS and the CPU sum in other orders; Adam's first
# steps move near-zero gradients by up to lr); the influence within 1e-5
# relative (integer loads)
TRAIN_TOL = 1e-4


def leaf_close(torch, got, want) -> float:
    """max |got - want| over max |want| (1 when want is all zero and got
    is not)."""
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    scale = float(torch.max(torch.abs(w))) if w.numel() else 0.0
    err = float(torch.max(torch.abs(g - w))) if w.numel() else 0.0
    rel = err / scale if scale else (0.0 if err == 0 else 1.0)
    return rel


def train_flash_grad(torch, ctx):
    """``FlashAttentionFn`` at one granite layer of a B=1, S=4096 step
    (24:8 heads, dh 64, bf16): the forward is one tensor-core kernel launch
    held against the plain version row by row; dq, dk, dv of sum(out * w)
    (w holding bf16 values) against autograd through the plain version
    in float32 at the same bf16 inputs, row by row within FLASH_TOL (the
    backward recomputes the float32 function, so only the final bf16
    rounding of the gradients differs; the kernel's bf16 rounding of P
    touches the forward only).
    Then the forward kernel and the backward recompute timed with CUDA
    events."""
    import numpy as np
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ref import row_relative_error
    cfg = granite.CONFIG
    B, S, H, KV, dh = 1, PREFILL_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (t.requires_grad_() for t in
               flash_inputs(torch, B, S, H, KV, dh, torch.bfloat16, 7))
    # the cotangent in bf16 values: out is bf16, so the Function's
    # backward receives it rounded; the plain float32 path gets the same
    w = torch.tensor(np.random.default_rng(8).standard_normal(
        (B, S, H, dh)), dtype=torch.float32, device=DEVICE) \
        .to(torch.bfloat16).float()
    what = f"FlashAttentionFn B={B} S={S} H={H} KV={KV} dh={dh} bf16"
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v)
    torch.sum(out.float() * w).backward()
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    check(counts == {"flash_attention_tc": 1}, f"{what}: forward and "
          f"backward launched {counts}, expected the tensor-core kernel "
          "once")
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = flash_attention_plain(*ref)
    torch.sum(want * w).backward()
    tol = FLASH_TOL["bfloat16"]
    errs = {"out": row_relative_error(out, want)}
    for name, t, r in zip("qkv", (q, k, v), ref):
        check(t.grad is not None and t.grad.dtype == torch.bfloat16 and
              bool(torch.isfinite(t.grad.float()).all()),
              f"{what}: d{name} missing, not bf16 or not finite")
        errs[f"d{name}"] = row_relative_error(t.grad, r.grad)
    bad = {n: e for n, e in errs.items() if e > tol}
    check(not bad, f"{what}: per-row relative errors {bad} past {tol}")

    def fwd():
        return ops.flash_attention(q, k, v)

    def fwd_bwd():
        q.grad = k.grad = v.grad = None
        torch.sum(ops.flash_attention(q, k, v).float() * w).backward()

    fwd_ms = time_ms(torch, fwd, iters=10)
    both_ms = time_ms(torch, fwd_bwd, iters=3, warmup=1)
    log("train", f"{what}: per-row relative error against autograd "
        f"through the plain version: "
        f"{', '.join(f'{n} {e:.3g}' for n, e in errs.items())} (limit "
        f"{tol}); forward kernel {fwd_ms:.4f} ms, backward (plain float32 "
        f"recompute in {S // 512} query chunks) {both_ms - fwd_ms:.3f} ms = "
        f"{(both_ms - fwd_ms) / fwd_ms:.1f} x the forward  [{ctx['card']}]")


def train_router_gates(torch, ctx):
    """The router at granite's T=4096 (bf16 tokens, E=40, top-8, an
    influence in [0.8, 1.25]): the kernel's experts, and the gates that
    training takes at them (``moe.router_gates``: ``router_logits`` in
    cuBLAS float32, gathered) against the kernel's -eff within
    ROUTER_TOL; the gates' gradients in x and the centroids finite."""
    import numpy as np
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    m, D = granite.CONFIG.moe, granite.CONFIG.d_model
    x, c, _ = router_inputs(torch, PREFILL_S, m.n_experts, D, 9,
                            torch.bfloat16, True)
    infl = torch.tensor(np.random.default_rng(9).uniform(
        0.8, 1.25, m.n_experts), dtype=torch.float32, device=DEVICE)
    ops.reset_launch_counts()
    eidx, eff = ops.router_topk_divide(x, c, infl, m.top_k)
    xg, cg = x.detach().requires_grad_(), c.detach().requires_grad_()
    gates = MOE.router_gates({"centroids": cg}, xg, m, infl, eidx)
    torch.sum(torch.softmax(gates, dim=-1) * torch.arange(
        m.top_k, device=DEVICE)).backward()
    torch.cuda.synchronize()
    counts = {n: c for n, c in ops.launch_counts().items() if c}
    what = f"router gates T={PREFILL_S} E={m.n_experts} D={D} K={m.top_k}"
    check(counts == {"router_topk": 1}, f"{what}: launched {counts}")
    err = float(torch.max(torch.abs(-gates.detach() - eff)))
    check(torch.allclose(-gates.detach(), eff, rtol=ROUTER_TOL,
                         atol=ROUTER_TOL),
          f"{what}: recomputed eff differs from the kernel's (max |err| "
          f"{err:.3g})")
    check(bool(torch.isfinite(xg.grad).all() and
               torch.isfinite(cg.grad).all()) and
          float(torch.max(torch.abs(cg.grad))) > 0,
          f"{what}: gradients not finite or zero")
    log("train", f"{what}: recomputed eff (cuBLAS float32 router_logits at "
        f"the kernel's indices) against the kernel's: max |err| {err:.3g} "
        f"(rtol and atol {ROUTER_TOL}); d x and d centroids finite")


def _train_batch(torch, cfg, B, S, seed, device):
    import numpy as np
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                             (B, S + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(t[:, :-1]).to(device),
            "labels": torch.from_numpy(t[:, 1:]).to(device)}


def _grads(params):
    from repro_torch.optim.adamw import tree_leaves
    return [p.grad for p in tree_leaves(params)]


def train_smoke_agreement(torch, ctx):
    """granite SMOKE in float32: three steps of ``make_train_step`` (two
    microbatches, remat) on the card (the router kernel) and on the CPU
    (its plain version) from one state on the same batches: metrics,
    parameters, moments and influence within TRAIN_TOL. jamba and rwkv6
    SMOKE in float32: ``loss_fn(forward)`` and its gradients on both."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    cfg = dataclasses.replace(configs.get_config(
        "granite_moe_3b_a800m", smoke=True), dtype="float32")
    hp = TrainHParams(microbatches=2, lr_peak=5e-3, warmup_steps=2,
                      total_steps=50)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(3), hp,
                           device="cpu")
    card = _to_device(cpu, DEVICE)
    step = make_train_step(cfg, None, hp)
    reset_launch_counts()
    t0 = time.perf_counter()
    worst = {}
    for i in range(3):
        batch = _train_batch(torch, cfg, 4, 32, 10 + i, "cpu")
        card, mc = step(card, _to_device(batch, DEVICE))
        cpu, mh = step(cpu, batch)
        for key in ("loss", "grad_norm", "moe_dropped_frac"):
            a, b = float(mc[key]), float(mh[key])
            check(abs(a - b) <= 1e-5 * abs(b) + 1e-7, f"train SMOKE step "
                  f"{i}: {key} card {a} CPU {b}")
    n_route = 3 * hp.microbatches * cfg.n_layers * 2
    lm_counts_after(torch, ctx, "train-smoke", {
        "router_topk": n_route, "router_topk_plain": n_route}, t0,
        record=())
    for part, got, want in (("params", card["params"], cpu["params"]),
                            ("mu", card["opt"]["mu"], cpu["opt"]["mu"]),
                            ("nu", card["opt"]["nu"], cpu["opt"]["nu"])):
        worst[part] = max(leaf_close(torch, g, w) for g, w in
                          zip(tree_leaves(got), tree_leaves(want)))
    infl = float(torch.max(torch.abs(card["influence"].cpu() /
                                     cpu["influence"] - 1)))
    check(max(worst.values()) <= TRAIN_TOL and infl <= 1e-5,
          f"train SMOKE: card and CPU differ after 3 steps: {worst}, "
          f"influence {infl:.3g}")
    log("train", f"{cfg.name} float32, 3 steps (batch 4 x 32, 2 "
        f"microbatches, remat): card (router kernel) and CPU (plain) loss "
        f"{float(mc['loss']):.6f} / {float(mh['loss']):.6f}, grad_norm "
        f"{float(mc['grad_norm']):.6f} / {float(mh['grad_norm']):.6f}; "
        f"largest error over each leaf's largest value: "
        f"{', '.join(f'{k} {v:.3g}' for k, v in worst.items())}, "
        f"influence {infl:.3g} relative (tolerance {TRAIN_TOL}, 1e-5)")
    for arch in ("jamba_1p5_large_398b", "rwkv6_3b"):
        cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                                  dtype="float32")
        params = M.init_params(cfg, torch.Generator().manual_seed(5),
                               device="cpu")
        rs = MOE.init_router_state(cfg, device="cpu")
        batch = _train_batch(torch, cfg, 2, 64, 12, "cpu")
        out = {}
        for dev in (DEVICE, "cpu"):
            p = _to_device(params, dev)
            for leaf in tree_leaves(p):
                leaf.requires_grad_(True)
            b = _to_device(batch, dev)
            logits, _, _ = M.forward(p, b, cfg, influence=None if rs is None
                                     else rs["influence"].to(dev))
            loss = M.loss_fn(logits, b["labels"], cfg)
            loss.backward()
            out[dev] = (float(loss), _grads(p))
        (lc, gc), (lh, gh) = out[DEVICE], out["cpu"]
        errs = [leaf_close(torch, a, b) for a, b in zip(gc, gh)
                if a is not None or b is not None]
        check(abs(lc - lh) <= 1e-5 * abs(lh) and max(errs) <= TRAIN_TOL,
              f"train {cfg.name}: card and CPU differ: loss {lc} / {lh}, "
              f"largest gradient error {max(errs):.3g}")
        log("train", f"{cfg.name} float32 B=2 S=64, forward + grad: card "
            f"and CPU loss {lc:.6f} / {lh:.6f}, largest gradient error "
            f"over its leaf's largest value {max(errs):.3g} over "
            f"{len(errs)} leaves (tolerance {TRAIN_TOL})")


def train_remat_bits(torch, ctx):
    """granite SMOKE (head dim 16, the smallest the flash kernels take: the
    SMOKE's 8 is not built) in its bf16 activations at B=1, S=4096, on the
    card: the loss, logits and every gradient with ``remat=True`` (each
    layer recomputed in the backward, its flash and router kernels
    launched again) bit-equal to ``remat=False``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(configs.get_config(
        "granite_moe_3b_a800m", smoke=True), head_dim=16)
    params = M.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(6), device=DEVICE)
    infl = MOE.init_router_state(cfg, device=DEVICE)["influence"]
    batch = _train_batch(torch, cfg, 1, PREFILL_S, 13, DEVICE)

    def run(remat, tag):
        for p in tree_leaves(params):
            p.requires_grad_(True)
            p.grad = None
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, _ = M.forward(params, batch, cfg, remat=remat,
                                 influence=infl)
        loss = M.loss_fn(logits, batch["labels"], cfg)
        loss.backward()
        n = cfg.n_layers * (2 if remat else 1)
        lm_counts_after(torch, ctx, tag, {"flash_attention_tc": n,
                                          "router_topk": n}, t0, record=())
        return loss.detach(), logits.detach(), \
            [g.clone() for g in _grads(params) if g is not None]

    plain = run(False, "train-remat")
    remat = run(True, "train-remat")
    same = torch.equal(plain[0], remat[0]) and \
        torch.equal(plain[1], remat[1]) and \
        all(torch.equal(a, b) for a, b in zip(plain[2], remat[2]))
    if not same:
        again = run(False, "train-remat")
        base = all(torch.equal(a, b) for a, b in zip(plain[2], again[2]))
        raise SmokeError(f"train: remat=True differs from remat=False on "
                         f"{cfg.name} at S={PREFILL_S}; two remat=False runs "
                         f"{'agree' if base else 'differ too'}")
    log("train", f"{cfg.name} (head dim 16) bf16 B=1 S={PREFILL_S}: loss, "
        f"logits and {len(plain[2])} gradients with remat bit-equal to "
        f"without (flash and router launched {cfg.n_layers} times without, "
        f"{2 * cfg.n_layers} with)")


def phase_train(torch, ctx):
    t0 = time.perf_counter()
    train_flash_grad(torch, ctx)
    train_router_gates(torch, ctx)
    t0 = lap("train: flash autograd and router gates", t0)
    train_smoke_agreement(torch, ctx)
    t0 = lap("train: SMOKE card vs CPU", t0)
    train_remat_bits(torch, ctx)
    lap("train: remat bit-equality", t0)


# ---------------------------------------------------------------------------
# phase 13: the training loop (granite trained, preempted and resumed)
# ---------------------------------------------------------------------------

# granite SMOKE through launch.train.main: batch x seq in microbatches,
# steps (a checkpoint every 2), and the step the preempted run is
# interrupted in (and saves)
TRAINER_SMOKE = {"batch": 4, "seq": 32, "micro": 2, "steps": 6,
                 "preempt": 3}
# granite CONFIG: A trains TRAINER_STEPS steps; B is interrupted in step
# TRAINER_PREEMPT and saves it; C restores it and trains to TRAINER_STEPS
# (3 steps: cut from 4 for time, PERF.md §5)
TRAINER_STEPS, TRAINER_PREEMPT = 3, 2
# C's losses against A's (the same steps on the same batches)
TRAINER_TOL = 1e-5
# git-ignored, on the checkout's disk (/tmp may be a small tmpfs)
CKPT_ROOT = ROOT / "build" / "trainer-ckpt"


@contextlib.contextmanager
def sigint_inside_update(at_step):
    """Send SIGINT from inside ``adamw_update`` of the step that makes
    ``at_step``, half way through its in-place updates of the leaves."""
    import signal
    from repro_torch.optim import adamw as ADAMW
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import step as STEP
    inner_update, inner_slices = STEP.adamw_update, ADAMW._slices
    left = [0]          # _slices calls until the signal

    def update(params, grads, opt_state, cfg, lr):
        if int(opt_state["step"]) + 1 == at_step:
            n = len(tree_leaves(params))
            left[0] = n + n // 2      # global_norm's calls, then half
        return inner_update(params, grads, opt_state, cfg, lr)

    def slices(*ts):
        if left[0]:
            left[0] -= 1
            if not left[0]:
                signal.raise_signal(signal.SIGINT)
        yield from inner_slices(*ts)

    STEP.adamw_update, ADAMW._slices = update, slices
    try:
        yield
    finally:
        STEP.adamw_update, ADAMW._slices = inner_update, inner_slices


def same_state(torch, got, want) -> bool:
    from repro_torch.optim.adamw import tree_leaves
    a, b = tree_leaves(got), tree_leaves(want)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.detach().cpu(),
                                           y.detach().cpu())
        for x, y in zip(a, b))


def metrics_of(history):
    return [{k: v for k, v in m.items() if k != "wall_s"} for m in history]


def trainer_smoke(torch, ctx):
    """granite and gemma3 SMOKE through ``launch.train.main`` on the card
    with a checkpoint every 2 steps. granite: an uninterrupted run (a);
    the same run with a SIGINT inside ``adamw_update`` of step
    ``preempt``, which must save that step and re-raise (b); a fresh
    ``Trainer`` resumed from it on ``islice(data, preempt, None)`` (c).
    Gates: c's final state equal bit for bit to a's last checkpoint, and
    its metrics to a's last steps; that checkpoint restored onto the CPU
    bit for bit, and a CPU-written copy restored onto the card; the
    router launched twice a layer a microbatch, flash never (S=32)."""
    import dataclasses
    import itertools
    import math
    import shutil
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.launch import train as LT
    from repro_torch.train import Trainer, abstract_train_state
    sm = TRAINER_SMOKE
    root = CKPT_ROOT / "smoke"
    shutil.rmtree(root, ignore_errors=True)

    def argv(arch, name):
        return ["--arch", arch, "--steps", str(sm["steps"]), "--batch",
                str(sm["batch"]), "--seq", str(sm["seq"]), "--microbatches",
                str(sm["micro"]), "--log-every", "1", "--ckpt-every", "2",
                "--ckpt-dir", str(root / name), "--device", DEVICE]

    every_two = list(range(2, sm["steps"] + 1, 2))
    gemma, hist = LT.main(argv("gemma3-1b", "gemma3"))
    check(gemma.ckpt.all_steps() == every_two and len(hist) == sm["steps"]
          and all(math.isfinite(m["loss"]) for m in hist),
          f"trainer SMOKE gemma3: checkpoints {gemma.ckpt.all_steps()}, "
          f"history {hist}")
    reset_launch_counts()
    t0 = time.perf_counter()
    a, hist_a = LT.main(argv("granite-moe-3b-a800m", "a"))
    n = sm["steps"] * sm["micro"] * a.cfg.n_layers * 2
    _, counts = lm_counts_after(torch, ctx, "trainer-smoke",
                                {"router_topk": n}, t0, record=())
    keep_path(ctx, "trainer-smoke", counts)
    check(a.ckpt.all_steps() == every_two,
          f"trainer SMOKE granite: checkpoints {a.ckpt.all_steps()}")
    interrupted = False
    with sigint_inside_update(sm["preempt"]):
        try:
            LT.main(argv("granite-moe-3b-a800m", "b"))
        except KeyboardInterrupt:
            interrupted = True
    saved = CheckpointManager(str(root / "b")).all_steps()
    check(interrupted and saved == [2, sm["preempt"]],
          f"trainer SMOKE: the preempted run raised {interrupted}, saved "
          f"{saved}, want [2, {sm['preempt']}]")
    c = Trainer(a.cfg, a.rules, a.hp,
                dataclasses.replace(a.tc, ckpt_dir=str(root / "b")))
    state, start = c.init_or_resume()
    check(start == sm["preempt"], f"trainer SMOKE resumed at {start}")
    data = itertools.islice(iter(SyntheticLM(a.cfg, sm["batch"], sm["seq"])),
                            start, None)
    state, hist_c = c.fit(data, state, start)
    like = abstract_train_state(a.cfg, a.hp)
    want, _ = CheckpointManager(str(root / "a")).restore(like,
                                                         device=DEVICE)
    check(same_state(torch, state, want) and
          metrics_of(hist_c) == metrics_of(hist_a[start:]),
          f"trainer SMOKE: resumed from step {start}, the final state or "
          f"the metrics differ from the uninterrupted run: "
          f"{metrics_of(hist_c)} vs {metrics_of(hist_a[start:])}")
    cpu, _ = CheckpointManager(str(root / "a")).restore(like, device="cpu")
    CheckpointManager(str(root / "cpu")).save(sm["steps"], cpu)
    back, _ = CheckpointManager(str(root / "cpu")).restore(like,
                                                           device=DEVICE)
    check(same_state(torch, cpu, want) and same_state(torch, back, want),
          "trainer SMOKE: a checkpoint moved between the card and the CPU "
          "changed")
    shutil.rmtree(root, ignore_errors=True)
    gemma_losses = ", ".join(f"{m['loss']:.4f}" for m in hist)
    resumed = ", ".join(f"{m['loss']:.6f}" for m in hist_c)
    log("trainer", f"SMOKE via launch.train.main on {DEVICE} (batch "
        f"{sm['batch']} x {sm['seq']}, {sm['micro']} microbatches, "
        f"{sm['steps']} steps, a checkpoint every 2): gemma3 losses "
        f"{gemma_losses}; granite router launched {counts['router_topk']} "
        f"times; SIGINT inside adamw_update of step {sm['preempt']} saved "
        f"steps {saved} and re-raised; the resumed run's final state and "
        f"its steps {start + 1}-{sm['steps']} metrics bit-equal to the "
        f"uninterrupted run (losses {resumed}); the card's checkpoint "
        f"restored on the CPU and a CPU-written copy on the card bit for "
        f"bit")


def mem_available() -> int:
    """MemAvailable of /proc/meminfo in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return -1


def trainer_full(torch, ctx):
    """granite CONFIG through ``Trainer`` at the train phase's shapes
    (batch TRAIN_B x TRAIN_S from ``SyntheticLM`` in TRAIN_MICRO
    microbatches, remat, float32 state, bf16 activations), with the
    launcher's ``TrainHParams``.

    A: TRAINER_STEPS steps, no checkpoint: s a step, tokens/s, the
    optimizer's share (``adamw_update`` timed by a synchronizing wrapper),
    peak memory; flash and router launched twice a layer a microbatch and
    nothing else; the influence moved; one more step profiled.
    B: a fresh run, SIGINT inside ``adamw_update`` of step
    TRAINER_PREEMPT: it must save that step (params, mu, nu, influence,
    step) and re-raise; the save's seconds, GB/s and bytes on disk.
    C: that checkpoint restored into ``abstract_train_state`` on the card
    (peak under 80 GB), then steps TRAINER_PREEMPT+1.. on the same
    batches: losses within TRAINER_TOL of A's (bit-equality printed)."""
    import gc
    import itertools
    import math
    import shutil
    from repro_torch import configs
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.rules import resolve_rules
    from repro_torch.kernels.ops import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import (Trainer, TrainerConfig, TrainHParams,
                                   abstract_train_state)
    from repro_torch.train import step as STEP
    cfg = granite.CONFIG
    # launch/train.py's hyperparameters for --steps TRAINER_STEPS
    hp = TrainHParams(microbatches=TRAIN_MICRO, lr_peak=3e-4,
                      warmup_steps=max(TRAINER_STEPS // 10, 1),
                      total_steps=TRAINER_STEPS, grad_compress="none")
    rules = resolve_rules(make_host_mesh(device=DEVICE), cfg, "train",
                          batch_size=TRAIN_B,
                          overrides=configs.sharding_overrides(
                              "granite-moe-3b-a800m", "train"))
    card = ctx["card"]

    def data(start=0):
        return itertools.islice(iter(SyntheticLM(cfg, TRAIN_B, TRAIN_S)),
                                start, None)

    def losses(hist):
        return [m["loss"] for m in hist]

    # A: uninterrupted
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, rules, hp, TrainerConfig(steps=TRAINER_STEPS,
                                                    log_every=1))
    t0 = time.perf_counter()
    state, _ = trainer.init_or_resume()
    torch.cuda.synchronize()
    n_params = M.param_count(state["params"])
    state_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(state))
    log("trainer", f"{cfg.name}: {n_params:,} parameters; params, moments, "
        f"influence and step {state_bytes / 1e9:.2f} GB made on the card "
        f"in {time.perf_counter() - t0:.3f} s")
    opt_s = []
    inner = STEP.adamw_update

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - t)
        return out

    STEP.adamw_update = timed_update
    try:
        reset_launch_counts()
        t_run = time.perf_counter()
        state, hist_a = trainer.fit(data(), state, 0)
    finally:
        STEP.adamw_update = inner
    n = TRAINER_STEPS * TRAIN_MICRO * cfg.n_layers * 2
    _, counts = lm_counts_after(torch, ctx, "trainer", {
        "flash_attention_tc": n, "router_topk": n}, t_run, record=())
    keep_path(ctx, "trainer", counts)
    keep_peak(torch, ctx, "trainer", "granite_moe_3b_a800m", TRAINER_CELL,
              base, hp=hp)
    peak_a = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in hist_a), f"trainer A: {hist_a}")
    infl = state["influence"]
    check(bool((infl > 0).all()) and not bool((infl == 1).all()),
          "trainer A: the influence did not move or is not positive")
    walls = [m["wall_s"] for m in hist_a]
    walls = [walls[0]] + [b - a for a, b in zip(walls, walls[1:])]
    steady = walls[1:]
    s_step = sum(steady) / len(steady)
    ctx["trainer_step_s"] = s_step
    opt_share = sum(opt_s[1:]) / sum(steady)
    log("trainer", f"A: {cfg.name} full width through Trainer.fit, batch "
        f"{TRAIN_B} x {TRAIN_S} (SyntheticLM) in {TRAIN_MICRO} "
        f"microbatches, remat, float32 state, bf16 activations: steps "
        f"{', '.join(f'{w:.3f}' for w in walls)} s (steady {s_step:.3f} s a "
        f"step = {TRAIN_B * TRAIN_S / s_step:.1f} tokens/s), optimizer "
        f"{', '.join(f'{t:.3f}' for t in opt_s)} s = {opt_share:.1%} of a "
        f"steady step, loss {', '.join(f'{v:.6f}' for v in losses(hist_a))}"
        f", peak memory {peak_a:.2f} GiB, flash launches "
        f"{counts['flash_attention_tc']} and router {counts['router_topk']}"
        f" = {cfg.n_layers} layers x 2 (forward, recompute) x {TRAIN_MICRO}"
        f" microbatches x {TRAINER_STEPS} steps; influence moved: |log| "
        f"max {float(torch.log(infl).abs().max()):.4f}, min "
        f"{float(infl.min()):.4f}  [{card}]")
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in next(data(TRAINER_STEPS)).items()}
    profile_call(torch, ctx, "trainer",
                 lambda: trainer.step_fn(state, batch))
    del state, trainer, batch, infl
    gc.collect()
    torch.cuda.empty_cache()

    # B: preempted inside step TRAINER_PREEMPT; it saves that step
    ckpt_dir = CKPT_ROOT / "full"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt_dir.mkdir(parents=True)
    try:
        need = sum(x.numel() * x.element_size() for x in tree_leaves(
            abstract_train_state(cfg, hp)))
        free = shutil.disk_usage(ckpt_dir).free
        avail = mem_available()
        log("trainer", f"B: the checkpoint needs {need:,} bytes; "
            f"{ckpt_dir} has {free:,} bytes free; host "
            f"MemAvailable {avail:,} bytes; card memory allocated "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
        check(free > need, f"trainer B: {free:,} bytes free on the disk "
              f"of {ckpt_dir}, the checkpoint needs {need:,}")
        trainer = Trainer(cfg, rules, hp, TrainerConfig(
            steps=TRAINER_STEPS, log_every=1, ckpt_dir=str(ckpt_dir)))
        interrupted = False
        t0 = time.perf_counter()
        with sigint_inside_update(TRAINER_PREEMPT):
            try:
                trainer.fit(data())
            except KeyboardInterrupt:
                interrupted = True
        wall_b = time.perf_counter() - t0
        steps = trainer.ckpt.all_steps()
        check(interrupted and steps == [TRAINER_PREEMPT],
              f"trainer B: raised {interrupted}, saved {steps}")
        st = trainer.ckpt.stats["save"]
        step_dir = ckpt_dir / f"step_{TRAINER_PREEMPT:09d}"
        on_disk = sum(f.stat().st_size for f in step_dir.iterdir())
        hist_b = list(trainer.history)
        check(st["bytes"] == need, f"trainer B: saved {st['bytes']:,} "
              f"bytes, the state holds {need:,}")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        log("trainer", f"B: SIGINT inside adamw_update of step "
            f"{TRAINER_PREEMPT}: the step completed, step {steps} saved "
            f"and KeyboardInterrupt re-raised ({wall_b:.1f} s from init); "
            f"save {st['call_s']:.3f} s for {st['bytes'] / 1e9:.3f} GB = "
            f"{st['bytes'] / 1e9 / st['call_s']:.3f} GB/s (device-to-host "
            f"copies {st['snapshot_s']:.3f} s; files, CRC32 beside them, "
            f"and the copies {st['write_s']:.3f} s), {on_disk:,} bytes on "
            f"disk; losses {', '.join(f'{v:.6f}' for v in losses(hist_b))} "
            f"(A's {', '.join(f'{v:.6f}' for v in losses(hist_a)[:len(hist_b)])}"
            f"); card memory after {torch.cuda.memory_allocated() / 2 ** 30:.2f}"
            f" GiB  [{card}]")

        # C: restore into the abstract state on the card, train on
        torch.cuda.reset_peak_memory_stats()
        mgr = CheckpointManager(str(ckpt_dir))
        state, start = mgr.restore(abstract_train_state(cfg, hp),
                                   device=DEVICE)
        rs = mgr.stats["restore"]
        peak_restore = torch.cuda.max_memory_allocated()
        trainer = Trainer(cfg, rules, hp, TrainerConfig(
            steps=TRAINER_STEPS, log_every=1))
        state, hist_c = trainer.fit(data(start), state, start)
        peak_c = torch.cuda.max_memory_allocated()
        want, got = losses(hist_a)[start:], losses(hist_c)
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        check(start == TRAINER_PREEMPT and len(got) == len(want) and
              rel <= TRAINER_TOL, f"trainer C: resumed at {start}, losses "
              f"{got} vs A's {want} (largest relative difference {rel:.3g})")
        check(peak_c < 80e9, f"trainer C: peak {peak_c:,} bytes")
        log("trainer", f"C: restore of step {start} into "
            f"abstract_train_state on the card {rs['call_s']:.3f} s for "
            f"{rs['bytes'] / 1e9:.3f} GB = {rs['bytes'] / 1e9 / rs['call_s']:.3f}"
            f" GB/s (reads {rs['read_s']:.3f} s, CRC32 {rs['crc_s']:.3f} s, "
            f"host-to-device {rs['load_s']:.3f} s; the file cache warm "
            f"from B's write), peak {peak_restore / 2 ** 30:.2f} GiB after "
            f"the restore and {peak_c / 2 ** 30:.2f} GiB with steps "
            f"{start + 1}-{TRAINER_STEPS} (limit 80 GB); losses "
            f"{', '.join(f'{v:.6f}' for v in got)} against A's "
            f"{', '.join(f'{v:.6f}' for v in want)}: largest relative "
            f"difference {rel:.3g} (limit {TRAINER_TOL}), bit-equal "
            f"{metrics_of(hist_c) == metrics_of(hist_a[start:])}  [{card}]")
        del state, trainer
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def phase_trainer(torch, ctx):
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    log("trainer", f"card memory allocated at the start: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    t0 = time.perf_counter()
    trainer_smoke(torch, ctx)
    t0 = lap("trainer: SMOKE via launch.train, preempted and resumed", t0)
    trainer_full(torch, ctx)
    lap("trainer: granite full width, A, B (save) and C (restore)", t0)


# ---------------------------------------------------------------------------
# phase 7g: training over data ranks
# ---------------------------------------------------------------------------

# granite at full width, depth cut to TRAINER_DP_LAYERS of 32 (two ranks
# each holding the whole expert leaves, 3.0e9 parameters of float32 state
# at full depth, cannot share one card), global batch TRAINER_DP_B x
# TRAIN_S in TRAIN_MICRO microbatches (a rank's microbatch at data=2 is
# 1 x 4096: flash runs), TRAINER_DP_STEPS steps with the launcher's
# TrainHParams, remat; TRAINER_DP_RANKS gloo ranks sharing the card
# against data=1 in this process on the same seed and batches; then the
# same at model=TRAINER_DP_RANKS (make_host_mesh(1, 2): heads, experts
# and vocabulary split, each rank making only its shards, a whole
# microbatch of 2 x 4096 on each) against the same data=1 run
TRAINER_DP_LAYERS, TRAINER_DP_B, TRAINER_DP_STEPS = 8, 4, 3
TRAINER_DP_RANKS = 2
TRAINER_DP_CELL = ("trainer_dp", TRAIN_S, TRAINER_DP_B, "train")
# data=2 against data=1 on the card: the batch's rows reach the bf16
# matmuls and the float32 sums in other groupings, and a router near-tie
# that flips moves a token's expert, a layer's load by 1 of its ~3,277
# target (the CPU tests hold float32 parity at 1e-5 / 1e-3 / 1e-6). Read
# on the H100 (PERF.md): 4.2e-7, 3.7e-6 and 6.8e-5 after 3 steps. The
# model=2 run is held to the same limits for the losses and grad_norm
# (read: 1.04e-5 and 6.45e-6): each rank's partial sums of wo and the
# experts round to bf16 before their all-reduce, once a layer, which
# moves 6-24 of a layer's 65,536 routed tokens in the first microbatch.
# Its influence is held to the limit where it first differs, in the
# first microbatch's update from the state as made (read: 3.83e-4). From
# there the routing depends on the influence itself, and eff = sq /
# infl^2 with sq ~ |x|^2 ~ D = 1536 for every expert turns a relative
# influence difference d into ~2 D d of effective distance against gaps
# of O(1) between the experts: 3.8e-4 reroutes tokens by the hundred,
# and the steps' influences part by 0.036-0.096 (read; printed, not
# gated), as two data=1 runs whose first microbatches rounded apart
# would
TRAINER_DP_TOL = {"loss": 1e-4, "grad_norm": 1e-2, "influence": 1e-2}


def trainer_dp_hp():
    """The train hyperparameters of every trainer_dp run."""
    from repro_torch.train import TrainHParams
    return TrainHParams(microbatches=TRAIN_MICRO, lr_peak=3e-4,
                        warmup_steps=max(TRAINER_DP_STEPS // 10, 1),
                        total_steps=TRAINER_DP_STEPS, grad_compress="none")


def trainer_dp_body(data, model=1):
    """On each of the ``data`` x ``model`` ranks (or in this process on
    one): granite at the phase's shapes through ``Trainer.fit`` over a
    ``make_host_mesh(data, model)`` mesh. The launch counts are set to 0
    just before the state is made (each rank making only its shards)
    and read after it, and again around the fit; this rank's collectives
    over the fit, its peak memory while it makes its state and while it
    trains, its last step under the profiler on rank 0 (the device time
    of its own kernels over the step's wall), and whether its leaves held
    whole are the same bits as every other rank's after the last step.
    Returns rank 0's summary with every rank's table."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.data import SyntheticLM
    from repro_torch.dist.rules import resolve_rules
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(granite.CONFIG, n_layers=TRAINER_DP_LAYERS)
    hp = trainer_dp_hp()
    mesh = make_host_mesh(data, model, device=DEVICE)
    rules = resolve_rules(mesh, cfg, "train", batch_size=TRAINER_DP_B,
                          overrides=configs.sharding_overrides(
                              "granite-moe-3b-a800m", "train"))
    comm = mesh.comm
    torch.cuda.synchronize()
    # what the process held before its state: the base of its peaks
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, rules, hp, TrainerConfig(
        steps=TRAINER_DP_STEPS, log_every=1))
    state, _ = trainer.init_or_resume()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = sum(launch_counts().values())
    init_peak = torch.cuda.max_memory_allocated()
    stream = SyntheticLM(cfg, TRAINER_DP_B, TRAIN_S)
    first = None
    if data == 1:
        # the first microbatch's forward from the state as made (the
        # influence at 1): its loads and its update of the influence,
        # before any routing depends on an influence of its own
        batch = next(iter(stream))
        with torch.no_grad():
            _, ninf, st = M.forward(
                state["params"], {k: torch.as_tensor(
                    v[:TRAINER_DP_B // TRAIN_MICRO], device=DEVICE)
                    for k, v in batch.items()},
                cfg, rules, remat=False, influence=state["influence"])
        first = (ninf.cpu().numpy(), st["moe_load"].cpu().numpy())
        del ninf, st
    # the last step of the fit runs under the profiler on rank 0 (its
    # device time: its own kernels), the others unprofiled
    inner, busy = trainer.step_fn, ["profiled on rank 0 only"]
    infl_steps = []

    def step_fn(state, batch):
        out = profiled_step(state, batch)
        infl_steps.append(out[0]["influence"].detach().cpu().numpy())
        return out

    def profiled_step(state, batch):
        if int(state["opt"]["step"]) + 1 < TRAINER_DP_STEPS or (
                comm is not None and comm.rank):
            return inner(state, batch)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        try:
            prof.__enter__()
        except Exception as e:      # noqa: BLE001 - a reading, printed
            busy[0] = f"the profiler did not start: {e!r}"[:200]
            return inner(state, batch)
        t1 = time.perf_counter()
        out = inner(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        prof.__exit__(None, None, None)
        busy[0] = (device_rows(prof)[1], wall)
        return out

    trainer.step_fn = step_fn
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    before = comm.counters() if comm is not None else None
    t0 = time.perf_counter()
    state, hist = trainer.fit(iter(stream), state, 0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {n: c for n, c in launch_counts().items() if c}
    moved = ({key: (after - before[key]) / TRAINER_DP_STEPS
              for key, after in comm.counters().items()}
             if comm is not None else {})
    peak = torch.cuda.max_memory_allocated()
    busy = busy[0]
    infl = state["influence"].detach()
    out = {"hist": [{k: v for k, v in m.items()} for m in hist],
           "influence": infl.cpu().numpy(), "infl_steps": infl_steps,
           "first": first, "counts": counts,
           "moved": moved, "init_s": init_s, "fit_s": fit_s,
           "n_params": sum(int(np.prod(x.shape))
                           for x in tree_leaves(state["params"]))}
    row = [peak, counts.get("router_topk", 0),
           counts.get("flash_attention_tc", 0), sum(counts.values()),
           moved.get("all_reduces", 0), moved.get("all_gathers", 0),
           busy[0] if isinstance(busy, tuple) else -1.0,
           busy[1] if isinstance(busy, tuple) else -1.0,
           out["n_params"], init_peak, init_launches,
           moved.get("reduce_scatters", 0), base]
    out["busy_error"] = None if isinstance(busy, tuple) else busy
    if comm is None:
        out["table"] = [row]
        out["same_influence"] = out["same_whole"] = True
        return out
    rows = comm.all_gather(torch.tensor(row, dtype=torch.float64,
                                        device=DEVICE)).tolist()
    every = comm.all_gather(infl)
    out["table"] = rows
    out["same_influence"] = all(torch.equal(every[0], every[r])
                                for r in range(comm.size))
    out["same_whole"] = True
    if model == 1:
        return out
    # over model ranks, the leaves held whole on every rank (parameters
    # and moments): the same bits everywhere, with no gradient reduced
    # over model
    shardings = tree_leaves(M.rank_shardings(cfg, rules))
    shapes = [x.shape for x in tree_leaves(M.abstract_params(cfg))]
    whole = [i for i, (sh, shape) in enumerate(zip(shardings, shapes))
             if not sh.split_dims(shape)]
    flat = torch.cat([tree_leaves(tree)[i].detach().reshape(-1).float()
                      for tree in (state["params"], state["opt"]["mu"],
                                   state["opt"]["nu"]) for i in whole])
    every = comm.all_gather(flat)
    out["same_whole"] = all(torch.equal(every[0], every[r])
                            for r in range(comm.size))
    out["n_whole"] = (len(whole), int(flat.numel()))
    return out


def trainer_dp_ranks():
    """On each of TRAINER_DP_RANKS ranks: ``trainer_dp_body`` over
    ``data`` and then over ``model``, in one launch (the process starts
    and each process's first use of the card paid once); both results,
    rank 0's with every rank's table."""
    import gc
    import torch
    out = []
    for data, model in ((TRAINER_DP_RANKS, 1), (1, TRAINER_DP_RANKS)):
        out.append(trainer_dp_body(data, model))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _trainer_steady(hist):
    """Each step's wall s and the steady step's: the mean of the steps
    between the first (warm-up) and the last (profiled), or of every
    step but the first when there are two."""
    walls = [m["wall_s"] for m in hist]
    walls = [walls[0]] + [b - a for a, b in zip(walls, walls[1:])]
    rest = walls[1:-1] or walls[1:]
    return walls, sum(rest) / len(rest)


def _log_trainer_run(ctx, cfg, tag, res, n):
    """The per-rank table and the run's line of one trainer_dp run, its
    launch gates and its steady step (into ``ctx["trainer_dp"]``)."""
    from repro_torch.launch import roofline as RL
    card = ctx["card"]
    want = {"flash_attention_tc": n, "router_topk": n}
    walls, s_step = _trainer_steady(res["hist"])
    ctx.setdefault("trainer_dp", {})[tag] = s_step
    for r, row in enumerate(res["table"]):
        (peak, router, flash, total, ars, ags, dev_s, wall, _, init_peak,
         init_launches, rss, _) = row
        path = f"trainer_dp {tag} rank {r}"
        ctx["paths"][path] = {"router_topk": int(router),
                              "flash_attention_tc": int(flash)}
        check(int(router) == n and int(flash) == n and int(total) == 2 * n,
              f"trainer_dp {tag} rank {r}: router {router}, flash {flash}, "
              f"all launches {total}; want {want}")
        check(int(init_launches) == 0, f"trainer_dp {tag} rank {r}: "
              f"{init_launches} kernel launches while making the state")
        if wall > 0:
            busy = (f"device busy {dev_s:.3f} s of a {wall:.3f} s "
                    f"profiled step = {dev_s / wall:.1%} (this rank's "
                    f"kernels)")
        elif r:
            busy = "profiled on rank 0 only"
        else:
            busy = f"device busy not measured ({res['busy_error']})"
        log("trainer_dp", f"{tag} rank {r}: peak {init_peak / 2 ** 30:.2f} "
            f"GiB making its state (no launches), {peak / 2 ** 30:.2f} GiB "
            f"training; router {int(router)} and flash {int(flash)} "
            f"launches = {TRAINER_DP_LAYERS} layers x 2 (forward, "
            f"recompute) x {TRAIN_MICRO} microbatches x {TRAINER_DP_STEPS} "
            f"steps; collectives a step: all-reduces {ars:.0f}, all-gathers "
            f"{ags:.0f}, reduce-scatters {rss:.0f}; {busy}  [{card}]")
    rows = res["table"]
    check(all(row[4:6] + row[11:12] == rows[0][4:6] + rows[0][11:12]
              for row in rows), f"trainer_dp {tag}: the ranks' collectives "
          f"a step differ: {[row[4:6] + row[11:12] for row in rows]}")
    mfu = RL.mfu(cfg, "train", TRAINER_DP_B, TRAIN_S, s_step)
    moved = res["moved"]
    col = ("" if not moved else
           f"; collectives a step (rank 0): all-reduces "
           f"{moved['all_reduces']:.0f} ({moved['bytes'] / 1e6:.1f} MB, "
           f"{moved['seconds']:.3f} s), all-gathers "
           f"{moved['all_gathers']:.0f} ({moved['all_gather_bytes'] / 1e6:.1f}"
           f" MB, {moved['all_gather_seconds']:.3f} s), reduce-scatters "
           f"{moved['reduce_scatters']:.0f} "
           f"({moved['reduce_scatter_bytes'] / 1e6:.1f} MB, "
           f"{moved['reduce_scatter_seconds']:.3f} s)")
    tokens = TRAINER_DP_B * TRAIN_S
    log("trainer_dp", f"{tag}: {cfg.name} at {TRAINER_DP_LAYERS} of 32 "
        f"layers, {res['n_params']:,} parameters a rank, batch "
        f"{TRAINER_DP_B} x {TRAIN_S} in {TRAIN_MICRO} microbatches: "
        f"state made in {res['init_s']:.1f} s; steps "
        f"{', '.join(f'{w:.3f}' for w in walls)} s (steady "
        f"{s_step:.3f} s = {tokens / s_step:.1f} tokens/s, MFU "
        f"{mfu:.6f}); losses "
        f"{', '.join(f'{m['loss']:.6f}' for m in res['hist'])}, "
        f"grad_norm "
        f"{', '.join(f'{m['grad_norm']:.6f}' for m in res['hist'])}"
        f"{col}  [{card}]")


def _gate_against_one(tag, res, one, launch_s, one_s):
    """``res`` (a run over ranks) against the data=1 run ``one``: losses
    and grad_norm within TRAINER_DP_TOL, the influence within its limit
    (over data ranks after the last step; over model ranks in the first
    microbatch's update, TRAINER_DP_TOL's comment), the influence (and,
    over model ranks, every leaf held whole) bit-equal across ranks."""
    import numpy as np
    tol = TRAINER_DP_TOL
    rel = {key: max(abs(a[key] - b[key]) / abs(b[key]) for a, b in
                    zip(res["hist"], one["hist"]))
           for key in ("loss", "grad_norm")}
    steps = [float(np.max(np.abs(a - b) / b)) for a, b in
             zip(res["infl_steps"], one["infl_steps"])]
    moved_infl = float(np.max(np.abs(np.log(one["influence"]))))
    if res["first"] is None:
        rel["influence"] = steps[-1]
        which = "after the last step"
    else:
        (fi, fl), (oi, ol) = res["first"], one["first"]
        rel["influence"] = float(np.max(np.abs(fi - oi) / oi))
        which = "in the first microbatch's update"
        tgt = float(np.sum(ol[0, 0])) / ol.shape[-1]    # top_k x T / E
        rows = np.abs(fl - ol).reshape(-1, fl.shape[-1])
        log("trainer_dp", f"{tag} against data=1, the first microbatch's "
            f"forward from the state as made: each layer's largest |load "
            f"difference| {', '.join(f'{int(x)}' for x in rows.max(axis=1))}"
            f" of a {tgt:.0f}-token target, tokens moved "
            f"{', '.join(f'{int(x) // 2}' for x in rows.sum(axis=1))}")
    whole = ("" if "n_whole" not in res else
             f"; the {res['n_whole'][0]} leaves held whole (with their "
             f"moments, {res['n_whole'][1]:,} values) bit-equal across "
             f"ranks {res['same_whole']}")
    log("trainer_dp", f"{tag} against data=1: largest relative difference "
        f"of the losses {rel['loss']:.3g} (limit {tol['loss']}), grad_norm "
        f"{rel['grad_norm']:.3g} (limit {tol['grad_norm']}), influence "
        f"{which} {rel['influence']:.3g} (limit {tol['influence']}; after "
        f"each step {', '.join(f'{x:.3g}' for x in steps)}; |log "
        f"influence| max {moved_infl:.4f} at data=1); influence bit-equal "
        f"across ranks {res['same_influence']}{whole}; one launch of "
        f"{TRAINER_DP_RANKS} ranks for data={TRAINER_DP_RANKS} and "
        f"model={TRAINER_DP_RANKS} {launch_s:.1f} s with the process "
        f"starts, data=1 {one_s:.1f} s")
    check(res["same_influence"], f"trainer_dp {tag}: the ranks' "
          f"influences differ")
    check(res["same_whole"], f"trainer_dp {tag}: the ranks' leaves held "
          f"whole differ")
    check(moved_infl > 0, "trainer_dp: the influence did not move")
    for key, lim in tol.items():
        check(rel[key] <= lim, f"trainer_dp {tag}: {key} differs from "
              f"data=1 by {rel[key]:.3g} (limit {lim})")


def phase_trainer_dp(torch, ctx):
    """Training over ranks: granite at full width and cut depth,
    ``data=TRAINER_DP_RANKS`` and then ``model=TRAINER_DP_RANKS`` (gloo
    ranks sharing the card, both runs in one launch, ``trainer_dp_ranks``)
    against ``data=1`` in this process, the same seed and batches.
    Gates: losses and grad_norm within TRAINER_DP_TOL of data=1, the
    influence within its tolerance of data=1 (``_gate_against_one``) and
    bit-equal across ranks, at model=2 every leaf held whole bit-equal
    across ranks, each rank's flash (6a) and router
    (5) launches = layers x 2 (forward, recompute) x microbatches x
    steps and nothing else, none while the state is made, the same
    collectives a step on every rank. Prints the steady step's seconds
    at each, tokens/s, each rank's peaks, the collectives a step, device
    busy and MFU."""
    import gc
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.dist import launch
    import dataclasses
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(granite.CONFIG, n_layers=TRAINER_DP_LAYERS)
    n = TRAINER_DP_LAYERS * 2 * TRAIN_MICRO * TRAINER_DP_STEPS
    t0 = time.perf_counter()
    one = trainer_dp_body(1)
    one_s = time.perf_counter() - t0
    _log_trainer_run(ctx, cfg, "data=1", one, n)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runs = launch.launch(trainer_dp_ranks, TRAINER_DP_RANKS, device="cuda",
                         timeout=900)
    launch_s = time.perf_counter() - t0
    for (data, model), res in zip(((TRAINER_DP_RANKS, 1),
                                   (1, TRAINER_DP_RANKS)), runs):
        tag = f"data={data}" if data > 1 else f"model={model}"
        _log_trainer_run(ctx, cfg, tag, res, n)
        _gate_against_one(tag, res, one, launch_s, one_s)
        keep_rank_peaks(
            ctx, f"trainer_dp {tag}", "granite_moe_3b_a800m",
            TRAINER_DP_CELL, (data, model),
            [row[0] - row[12] for row in res["table"]],
            [res["moved"]] + [None] * (len(res["table"]) - 1),
            hp=trainer_dp_hp(),
            cfg_overrides={"n_layers": TRAINER_DP_LAYERS})
    steady = ctx["trainer_dp"]
    log("trainer_dp", "steady s a step: " + ", ".join(
        f"{tag} {s:.3f} ({s / steady['data=1']:.2f}x data=1)"
        for tag, s in steady.items()))
    phase_s = time.perf_counter() - t_phase
    ctx["trainer_dp_s"] = phase_s
    log("trainer_dp", f"phase {phase_s:.1f} s")


# ---------------------------------------------------------------------------
# serving over the model axis: two ranks sharing the card
# ---------------------------------------------------------------------------

# granite CONFIG at full depth through ServeEngine (batch SERVE_BATCH,
# SERVE_REQUESTS x SERVE_PROMPT-token prompts, SERVE_TP_NEW new tokens:
# half the serve phase's 16, for time), then
# granite, gemma3, jamba (the archs phase's cut: pattern positions 0-4,
# bf16 weights) and rwkv6 (32 layers, float32 weights) CONFIG prefilled
# at B=1, S=PREFILL_S and SERVE_TP_DECODE decode steps after it, then
# SERVE_TP_BUSY more under the profiler on rank 0 (but granite's, whose
# engine steps are profiled), at model=SERVE_TP_RANKS (gloo rank
# processes sharing the card, each making only its shards, one after
# another) against model=1 in this process
SERVE_TP_RANKS = 2
SERVE_TP_NEW, SERVE_TP_DECODE, SERVE_TP_BUSY = 8, 4, 2
SERVE_TP_ARCHS = ("granite_moe_3b_a800m", "gemma3_1b",
                  "jamba_1p5_large_398b", "rwkv6_3b")
# bf16 logits at model=2 against model=1: the largest |difference| of a
# row over the row's largest |logit| (kernels.ref.row_relative_error).
# The partial sums of wo, w_down and the experts round to bf16 on each
# rank before the all-reduce, once a layer, so the residual stream moves
# by an ulp or two a layer. Read on the H100 (PERF.md): 0.0036-0.0078 for
# granite and gemma3, 0.0034-0.0074 for jamba and rwkv6, whose SSM states
# after the prefill (Mamba's h, RWKV's s; gated by the same limit over
# their largest value) read 0.0056-0.0137; the limit 2e-2 leaves 1.5x
# headroom or more (LM_BF16_TOL's
# 5e-2 would exempt most greedy rows below). A greedy token is held
# equal unless model=1's top-2 gap of its row is under the same share of
# the row's largest |logit|: that row is exempt from there on.
SERVE_TP_TOL = 2e-2
# the seconds of the phases cut to make room for serve_tp, before the cuts
# (this script's last full run without serve_tp, on an NVIDIA H100 80GB
# HBM3 at 700 W; PERF.md §5 lists the cuts)
SERVE_TP_CUT_BEFORE_S = {"hierarchical": 46.8, "refine": 38.1,
                         "experiments": 69.8, "serve": 11.8,
                         "prefill": 26.3, "archs": 101.5,
                         "trainer": 105.8}


def _tp_decode_tokens(cfg):
    import numpy as np
    return np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, SERVE_TP_DECODE)).astype(np.int32)


def serve_tp_config(arch):
    """``arch``'s CONFIG as serve_tp serves it: the archs phase's cut
    (ARCH_CELLS: jamba at pattern positions 0-4), whole elsewhere."""
    from repro_torch import configs
    depth = dict((a, d) for a, d, _ in ARCH_CELLS).get(arch)
    return cut_config(configs.get_config(arch), depth)[0]


def tp_states(cache, cfg, rules):
    """The SSM states of a prefill's cache on the host, each whole: Mamba's
    ``h`` gathered over its ``mlp`` channels and RWKV's ``s`` over its
    heads from the model ranks (ROADMAP.md queue 3 item 27), by pattern
    position."""
    from repro_torch.dist.rules import gather_split
    di, heads = cfg.mamba_expand * cfg.d_model, \
        cfg.d_model // cfg.rwkv_head_dim
    out = {}
    for pos, c in cache.items():
        if "h" in c:
            x = gather_split(c["h"], rules, "mlp", di, 2)
        elif "s" in c:
            x = gather_split(c["s"], rules, "heads_joined", heads, 2)
        else:
            continue
        # a copy: the decode steps after the prefill update the cache in
        # place
        out[f"{pos} {'h' if 'h' in c else 's'}"] = \
            x.float().cpu().numpy().copy()
    return out


def serve_tp_arch(torch, arch, mesh, routed, state):
    """One config of ``serve_tp_body`` on this rank: its parameters (the
    rank's shards made from seed 0 by ``init_params(rules=)``, the ranks
    one after another), the engine (granite), the prefill twice (the
    second timed warm), its SSM states whole, the decode steps after it
    and (but granite) SERVE_TP_BUSY more profiled on rank 0; each path's
    launch counts from 0, its wall, peak and collectives, its logits on
    the host."""
    import gc
    import numpy as np
    from repro_torch.dist.rules import resolve_rules
    from repro_torch.kernels.ops import launch_counts, reset_launch_counts
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.serve import Request, ServeEngine
    cfg = serve_tp_config(arch)
    comm = mesh.comm
    drules = resolve_rules(mesh, cfg, "decode", batch_size=SERVE_BATCH)
    prules = resolve_rules(mesh, cfg, "prefill", batch_size=1)
    out = {"paths": {}}
    # each rank draws every leaf whole and keeps its shard: the ranks take
    # turns, so that two whole leaves (jamba's expert stacks: 12.9 GB in
    # float32) are never drawn at once beside two ranks' shards
    for turn in range(1 if comm is None else comm.size):
        if comm is None or comm.rank == turn:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            params = M.init_params(cfg, gen, device=DEVICE, rules=drules)
            torch.cuda.synchronize()
            out["paths"]["init"] = {
                "wall": time.perf_counter() - t0, "steps": 1, "moved": {},
                "counts": {n: c for n, c in launch_counts().items() if c},
                "peak": torch.cuda.max_memory_allocated(),
                "after": torch.cuda.memory_allocated()}
            gc.collect()
            torch.cuda.empty_cache()
        if comm is not None:
            comm.all_reduce(torch.zeros(1))
    out["params_gib"] = sum(x.numel() * x.element_size() for x in
                            tree_leaves(params)) / 2 ** 30

    def run(path, fn, steps=1, args=None):
        """``fn`` as ``path``: its launches, wall, peak and collectives,
        and the base of its peak (what the process held before it but
        ``args``, the arguments it reads)."""
        routed.clear()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated() - sum(
            x.numel() * x.element_size() for x in tree_leaves(args or {}))
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        before = comm.counters() if comm is not None else None
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        moved = ({k: (v - before[k]) / steps
                  for k, v in comm.counters().items()}
                 if comm is not None else {})
        state["routed"].extend(x.reshape(-1) for x in routed)
        out["paths"][path] = {
            "wall": wall, "counts": {n: c for n, c in launch_counts().items()
                                     if c},
            "peak": torch.cuda.max_memory_allocated(), "moved": moved,
            "steps": steps, "base": base}
        return value

    with torch.no_grad():
        if arch == "granite_moe_3b_a800m":
            engine = ServeEngine(cfg, drules, params, batch=SERVE_BATCH,
                                 max_seq=SERVE_MAX_SEQ)
            inner, seen = engine.step_fn, []

            def recorded(*args):
                res = inner(*args)
                seen.append(res[2].float().cpu().numpy())
                return res

            engine.step_fn = recorded
            rng = np.random.default_rng(0)
            reqs = [Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, (SERVE_PROMPT,)).astype(np.int32),
                max_new=SERVE_TP_NEW) for i in range(SERVE_REQUESTS)]
            run("engine", lambda: engine.run(reqs), args=params)
            n_steps = len(seen)
            out["paths"]["engine"]["steps"] = n_steps
            out["paths"]["engine"]["moved"] = {
                k: v / n_steps for k, v in
                out["paths"]["engine"]["moved"].items()}
            out["engine"] = {"transcripts": [list(r.out) for r in reqs],
                             "logits": seen}
            out["busy"] = tp_profile(torch, engine, inner, comm)
        toks = torch.tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (1, PREFILL_S)), dtype=torch.int32,
            device=DEVICE)
        logits, cache = run("prefill", lambda: M.prefill(
            params, {"tokens": toks}, cfg, prules), args={"params": params, "tokens": toks})
        out["prefill_logits"] = logits.float().cpu().numpy()
        out["states"] = tp_states(cache, cfg, drules)
        busy = 0 if "busy" in out else SERVE_TP_BUSY
        cache = M.extend_cache(cache, cfg, PREFILL_S + SERVE_TP_DECODE +
                               busy)
        dec_toks = torch.tensor(_tp_decode_tokens(cfg), device=DEVICE)

        def decode(first=0, steps=SERVE_TP_DECODE):
            lg = []
            for t in range(first, first + steps):
                lg.append(M.decode_step(params, cache, {
                    "tokens": dec_toks[:, t % SERVE_TP_DECODE:][:, :1]},
                    PREFILL_S + t, cfg, drules)[0].float().cpu().numpy())
            return lg

        out["decode_logits"] = run("decode", decode, SERVE_TP_DECODE)
        if busy:
            out["busy"] = tp_busy(torch, lambda: decode(SERVE_TP_DECODE,
                                                        busy), comm, busy)
        del cache, logits
        gc.collect()
        torch.cuda.empty_cache()
        run("prefill-warm", lambda: M.prefill(params, {"tokens": toks},
                                              cfg, prules))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_busy(torch, fn, comm, steps):
    """Device busy of ``fn`` (``steps`` decode steps) on rank 0 (or in this
    process) under torch.profiler: (device s, wall s) a step of its own
    kernels and copies; the other ranks run it unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    if comm is not None and comm.rank:
        fn()
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return device_rows(prof)[1] / steps, wall / steps


def tp_profile(torch, engine, step_fn, comm, steps=4):
    """``tp_busy`` of ``steps`` engine steps at batch SERVE_BATCH, after
    one warm step."""
    cache = engine._fresh_cache()
    tok = torch.zeros(engine.B, 1, dtype=torch.int32, device=DEVICE)
    step_fn(engine.params, cache, tok, 0)

    def steps_from_1():
        t, c = tok, cache
        for p in range(1, steps + 1):
            t, c, _ = step_fn(engine.params, c, t, p)

    return tp_busy(torch, steps_from_1, comm, steps)


def serve_tp_body(model):
    """On each of ``model`` ranks of a ``make_host_mesh(1, model)`` mesh
    (or in this process at model=1): ``serve_tp_arch`` of every config of
    SERVE_TP_ARCHS, recording the experts of every router call. Returns
    rank 0's results, with every rank's launch counts, peaks and walls
    (``table``) and whether every rank routed the same experts, bit for
    bit, in every call (``same_routing``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(1, model, device=DEVICE)
    comm = mesh.comm
    routed, state = [], {"routed": []}
    inner = ops.router_topk_divide

    def recording(x, c, infl, k):
        idx, eff = inner(x, c, infl, k)
        routed.append(idx)
        return idx, eff

    ops.router_topk_divide = recording
    try:
        res = {arch: serve_tp_arch(torch, arch, mesh, routed, state)
               for arch in SERVE_TP_ARCHS}
    finally:
        ops.router_topk_divide = inner
    table = [[arch, path, rec["counts"], rec["peak"], rec["wall"],
              rec["steps"], rec.get("after"), rec.get("base"),
              rec["moved"]]
             for arch, r in res.items() for path, rec in r["paths"].items()]
    out = {"res": res}
    if comm is None:
        out["table"], out["same_routing"] = [table], None
        return out
    import pickle
    blob = torch.frombuffer(bytearray(pickle.dumps(table)),
                            dtype=torch.uint8)
    sizes = comm.all_gather(torch.tensor([blob.numel()]))
    pad = torch.zeros(int(sizes.max()), dtype=torch.uint8)
    pad[:blob.numel()] = blob
    blobs = comm.all_gather(pad)
    out["table"] = [pickle.loads(bytes(blobs[r, :int(sizes[r])].tolist()))
                    for r in range(comm.size)]
    mine = torch.cat(state["routed"]).to(torch.int32)
    every = comm.all_gather(mine)
    out["same_routing"] = all(torch.equal(every[0], every[r])
                              for r in range(comm.size))
    out["routed_calls"] = len(state["routed"])
    return out


def phase_serve_tp(torch, ctx):
    """Serving over the ``model`` axis: granite, gemma3, jamba (pattern
    positions 0-4) and rwkv6 CONFIG at ``model=SERVE_TP_RANKS`` (gloo rank
    processes sharing the card, one ``dist.launch``, each rank making only
    its shards) against ``model=1`` in this process, first, the same seed,
    prompts and tokens. Gates: prefill, decode and the engine's
    prompt-step logits within SERVE_TP_TOL of model=1 (row-relative);
    jamba's Mamba ``h`` and
    rwkv6's RWKV ``s`` after the prefill, the ranks' concatenated, within
    the same share of model=1's largest value; greedy tokens equal up to
    a near-tie of model=1; the experts of every router call bit-equal
    across the ranks; each rank's launches: none while it makes its
    shards, the router once a MoE layer a step, flash once a
    full-attention layer a prefill, nothing else. Prints the engine's ms
    a step and tokens/s, the prefill's s, a decode step's ms, each rank's
    peak (while making its shards, after it, in each path) against
    model=1's, the collectives a step and rank 0's device busy."""
    import gc
    import numpy as np
    from repro_torch import configs
    from repro_torch.dist import launch
    from repro_torch.kernels.ref import row_relative_error
    card = ctx["card"]
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = serve_tp_body(1)
    one_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = launch.launch(serve_tp_body, SERVE_TP_RANKS,
                        args=(SERVE_TP_RANKS,), device="cuda", timeout=600)
    two_s = time.perf_counter() - t0
    tol = SERVE_TP_TOL

    def rel(got, want):
        return row_relative_error(torch.from_numpy(np.asarray(got)),
                                  torch.from_numpy(np.asarray(want)))

    def near_tie(lg, vocab):
        row = np.sort(np.asarray(lg, np.float32).reshape(-1)[:vocab])
        return row[-1] - row[-2] < tol * np.abs(row).max()

    for tag, out in (("model=1", one), (f"model={SERVE_TP_RANKS}", two)):
        for r, table in enumerate(out["table"]):
            for arch, path, counts, peak, wall, steps, after, _, _ in table:
                cfg = serve_tp_config(arch)
                moe = arch_layers(cfg, "mlp", "moe")
                full = arch_layers(cfg, "attn", "full")
                prefill = {"router_topk": moe, "flash_attention_tc": full}
                want = {"init": {}, "engine": {"router_topk": moe * steps},
                        "prefill": prefill, "prefill-warm": prefill,
                        "decode": {"router_topk": moe * steps}}[path]
                want = {k: v for k, v in want.items() if v}
                ctx["paths"][f"serve_tp {cfg.name} {tag} rank {r} {path}"] \
                    = counts
                check(counts == want, f"serve_tp {cfg.name} {tag} rank {r} "
                      f"{path}: launches {counts}, want {want}")
                held = "" if after is None else \
                    f", {after / 2 ** 30:.2f} GiB held after it"
                log("serve_tp", f"{cfg.name} {tag} rank {r} {path}: "
                    f"launches {counts} ({steps} step(s)), peak "
                    f"{peak / 2 ** 30:.2f} GiB{held}, wall {wall:.3f} s  "
                    f"[{card}]")
    for arch in SERVE_TP_ARCHS:
        cut = dict((a, d) for a, d, _ in ARCH_CELLS).get(arch)
        for path, cell in (("engine", SERVE_CELL), ("prefill", PREFILL_CELL)):
            rows = [row for table in two["table"] for row in table
                    if row[:2] == [arch, path]]
            if rows:
                keep_rank_peaks(
                    ctx, f"serve_tp {arch} {path}", arch, cell,
                    (1, SERVE_TP_RANKS), [row[3] - row[7] for row in rows],
                    [row[8] for row in rows], cfg_overrides=cut_config(
                        configs.get_config(arch), cut)[1])
    if two["same_routing"] is not None:
        log("serve_tp", f"model={SERVE_TP_RANKS}: the experts of "
            f"{two['routed_calls']} router calls bit-equal on every rank: "
            f"{two['same_routing']}")
        check(two["same_routing"], "serve_tp: the ranks routed tokens to "
              "different experts")
    for arch in SERVE_TP_ARCHS:
        cfg = serve_tp_config(arch)
        a, b = one["res"][arch], two["res"][arch]
        errs = {"prefill": rel(b["prefill_logits"], a["prefill_logits"]),
                "decode": max(rel(g, w) for g, w in
                              zip(b["decode_logits"], a["decode_logits"]))}
        if "engine" in a:
            errs["engine prompt steps"] = max(
                rel(g, w) for g, w in zip(b["engine"]["logits"][:SERVE_PROMPT],
                                          a["engine"]["logits"][:SERVE_PROMPT]))
        for key, err in errs.items():
            check(err <= tol, f"serve_tp {cfg.name}: {key} logits differ "
                  f"from model=1 by {err:.4g} of a row (limit {tol})")
        # the SSM states after the prefill, the model ranks' concatenated:
        # the largest |difference| over the largest |value| of a layer's
        for key, want in a["states"].items():
            got = b["states"][key]
            check(got.shape == want.shape, f"serve_tp {cfg.name}: state "
                  f"{key} of shape {got.shape}, model=1's {want.shape}")
            err = float(np.abs(got - want).max() / np.abs(want).max())
            errs[f"state {key}"] = err
            check(err <= tol, f"serve_tp {cfg.name}: the state {key} after "
                  f"the prefill differs from model=1's by {err:.4g} of its "
                  f"largest value (limit {tol})")
        exempt = []
        for g, w in zip(b["decode_logits"], a["decode_logits"]):
            tie = near_tie(w, cfg.vocab_size)
            same = int(np.argmax(np.asarray(g).reshape(-1)[:cfg.vocab_size])
                       ) == int(np.argmax(np.asarray(w).reshape(-1)
                                          [:cfg.vocab_size]))
            check(same or tie, f"serve_tp {cfg.name}: a decode step's "
                  f"greedy token differs from model=1 without a near-tie")
            exempt.append(tie)
        if "engine" in a:
            got, want = b["engine"]["transcripts"], a["engine"]["transcripts"]
            for i, (g, w) in enumerate(zip(got, want)):
                upto = len(w)
                for j in range(len(w)):
                    if near_tie(a["engine"]["logits"][SERVE_PROMPT - 1 + j][i],
                                cfg.vocab_size):
                        upto = j
                        break
                check(g[:upto] == w[:upto], f"serve_tp {cfg.name}: request "
                      f"{i} transcript {g} against model=1's {w} (held up "
                      f"to token {upto})")
                exempt.append(upto < len(w))
            log("serve_tp", f"{cfg.name} transcripts at model=1 {want}, at "
                f"model={SERVE_TP_RANKS} {got}")
        log("serve_tp", f"{cfg.name}: model={SERVE_TP_RANKS} against "
            f"model=1, largest relative difference (logits of a row, "
            f"states of their largest value) "
            + ", ".join(f"{k} {v:.4g}" for k, v in errs.items())
            + f" (limit {tol}); rows exempt at a near-tie {sum(exempt)} of "
            f"{len(exempt)}")
        for tag, res in (("model=1", a), (f"model={SERVE_TP_RANKS}", b)):
            p = res["paths"]
            line = (f"{cfg.name} {tag}: parameters {res['params_gib']:.2f} "
                    f"GiB a rank ({cfg.param_dtype}), made in "
                    f"{p['init']['wall']:.1f} s at a peak of "
                    f"{p['init']['peak'] / 2 ** 30:.2f} GiB (rank 0); "
                    f"prefill B=1 S={PREFILL_S} {p['prefill']['wall']:.3f} s"
                    f" (warm repeat {p['prefill-warm']['wall']:.3f} s), "
                    f"peak {p['prefill']['peak'] / 2 ** 30:.2f} GiB; "
                    f"{SERVE_TP_DECODE} decode steps after it "
                    f"{p['decode']['wall'] / SERVE_TP_DECODE * 1e3:.2f} ms "
                    f"a step")
            if "engine" in p:
                e = p["engine"]
                n_tok = SERVE_REQUESTS * SERVE_TP_NEW
                line += (f"; engine {n_tok} tokens in {e['wall']:.3f} s = "
                         f"{n_tok / e['wall']:.2f} tokens/s, {e['steps']} "
                         f"steps at {e['wall'] / e['steps'] * 1e3:.2f} ms a "
                         f"step, peak {e['peak'] / 2 ** 30:.2f} GiB")
            busy = res.get("busy")
            if busy:
                line += (f"; device busy {busy[0] * 1e3:.2f} ms of a "
                         f"{busy[1] * 1e3:.2f} ms profiled "
                         f"{'engine' if 'engine' in p else 'decode'} step "
                         f"= {busy[0] / busy[1]:.1%} (rank 0's kernels)")
            for path in ("engine", "prefill", "decode"):
                mv = p.get(path, {}).get("moved")
                if mv:
                    line += (f"; collectives a step of {path} (rank 0): "
                             f"all-reduces {mv['all_reduces']:.1f} "
                             f"({mv['bytes'] / 1e6:.3f} MB, "
                             f"{mv['seconds'] * 1e3:.2f} ms), all-gathers "
                             f"{mv['all_gathers']:.1f} "
                             f"({mv['all_gather_bytes'] / 1e6:.3f} MB, "
                             f"{mv['all_gather_seconds'] * 1e3:.2f} ms)")
            log("serve_tp", line + f"  [{card}]")
    log("serve_tp", f"model=1 in this process {one_s:.1f} s; the launch of "
        f"{SERVE_TP_RANKS} ranks {two_s:.1f} s with the process starts")
    phase_s = time.perf_counter() - t_phase
    ctx["serve_tp_s"] = phase_s
    log("serve_tp", f"phase {phase_s:.1f} s")


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
    """Least time for one sweep (ms, "operations" | "bytes"):
    ``launch.kernel_roofline``'s ``cuda`` model on the ``h100`` row (2d+7
    float32 operations a pair computed, 2(d+2) a point for the moments;
    each input read once, each output written once: points, centers and
    inv2, idx/best/second, with the layout its order, fused the weights
    and the per-block partials). ``pairs``: the pairs this run computed
    (the kernel's count); None for all n*k, the dense bound."""
    from repro_torch.launch.kernel_roofline import kernel_roofline_record
    rec = kernel_roofline_record(
        n, d, k, platform="h100", backend="cuda", fused=fused,
        blocks=blocks, layout=layout,
        prune_frac=0.0 if pairs is None else 1.0 - pairs / (n * k))
    return (rec["bound_s"] * 1e3,
            "operations" if rec["bottleneck"] == "compute" else "bytes")


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
                           library_ms=None, pairs=computed, blocks=blocks)
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
    from repro_torch.kernels.scan import (add_chain, prefix_sum,
                                          prefix_sum_plain)
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
    # the bound: n dependent float64 additions, one after another (numpy's
    # rounding admits no other order), at the latency the card takes for
    # one; add_chain times that chain alone on one thread
    chain = add_chain(0.1, MAIN_N, DEVICE)
    check(float(chain) == float(np.cumsum(np.full(MAIN_N, 0.1))[-1]),
          "add_chain: not n additions in order")
    chain_ms = time_ms(torch, lambda: add_chain(0.1, MAIN_N, DEVICE),
                       iters=5)
    bytes_ms, _ = larger_bound(0.0, 16 * MAIN_N)
    rec["bound_ms"], rec["bound_by"] = chain_ms, "operations"
    log("timing", f"prefix_sum n={MAIN_N} float64: kernel {rec['ms']:.4f} "
        f"ms, plain (torch.cumsum) {rec['plain_ms']:.4f} ms, library "
        f"{rec['library_ms']:.4f} ms, max |err| against np.cumsum "
        f"{rec['max_abs_err']:.3g}; bound {chain_ms:.4f} ms (latency: "
        f"{MAIN_N} dependent float64 adds at {chain_ms / MAIN_N * 1e6:.3f} "
        f"ns each, timed alone), {chain_ms / rec['ms']:.1%} of the kernel's "
        f"time ({'at or above' if chain_ms >= rec['ms'] / 2 else 'below'} "
        f"half); the bytes alone {bytes_ms:.4f} ms; launches "
        f"{rec.get('launches')} on the {rec.get('path')} path  "
        f"[{ctx['card']}]")
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


def router_launcher(torch, x, c, scale, K, multiply=False):
    """One launch of the router kernel through its C entry, with the
    outputs, scratch and ticket made once: the kernel's own time under
    CUDA events. (The wrappers check, allocate and look up the stream on
    every call; on the card's host that takes longer than the kernel.)"""
    from repro_torch.kernels import moe_router_kernel as mr
    from repro_torch.kernels.build import load_library
    T, D = x.shape
    E = c.shape[0]
    mode = mr.MULTIPLY if multiply else (mr.UNIT if scale is None
                                         else mr.DIVIDE)
    idx = torch.empty(T, K, dtype=torch.int32, device=DEVICE)
    eff = torch.empty(T, K, dtype=torch.float32, device=DEVICE)
    scratch = torch.empty(T * E, dtype=torch.float32, device=DEVICE)
    stream = torch.cuda.current_stream()
    lib = load_library("router")
    args = (x.data_ptr(), c.data_ptr(),
            None if scale is None else scale.data_ptr(), mode,
            int(x.dtype == torch.bfloat16), T, E, D, K, idx.data_ptr(),
            eff.data_ptr(), scratch.data_ptr(),
            mr._ticket(stream).data_ptr(), stream.cuda_stream)

    def launch():
        lib.call("repro_router_topk", *args)
        return idx, eff
    return launch


def router_name(key: str) -> str:
    """The router kernel's name in a profiler key."""
    return re.sub(r".*::(router_\w+).*", r"\1", key)


def router_device_ms(torch, fn, calls: int = 50):
    """Device milliseconds a call of ``fn`` by torch.profiler: the sum of
    the router kernels' times over ``calls`` calls, and each kernel's (the
    tiled form's two overlap: the second starts while the first runs)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows, _ = device_rows(prof)
    mine = [r for r in rows if "router_" in r[2]]
    each = ", ".join(f"{router_name(r[2])} {r[0] / calls / 1e3:.4f} ms"
                     for r in sorted(mine, key=lambda r: r[2]))
    return sum(r[0] for r in mine) / calls / 1e3, each


def time_lm(torch, ctx):
    """The language-model kernels at the path's shapes: the router at
    granite's decode (T = 4) and prefill (T = 4096, bf16 tokens) in the
    path's unit form, beside the divide and multiply forms and the plain
    version; both flash kernels at one granite layer of a 4096-token
    prefill. Each row's error comes from the instance and inputs it
    times."""
    import numpy as np
    from repro_torch.configs import granite_moe_3b_a800m as granite
    from repro_torch.kernels import moe_router_kernel as mr
    cfg = granite.CONFIG
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    rec = ctx["kernels"].setdefault("router_topk", {})
    for T in (SERVE_BATCH, PREFILL_S):
        x, c, _ = router_inputs(torch, T, E, D, T, torch.bfloat16, True)
        infl = torch.tensor(np.random.default_rng(T).uniform(0.8, 1.25, E),
                            dtype=torch.float32, device=DEVICE)
        inv2 = 1.0 / (infl * infl)
        (_, peff), _ = router_call(torch, "unit", x, c, None, K, plain=True)
        _, eff = router_call(torch, "unit", x, c, None, K)
        err = float(torch.max(torch.abs(eff - peff)))
        # the kernel in each mode, launched through its C entry with its
        # buffers made once (router_launcher), in turns: unit, divide,
        # multiply, then the reverse; and through the wrappers, whose
        # Python checks and allocations the host pays on every call
        runs = {"unit": router_launcher(torch, x, c, None, K),
                "divide": router_launcher(torch, x, c, infl, K),
                "multiply": router_launcher(torch, x, c, inv2, K,
                                            multiply=True)}
        times = {mode: [] for mode in runs}
        for mode in ROUTER_MODES + ROUTER_MODES[::-1]:
            times[mode].append(time_ms(torch, runs[mode], iters=500))
        ms = {m: sum(v) / len(v) for m, v in times.items()}
        wrapped = time_ms(torch, lambda: mr.router_topk_divide_cuda(
            x, c, None, K), iters=100)
        dev_ms, kernels = router_device_ms(torch, runs["unit"])
        plain = time_ms(torch, lambda: router_call(
            torch, "unit", x, c, None, K, plain=True), iters=20)
        # 2 D + 3 float32 operations a (token, expert) pair; bytes: x in
        # bf16, centroids and the scale in f32 read once, idx + eff written
        bnd, by = larger_bound(T * E * (2 * D + 3) / PEAK_F32_FLOPS,
                               2 * T * D + 4 * E * (D + 1) + 8 * T * K)
        log("timing", f"router_topk T={T} E={E} D={D} K={K} bf16 "
            f"({'decode' if T <= 32 else 'tiled'} form): unit (the path) "
            f"{ms['unit']:.4f} ms (runs "
            f"{', '.join(f'{t:.4f}' for t in times['unit'])}), divide "
            f"{ms['divide']:.4f} ms, multiply {ms['multiply']:.4f} ms; "
            f"device time a call {dev_ms:.4f} ms by the profiler "
            f"({kernels}); through the wrapper {wrapped:.4f} ms; plain "
            f"{plain:.4f} ms, max |err| {err:.3g}, bound {bnd:.4f} ms ({by})"
            f" = {bnd / ms['unit']:.1%} of the kernel's time  "
            f"[{ctx['card']}]")
        if T == PREFILL_S:
            rec.update(ms=ms["unit"], plain_ms=plain, max_abs_err=err,
                       bound_ms=bnd, bound_by=by, library_ms=None)
    # the decode form's floor: one token at granite's widths (a launch,
    # one round trip to memory, the ticket and the merge)
    x, c, _ = router_inputs(torch, 1, E, D, 0, torch.bfloat16, True)
    fn = router_launcher(torch, x, c, None, K)
    floor = time_ms(torch, fn, iters=500)
    log("timing", f"router_topk floor: the decode form at T=1 E={E} D={D} "
        f"{floor:.4f} ms, device {router_device_ms(torch, fn)[0]:.4f} ms  "
        f"[{ctx['card']}]")
    log("timing", "router_topk: no single PyTorch call computes the top-k "
        "smallest effective distances (a cdist + topk is two calls and "
        "orders ties otherwise): library_ms is null")
    time_router_jamba(torch, ctx)
    time_flash(torch, ctx, cfg)


def time_router_jamba(torch, ctx):
    """The router in the path's unit form at jamba's MoE layer (E = 16,
    top-2, D = 8192, bf16 tokens) at its decode (T = 4) and prefill
    (T = 4096) token counts, against the plain version on the same inputs;
    kept under the kernel record's ``by_shape``."""
    from repro_torch.configs import jamba_1p5_large_398b as jamba
    m, D = jamba.CONFIG.moe, jamba.CONFIG.d_model
    E, K = m.n_experts, m.top_k
    rec = ctx["kernels"].setdefault("router_topk", {})
    for T in (SERVE_BATCH, PREFILL_S):
        x, c, _ = router_inputs(torch, T, E, D, T, torch.bfloat16, True)
        (_, peff), _ = router_call(torch, "unit", x, c, None, K, plain=True)
        _, eff = router_call(torch, "unit", x, c, None, K)
        err = float(torch.max(torch.abs(eff - peff)))
        fn = router_launcher(torch, x, c, None, K)
        runs = [time_ms(torch, fn, iters=500) for _ in range(2)]
        ms = sum(runs) / 2
        plain = time_ms(torch, lambda: router_call(
            torch, "unit", x, c, None, K, plain=True), iters=20)
        bnd, by = larger_bound(T * E * (2 * D + 3) / PEAK_F32_FLOPS,
                               2 * T * D + 4 * E * (D + 1) + 8 * T * K)
        rec.setdefault("by_shape", []).append(
            {"arch": "jamba_1p5_large_398b", "shape": [T, E, D, K],
             "ms": ms, "plain_ms": plain, "max_abs_err": err,
             "bound_ms": bnd, "bound_by": by, "library_ms": None})
        log("timing", f"router_topk at jamba's MoE layer T={T} E={E} D={D} "
            f"K={K} bf16 ({'decode' if T <= 32 else 'tiled'} form): kernel "
            f"{ms:.4f} ms (runs {', '.join(f'{t:.4f}' for t in runs)}), "
            f"plain {plain:.4f} ms, max |err| {err:.3g}, bound {bnd:.4f} ms "
            f"({by}) = {bnd / ms:.1%} of the kernel's time  "
            f"[{ctx['card']}]")


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
    time_flash_shapes(torch, ctx)


# both flash kernels at the other archs' prefill shapes (B, S, H, KV, dh):
# phi3 (dh 96), gemma3's global layers (dh 256, MQA) and jamba's attention
# layer (64:8 heads, dh 128)
FLASH_ARCH_SHAPES = {"phi3_mini_3p8b": PHI3_FLASH,
                     "gemma3_1b": (1, PREFILL_S, 4, 1, 256),
                     "jamba_1p5_large_398b": (1, PREFILL_S, 64, 8, 128)}


def time_flash_shapes(torch, ctx):
    """Each flash kernel against SDPA on the same inputs at each shape of
    FLASH_ARCH_SHAPES: the tensor-core kernel in bf16, then the CUDA-core
    kernel on the same inputs in float32, each in turns (kernel, SDPA,
    SDPA, kernel), with its bound and its error against the plain version;
    kept under each kernel record's ``by_shape``."""
    from repro_torch.kernels.flash_attention import (flash_attention_f32,
                                                     flash_attention_plain,
                                                     flash_attention_tc)
    from repro_torch.kernels.ref import row_relative_error
    for arch, (B, S, H, KV, dh) in FLASH_ARCH_SHAPES.items():
        q, k, v = flash_inputs(torch, B, S, H, KV, dh, torch.bfloat16, 6)
        flops = 4 * dh * H * S * (S + 1) // 2 * B
        for name, kern, ins, peak, width, iters in (
                ("flash_attention_tc", flash_attention_tc, (q, k, v),
                 PEAK_BF16_FLOPS, 2, 20),
                ("flash_attention", flash_attention_f32,
                 tuple(t.float() for t in (q, k, v)), PEAK_F32_FLOPS, 4, 5)):
            runs = {"kernel": lambda: kern(*ins),
                    "sdpa": lambda: sdpa(torch, *ins)}
            times = {run: [] for run in runs}
            for run in ("kernel", "sdpa", "sdpa", "kernel"):
                times[run].append(time_ms(torch, runs[run], iters=iters))
            got, want = runs["kernel"](), flash_attention_plain(*ins)
            err = float(torch.max(torch.abs(got.float() - want.float())))
            rel = row_relative_error(got, want)
            ms = sum(times["kernel"]) / 2
            lib = sum(times["sdpa"]) / 2
            bnd, by = larger_bound(flops / peak,
                                   width * B * S * dh * (2 * H + 2 * KV))
            ctx["kernels"].setdefault(name, {}).setdefault(
                "by_shape", []).append(
                {"arch": arch, "shape": [B, S, H, KV, dh], "ms": ms,
                 "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                 "max_abs_err": err})
            log("timing", f"{name} at {arch}'s prefill B={B} S={S} H={H} "
                f"KV={KV} dh={dh} {str(ins[0].dtype).rsplit('.', 1)[-1]}: "
                f"kernel {ms:.4f} ms (runs "
                f"{', '.join(f'{t:.4f}' for t in times['kernel'])}), SDPA "
                f"{lib:.4f} ms (runs "
                f"{', '.join(f'{t:.4f}' for t in times['sdpa'])}), max "
                f"|err| {err:.3g}, per-row relative {rel:.3g}, bound "
                f"{bnd:.4f} ms ({by}) = {bnd / ms:.1%} of the kernel's "
                f"time, {flops / ms / 1e9:.1f} TFLOP/s  [{ctx['card']}]")


# ---------------------------------------------------------------------------
# phase: the launch analyses held against the card
# ---------------------------------------------------------------------------

# the dry run's peak over the measured one, per cell
PEAK_RATIO = (0.90, 1.10)


def main_sweep(torch, ctx):
    """The main cell's fused sweep as the path launches it (the layout,
    the final centers and influence): (ms, pairs computed, blocks), from
    the timing phase when it ran, else timed here."""
    rec = ctx["kernels"].get("assign_reduce", {})
    if "pairs" in rec:
        return rec["ms"], rec["pairs"], rec["blocks"]
    from repro_torch.kernels.assign_kernel import (grid_blocks,
                                                   points_per_thread)
    from repro_torch.kernels.ops import point_layout
    bp = path_block_p()
    pts, _, final_c, final_i = main_state(torch, ctx)
    w = torch.ones(MAIN_N, device=DEVICE)
    inputs = kernel_inputs(torch, True, pts, final_c, final_i, w, bp, 128,
                           point_layout(pts, bp))
    pairs = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    run_entry("assign_reduce", inputs, MAIN_K, bp, 128, "f32", pairs=pairs)
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: run_entry(
        "assign_reduce", inputs, MAIN_K, bp, 128, "f32"), iters=20)
    blocks = grid_blocks(MAIN_N, MAIN_D, MAIN_K, points_per_thread(bp), 0,
                         True, pts.device)
    return ms, int(pairs), blocks


def phase_roofline(torch, ctx):
    """The launch analyses against this run's measurements. Every cell
    whose peak an earlier phase measured (``keep_peak``: each ``archs``
    config's serve and prefill at the depth run there, granite's serve
    and prefill, ``trainer`` A) is dry-run on ``meta`` tensors
    (``launch.dryrun.run_cell``, no model on the card), and its estimate
    (resident arguments + the liveness peak) must lie within PEAK_RATIO
    of the measured peak; a miss lists the largest tensors live at the
    estimated peak. Then the first MFU readings (``roofline.model_flops``
    over the measured seconds over 989e12) of ``trainer`` A's steady
    step and granite's warm prefill, and ``kernel_roofline_record`` on
    the ``h100`` row with the ``cuda`` model for the main cell's measured
    sweep."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.kernel_roofline import kernel_roofline_record
    from repro_torch.launch.shapes import ShapeCell
    card = ctx["card"]
    peaks = ctx.get("peaks", {})
    check(bool(peaks), "roofline: no phase measured a peak (run archs, "
          "serve, prefill or trainer before it)")
    misses = []
    for tag, p in peaks.items():
        t0 = time.perf_counter()
        rec = D.run_cell(p["arch"], ShapeCell(*p["cell"]),
                         do_roofline=False, hp=p["hp"],
                         cfg_overrides=p["cfg_overrides"], tag=tag)
        mem = rec["memory"]
        est, got = mem["live_bytes"], p["measured"]
        ratio = est / got
        ok = PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]
        log("roofline", f"{tag}: dry run {est / 2 ** 30:.3f} GiB (arguments "
            f"{mem['resident_argument_bytes'] / 2 ** 30:.3f} + liveness "
            f"peak {mem['peak_temp_estimate'] / 2 ** 30:.3f}), measured "
            f"{got / 2 ** 30:.3f} GiB (max_memory_allocated above what was "
            f"allocated before its parameters): ratio {ratio:.4f} "
            f"({'within' if ok else 'OUTSIDE'} {PEAK_RATIO[0]}-"
            f"{PEAK_RATIO[1]}), {p['cell'][0]} {rec['n_layers']} layers, "
            f"traced in {time.perf_counter() - t0:.1f} s  [{card}]")
        if not ok:
            misses.append(tag)
            for t in mem["largest_at_peak"]:
                log("roofline", f"  {tag} live at the estimated peak: "
                    f"{t['bytes'] / 2 ** 20:.1f} MiB {t['op']} {t['shape']} "
                    f"{t['dtype']}")
    check(not misses, f"roofline: the dry run's peak is outside "
          f"{PEAK_RATIO} of the measured one for {misses}")
    t0 = time.perf_counter()
    rank_dryruns(ctx)
    pod_cell(ctx)
    log("roofline", f"the ranks' dry runs and the pod cell "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    granite = configs.get_config("granite_moe_3b_a800m")
    for what, mode, B, S, key in (
            ("trainer A's steady step", "train", TRAIN_B, TRAIN_S,
             "trainer_step_s"),
            ("granite's warm prefill", "prefill", 1, PREFILL_S,
             "prefill_s")):
        if key not in ctx:
            continue
        secs = ctx[key]
        mf = RL.model_flops(granite, mode, B, S)
        log("roofline", f"MFU of {what} (B={B} S={S}): model_flops "
            f"{mf:.6e} / {secs:.6f} s / {RL.PEAK_FLOPS:.0e} = "
            f"{RL.mfu(granite, mode, B, S, secs):.6f}  [{card}]")
    ms, pairs, blocks = main_sweep(torch, ctx)
    krec = kernel_roofline_record(
        MAIN_N, MAIN_D, MAIN_K, measured_s=ms / 1e3, platform="h100",
        backend="cuda", fused=True, blocks=blocks, layout=True,
        prune_frac=1.0 - pairs / (MAIN_N * MAIN_K))
    log("roofline", "kernel_roofline_record(h100, cuda) of the main cell's "
        "fused sweep: " + json.dumps(krec) + f"  [{card}]")


# the production cell dry-run on a rank of the 16 x 16 pod
POD_CELL = ("granite_moe_3b_a800m", "train_4k", "pod", 0)


def rank_dryruns(ctx):
    """Each rank of each run over ranks that an earlier phase kept
    (``keep_rank_peaks``: trainer_dp at data=2 and model=2, serve_tp's
    engine and prefills at model=2) traced alone on its own ``meta`` mesh
    (``dryrun.run_cell`` with the rank, its collectives a
    ``meta_communicator``'s, as the card's: gloo on CUDA tensors
    reduce-scatters natively as NCCL does): its estimate (resident
    arguments + the
    liveness peak) within PEAK_RATIO of the rank's measured peak, and
    its collectives a step, by kind in calls and bytes, equal to what the
    rank's communicator counted a step. Nothing launches on the card."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeCell
    card = ctx["card"]
    kept = ctx.get("rank_peaks", {})
    if not kept:
        log("roofline", "no run over ranks kept its peaks (trainer_dp and "
            "serve_tp did not run): no rank dry-run")
        return
    misses = []
    for tag, p in kept.items():
        mesh = make_host_mesh(*p["mesh"], device="meta")
        for rank, (got, moved) in enumerate(zip(p["measured"], p["moved"])):
            t0 = time.perf_counter()
            rec = D.run_cell(p["arch"], ShapeCell(*p["cell"]), mesh, rank,
                             do_roofline=False, hp=p["hp"],
                             cfg_overrides=p["cfg_overrides"], tag=tag)
            mem, col = rec["memory"], rec["collectives"]
            est = mem["live_bytes"]
            ratio = est / got
            ok = PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]
            same = moved is None or all(float(col[k]) == float(moved[k])
                                        for k in col)
            counted = ("not kept on this rank" if moved is None else
                       ", ".join(f"{k} {moved[k]:.1f}" for k in col))
            log("roofline", f"{tag} rank {rank} of {mesh.shape}: dry run "
                f"{est / 2 ** 30:.3f} GiB (arguments "
                f"{mem['resident_argument_bytes'] / 2 ** 30:.3f} + liveness "
                f"peak {mem['peak_temp_estimate'] / 2 ** 30:.3f}), measured "
                f"{got / 2 ** 30:.3f} GiB above the rank's base: ratio "
                f"{ratio:.4f} ({'within' if ok else 'OUTSIDE'} "
                f"{PEAK_RATIO[0]}-{PEAK_RATIO[1]}); collectives a step, dry "
                f"run {', '.join(f'{k} {v}' for k, v in col.items())}; "
                f"counted {counted}: {'equal' if same else 'DIFFERENT'}; "
                f"{rec['n_layers']} layers, traced in "
                f"{time.perf_counter() - t0:.1f} s  [{card}]")
            if not ok:
                misses.append(f"{tag} rank {rank} peak")
                for t in mem["largest_at_peak"]:
                    log("roofline", f"  {tag} rank {rank} live at the "
                        f"estimated peak: {t['bytes'] / 2 ** 20:.1f} MiB "
                        f"{t['op']} {t['shape']} {t['dtype']}")
            if not same:
                misses.append(f"{tag} rank {rank} collectives")
    check(not misses, f"roofline: the ranks' dry runs miss for {misses}")


def pod_cell(ctx):
    """POD_CELL: a rank of the reference's production pod traced alone on
    ``meta`` (memory, its fit in one H100's 80 GB, its collectives and
    wire a step, the per-rank roofline), printed with its trace
    seconds."""
    from repro_torch.launch import dryrun as D
    arch, shape, mesh, rank = POD_CELL
    t0 = time.perf_counter()
    rec = D.run_cell(arch, shape, mesh, rank)
    secs = time.perf_counter() - t0
    check(rec["ok"], f"roofline: the pod cell {POD_CELL} failed")
    mem, rl, wire = rec["memory"], rec["roofline"], rec["cost"]["wire_per_dev"]
    log("roofline", f"pod cell: {arch} {shape} rank {rank} of the "
        f"{rec['mesh_shape']} production mesh ({rec['n_devices']} ranks), "
        f"{rec['n_layers']} layers, batch argument {rec['batch_argument']}: "
        f"{mem['live_bytes'] / 2 ** 30:.3f} GiB (arguments "
        f"{mem['resident_argument_bytes'] / 2 ** 30:.3f} + liveness peak "
        f"{mem['peak_temp_estimate'] / 2 ** 30:.3f}), fits one 80 GB H100: "
        f"{mem['fits_hbm_80g']}; collectives a step "
        f"{json.dumps(rec['collectives'])}; wire a step "
        f"{wire['total'] / 1e9:.3f} GB ({json.dumps(wire['counts'])}); "
        f"FLOPs {rec['cost']['flops_per_dev']:.4e}, bytes "
        f"{rec['cost']['bytes_per_dev']:.4e} a rank; roofline compute "
        f"{rl['compute_s']:.4f} s, memory {rl['memory_s']:.4f} s, "
        f"collective {rl['collective_s']:.4f} s ({rl['bottleneck']}); "
        f"traced in {secs:.1f} s (build {rec['dryrun_s']['build']:.1f}, "
        f"memory {rec['dryrun_s']['memory']:.1f}, cost "
        f"{rec['dryrun_s']['cost']:.1f})  [{ctx['card']}]")


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
    # float32: CUDA cores (the float32 prefill's)
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
        if "by_shape" in rec:       # the other archs' shapes, timed too
            entry["by_shape"] = rec["by_shape"]
        # the later slices' paths, each counted from 0 on its own
        entry["launches_by_path"] = {tag: counts[name] for tag, counts
                                     in ctx["paths"].items()
                                     if name in counts}
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
    ctx = {"kernels": {}, "paths": {}}
    phase_card(torch, ctx)
    run = {"build": lambda: phase_build(torch, ctx),
           "kernels": lambda: phase_kernels(torch, args.quick),
           "lm_kernels": lambda: phase_lm_kernels(torch),
           "main": lambda: phase_main(torch, ctx),
           "paths": lambda: phase_paths(torch, ctx),
           "agreement": lambda: phase_agreement(torch, ctx),
           "profile": lambda: phase_profile(torch, ctx),
           "repartition": lambda: phase_repartition(torch, ctx),
           "hierarchical": lambda: phase_hierarchical(torch, ctx),
           "pserve": lambda: phase_pserve(torch, ctx),
           "refine": lambda: phase_refine(torch, ctx),
           "sharded": lambda: phase_sharded(torch, ctx),
           "experiments": lambda: phase_experiments(torch, ctx),
           "serve": lambda: phase_serve(torch, ctx),
           "prefill": lambda: phase_prefill(torch, ctx),
           "archs": lambda: phase_archs(torch, ctx),
           "train": lambda: phase_train(torch, ctx),
           "trainer": lambda: phase_trainer(torch, ctx),
           "trainer_dp": lambda: phase_trainer_dp(torch, ctx),
           "serve_tp": lambda: phase_serve_tp(torch, ctx),
           "timing": lambda: phase_timing(torch, ctx),
           "roofline": lambda: phase_roofline(torch, ctx)}
    t_all = time.perf_counter()
    took = {}
    for name in PHASES[1:]:
        if name in phases:
            t0 = time.perf_counter()
            run[name]()
            took[name] = time.perf_counter() - t0
            log("time", f"phase {name}: {took[name]:.1f} s")
    if "serve_tp" in took and set(SERVE_TP_CUT_BEFORE_S) <= set(took):
        now = sum(took[name] for name in SERVE_TP_CUT_BEFORE_S)
        before = sum(SERVE_TP_CUT_BEFORE_S.values())
        log("time", f"room for serve_tp: {' + '.join(SERVE_TP_CUT_BEFORE_S)}"
            f" {now:.1f} s in this run against {before:.1f} s before the "
            f"cuts: {before - now:.1f} s saved; serve_tp "
            f"{took['serve_tp']:.1f} s")
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
