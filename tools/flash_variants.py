#!/usr/bin/env python3
"""Modified copies of the port's flash-attention kernels, run on the card:
the bf16 tensor-core kernel (``src/repro_torch/kernels/csrc/
flash_attention_tc.cu``) and the float32 CUDA-core kernel
(``.../csrc/flash_attention.cu``).

Each copy is the repository's ``src/`` and ``chip_smoke.py`` under
``build/flash_<name>/`` (``build/`` is listed in ``.gitignore``) with one
or more edits to a kernel's source; nothing in the tree itself changes.
Run from the root of a checkout on a machine with an H100::

    python3 tools/flash_variants.py tune NAME:NWG:BK:STAGES:PINGPONG ...
    python3 tools/flash_variants.py tune32 NAME:BQ:BK:WARPS[:UNROLL] ...
    python3 tools/flash_variants.py mutant alpha droptile f32alpha f32droptile
    python3 tools/flash_variants.py whatif base nopv noqk nobar noexp

``tune`` sets the block shape of the bf16 kernel's dh <= 64 instances
(consumer warpgroups, keys a tile, ring slots, turn-taking on or off),
holds each copy against the plain version at the prefill's shape
(chip_smoke's per-row check) and times it and SDPA in turns (CUDA events,
one granite layer at S = 4096). ``tune32`` sets the float32 kernel's
dh <= 64 block shape (queries a block, keys a tile, warps a block: each
thread then holds BQ / (4 WARPS) query rows; optionally the unroll factor
of its d and key loops), prints what ``ptxas`` said
of the copy's instances, holds it against the plain version at 2e-5
(chip_smoke's ``compare_flash`` in float32) at the prefill's shape, a
ragged softcap case and dh 32 and 16, and times it and SDPA in float32 in
turns at the prefill's shape. ``mutant`` makes deliberately broken copies
and runs chip_smoke's ``lm_kernels`` phase on each, which must fail:
``alpha`` / ``f32alpha`` skip the rescale of O on key tile 1 of the bf16 /
float32 kernel, ``droptile`` drops the last key tile before each
warpgroup's diagonal (where that is not tile 0), ``f32droptile`` the last
key tile before each block's diagonal (where that is not tile 0).
``whatif`` times copies of the float32 kernel that each drop one part of
its work (``nopv`` the PV product, ``noqk`` QK^T's reads of K, ``nobar``
the barrier a tile, ``noexp`` the exp2 of p and alpha; ``base`` none),
unchecked, at granite's heads at S = 4096 and 16384: where its time goes.
Exits non-zero if a mutant passes or a tuned copy fails its check.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention_tc.cu")
KERNEL32 = Path("src/repro_torch/kernels/csrc/flash_attention.cu")

# the block-shape lines of flash_attention_tc.cu that `tune` rewrites
SHAPE_LINES = {
    "NWG": "  static constexpr int NWG = DH <= 128 ? 2 : 1;   "
           "// consumer warpgroups",
    "BK": "  static constexpr int BK = DH <= 64 ? 128 : 64;   // keys a tile",
    "STAGES": "  static constexpr int STAGES = DH <= 64 ? 4 : "
              "(DH <= 128 ? 3 : 2);  // ring",
    "PINGPONG": "  static constexpr bool PINGPONG = NWG == 2 && BK == 128;",
}

# the tile lines of flash_attention.cu that `tune32` rewrites
SHAPE_LINES_F32 = {
    "NW": "  static constexpr int NW = 8;                                   "
          "// warps",
    "RM": "  static constexpr int RM = DH <= 64 ? 8 : (DH <= 128 ? 4 : 2);  "
          "// rows a thread",
    "BK": "  static constexpr int BK = DH <= 128 ? 64 : 32;                 "
          "// keys a tile",
    "UNROLL": "  static constexpr int UNROLL = 8;          "
              "// of the d and the key loops",
}

# name -> (source, the line edited, what it becomes)
MUTANTS = {
    "alpha": (KERNEL, "    rescale(o, a0, a1);\n",
              "    if (j != 1) rescale(o, a0, a1);\n"),
    # tile 0 is kept, so the running max stays finite
    "droptile": (KERNEL, "  if (j == diag) {\n",
                 "  if (j == diag - 1 && j > 0)\n"
                 "    for (int i = 0; i < BK / 2; ++i) s[i] = NEG_INF;\n"
                 "  if (j == diag) {\n"),
    # key tile 1 starts at k0 == BK
    "f32alpha": (KERNEL32,
                 "    for (int n = 0; n < T::DN; ++n) o[i][n] *= alpha;\n",
                 "    for (int n = 0; n < T::DN; ++n)\n"
                 "      o[i][n] *= k0 == T::BK ? 1.0f : alpha;\n"),
    # the block's first diagonal tile is q0 / BK; tile 0 is kept
    "f32droptile": (KERNEL32,
                    "    const bool live = k0 <= w_last;   "
                    "// warp-uniform\n",
                    "    const bool live = k0 <= w_last &&\n"
                    "        !(kt == q0 / T::BK - 1 && kt > 0);\n"),
}

# name -> the edits of a what-if copy of the float32 kernel: each drops one
# part of the work (its results are wrong and are not checked)
WHATIF = {
    "base": (),
    "nopv": (("        pv<DH, false>(o, p_s, vt_s, rg, cg, n_sub);",
              "        ;"),),
    "noqk": (("        for (int j = 0; j < T::KN; ++j) s[i][j] = fmaf(qf[i], "
              "kf[j], s[i][j]);",
              "        for (int j = 0; j < T::KN; ++j) s[i][j] += qf[i];"),),
    "nobar": (("    __syncthreads();   // tile kt+1's K and V are in; tile kt's "
               "are free\n", ""),),
    "noexp": (("      s[i][j] = exp2f(s[i][j] - m_new);",
               "      s[i][j] = s[i][j] - m_new;"),
              ("    const float alpha = exp2f(m[i] - m_new);",
               "    const float alpha = m[i] - m_new;")),
}

TIME_COPY = """
import sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.flash_attention import flash_attention_tc
cs.phase_card(torch, {})
cs.compare_flash(torch, 1, cs.PREFILL_S, 24, 8, 64, torch.bfloat16)
cs.compare_flash(torch, 2, 300, 8, 2, 64, torch.bfloat16, 30.0)
q, k, v = cs.flash_inputs(torch, 1, cs.PREFILL_S, 24, 8, 64, torch.bfloat16, 5)
runs = {"kernel": lambda: flash_attention_tc(q, k, v),
        "sdpa": lambda: cs.sdpa(torch, q, k, v)}
times = {"kernel": [], "sdpa": []}
for name in ("kernel", "sdpa", "sdpa", "kernel"):
    times[name].append(cs.time_ms(torch, runs[name], iters=30))
print(f"[tune] {sys.argv[1]}: kernel {times['kernel']} ms, SDPA "
      f"{times['sdpa']} ms  [{cs.card_line()}]")
"""

TIME_COPY32 = """
import sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.build import build_libraries
from repro_torch.kernels.flash_attention import flash_attention_f32
cs.phase_card(torch, {})
cs.log_build(build_libraries(("flash_attention",)))
S = cs.PREFILL_S
cs.compare_flash(torch, 1, S, 24, 8, 64, torch.float32)
cs.compare_flash(torch, 2, 300, 8, 2, 64, torch.float32, 30.0)
cs.compare_flash(torch, 2, 384, 4, 1, 32, torch.float32)
cs.compare_flash(torch, 1, 300, 3, 1, 16, torch.float32)
q, k, v = cs.flash_inputs(torch, 1, S, 24, 8, 64, torch.float32, 5)
runs = {"kernel": lambda: flash_attention_f32(q, k, v),
        "sdpa": lambda: cs.sdpa(torch, q, k, v)}
times = {"kernel": [], "sdpa": []}
for name in ("kernel", "sdpa", "sdpa", "kernel"):
    times[name].append(cs.time_ms(torch, runs[name], iters=10))
ms = sum(times["kernel"]) / 2
bound = 4 * 64 * 24 * S * (S + 1) // 2 / cs.PEAK_F32_FLOPS * 1e3
print(f"[tune32] {sys.argv[1]}: kernel {times['kernel']} ms, SDPA float32 "
      f"{times['sdpa']} ms, bound {bound:.4f} ms = {bound / ms:.1%} of the "
      f"kernel's mean  [{cs.card_line()}]")
"""


TIME_WHATIF = """
import sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.build import build_libraries
from repro_torch.kernels.flash_attention import flash_attention_f32
cs.phase_card(torch, {})
build_libraries(("flash_attention",))
out = []
for S in (cs.PREFILL_S, 4 * cs.PREFILL_S):
    q, k, v = cs.flash_inputs(torch, 1, S, 24, 8, 64, torch.float32, 5)
    ms = [cs.time_ms(torch, lambda: flash_attention_f32(q, k, v), iters=5)
          for _ in range(2)]
    bound = 4 * 64 * 24 * S * (S + 1) // 2 / cs.PEAK_F32_FLOPS * 1e3
    out.append(f"S={S} {ms[0]:.4f} / {ms[1]:.4f} ms (bound {bound:.4f} ms "
               f"= {bound / min(ms):.1%})")
print(f"[whatif] {sys.argv[1]}: granite's heads, " + "; ".join(out) +
      f"  [{cs.card_line()}]")
"""


def copy_tree(name: str) -> Path:
    dest = ROOT / "build" / f"flash_{name}"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dest)
    return dest


def edit(dest: Path, source: Path, old: str, new: str) -> None:
    path = dest / source
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{source}: expected one line {old!r}")
    path.write_text(text.replace(old, new))


def tune_edits(spec: str) -> list[tuple[Path, str, str]]:
    """The edits of a ``tune`` spec NAME:NWG:BK:STAGES:PINGPONG."""
    _, nwg, bk, stages, pingpong = spec.split(":")
    return [
        (KERNEL, SHAPE_LINES["NWG"], "  static constexpr int NWG = DH <= 64 "
         f"? {nwg} : (DH <= 128 ? 2 : 1);"),
        (KERNEL, SHAPE_LINES["BK"], "  static constexpr int BK = DH <= 64 ? "
         f"{bk} : 64;"),
        (KERNEL, SHAPE_LINES["STAGES"], "  static constexpr int STAGES = "
         f"DH <= 64 ? {stages} : (DH <= 128 ? 3 : 2);"),
        (KERNEL, SHAPE_LINES["PINGPONG"], "  static constexpr bool PINGPONG "
         f"= NWG == 2 && BK == 128 && {pingpong};"),
    ]


def tune32_edits(spec: str) -> list[tuple[Path, str, str]]:
    """The edits of a ``tune32`` spec NAME:BQ:BK:WARPS[:UNROLL] (dh <= 64
    only; UNROLL, the unroll factor of the d and key loops, defaults to
    the source's)."""
    _, bq, bk, nw, *unroll = spec.split(":")
    rm, rest = divmod(int(bq), 4 * int(nw))
    if rest or rm not in (1, 2, 4, 8):
        raise SystemExit(f"{spec}: BQ / (4 x WARPS) rows a thread must be "
                         "1, 2, 4 or 8")
    return [
        (KERNEL32, SHAPE_LINES_F32["NW"], "  static constexpr int NW = "
         f"DH <= 64 ? {int(nw)} : 8;"),
        (KERNEL32, SHAPE_LINES_F32["RM"], "  static constexpr int RM = "
         f"DH <= 64 ? {rm} : (DH <= 128 ? 4 : 2);"),
        (KERNEL32, SHAPE_LINES_F32["BK"], "  static constexpr int BK = "
         f"DH <= 64 ? {int(bk)} : (DH <= 128 ? 64 : 32);"),
    ] + [(KERNEL32, SHAPE_LINES_F32["UNROLL"], "  static constexpr int "
          f"UNROLL = DH <= 64 ? {int(u)} : 8;") for u in unroll]


def run_tuned(spec: str, edits, script: str) -> bool:
    dest = copy_tree(spec.split(":")[0])
    for source, old, new in edits:
        edit(dest, source, old, new)
    run = subprocess.run([sys.executable, "-c", script, spec], cwd=dest,
                         capture_output=True, text=True, timeout=600)
    print(run.stdout + run.stderr[-2000:], flush=True)
    return run.returncode == 0


def tune(spec: str) -> bool:
    return run_tuned(spec, tune_edits(spec), TIME_COPY)


def tune32(spec: str) -> bool:
    return run_tuned(spec, tune32_edits(spec), TIME_COPY32)


def mutant(name: str) -> bool:
    dest = copy_tree(name)
    edit(dest, *MUTANTS[name])
    run = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                          "build,lm_kernels", "--quick"], cwd=dest,
                         capture_output=True, text=True, timeout=600)
    failed = [line for line in run.stderr.splitlines() if "FAILED" in line]
    print(f"[mutant] {name}: exit {run.returncode}; "
          f"{failed[0] if failed else 'no check failed'}", flush=True)
    return run.returncode != 0 and bool(failed)


def whatif(name: str) -> bool:
    edits = [(KERNEL32, old, new) for old, new in WHATIF[name]]
    return run_tuned(f"whatif_{name}", edits, TIME_WHATIF)


ACTIONS = {"tune": tune, "tune32": tune32, "mutant": mutant,
           "whatif": whatif}


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in ACTIONS:
        print(__doc__, file=sys.stderr)
        return 2
    act = ACTIONS[sys.argv[1]]
    results = [act(arg) for arg in sys.argv[2:]]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
