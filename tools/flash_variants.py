#!/usr/bin/env python3
"""Modified copies of the port's bf16 tensor-core flash-attention kernel
(``src/repro_torch/kernels/csrc/flash_attention_tc.cu``), run on the card.

Each copy is the repository's ``src/`` and ``chip_smoke.py`` under
``build/flash_<name>/`` (``build/`` is listed in ``.gitignore``) with one
edit to the kernel's source; nothing in the tree itself changes. Run from
the root of a checkout on a machine with an H100::

    python3 tools/flash_variants.py tune NAME:NWG:BK:STAGES:PINGPONG ...
    python3 tools/flash_variants.py mutant alpha droptile

``tune`` sets the block shape of the dh <= 64 instances (consumer
warpgroups, keys a tile, ring slots, turn-taking on or off), holds each
copy against the plain version at the prefill's shape (chip_smoke's
per-row check) and times it and SDPA in turns (CUDA events, one granite
layer at S = 4096). ``mutant`` makes deliberately broken copies and runs
chip_smoke's ``lm_kernels`` phase on each, which must fail: ``alpha``
skips the rescale of O on key tile 1, ``droptile`` drops the last key
tile before each warpgroup's diagonal (where that is not tile 0). Exits non-zero if a mutant passes
or a tuned copy fails its check.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("src/repro_torch/kernels/csrc/flash_attention_tc.cu")

# the block-shape lines of flash_attention_tc.cu that `tune` rewrites
SHAPE_LINES = {
    "NWG": "  static constexpr int NWG = DH <= 128 ? 2 : 1;   "
           "// consumer warpgroups",
    "BK": "  static constexpr int BK = DH <= 64 ? 128 : 64;   // keys a tile",
    "STAGES": "  static constexpr int STAGES = DH <= 64 ? 4 : "
              "(DH == 128 ? 3 : 2);  // ring",
    "PINGPONG": "  static constexpr bool PINGPONG = NWG == 2 && BK == 128;",
}

MUTANTS = {
    "alpha": ("    rescale(o, a0, a1);\n",
              "    if (j != 1) rescale(o, a0, a1);\n"),
    # tile 0 is kept, so the running max stays finite
    "droptile": ("  if (j == diag) {\n",
                 "  if (j == diag - 1 && j > 0)\n"
                 "    for (int i = 0; i < BK / 2; ++i) s[i] = NEG_INF;\n"
                 "  if (j == diag) {\n"),
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


def copy_tree(name: str) -> Path:
    dest = ROOT / "build" / f"flash_{name}"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dest)
    return dest


def edit(dest: Path, old: str, new: str) -> None:
    path = dest / KERNEL
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{KERNEL}: expected one line {old!r}")
    path.write_text(text.replace(old, new))


def tune(spec: str) -> bool:
    name, nwg, bk, stages, pingpong = spec.split(":")
    dest = copy_tree(name)
    edit(dest, SHAPE_LINES["NWG"], "  static constexpr int NWG = DH <= 64 ? "
         f"{nwg} : (DH <= 128 ? 2 : 1);")
    edit(dest, SHAPE_LINES["BK"], "  static constexpr int BK = DH <= 64 ? "
         f"{bk} : 64;")
    edit(dest, SHAPE_LINES["STAGES"], "  static constexpr int STAGES = "
         f"DH <= 64 ? {stages} : (DH == 128 ? 3 : 2);")
    edit(dest, SHAPE_LINES["PINGPONG"], "  static constexpr bool PINGPONG = "
         f"NWG == 2 && BK == 128 && {pingpong};")
    run = subprocess.run([sys.executable, "-c", TIME_COPY, spec], cwd=dest,
                         capture_output=True, text=True, timeout=600)
    print(run.stdout + run.stderr[-2000:], flush=True)
    return run.returncode == 0


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


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in ("tune", "mutant"):
        print(__doc__, file=sys.stderr)
        return 2
    act = tune if sys.argv[1] == "tune" else mutant
    results = [act(arg) for arg in sys.argv[2:]]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
