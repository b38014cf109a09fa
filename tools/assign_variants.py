#!/usr/bin/env python3
"""Modified copies of the port's assignment sweep
(``src/repro_torch/kernels/csrc/assign.cu``), run on the card.

Each copy is the repository's ``src/`` and ``chip_smoke.py`` under
``build/assign_<name>/`` (``build/`` is listed in ``.gitignore``) with one
change to the kernel's source (and, for ``gatherk``, to its wrapper);
nothing in the tree itself changes. Run from
the root of a checkout on a machine with an H100::

    python3 tools/assign_variants.py mutant slack
    python3 tools/assign_variants.py tune base minblocks3 stcs plainst \
        plainld gatherk gatherk_pfw

``tune`` makes copies with one change each (``base``: none) and, on each,
holds the four entry points bit-equal to the same kernel with pruning off
at the main cell's final state in the layout (n = 2^22, k = 1024) and
times them there with CUDA events (unit weights, the main cell's). The
changes: ``minblocks3`` asks for three resident blocks an SM
(``__launch_bounds__(THREADS, 3)``); ``stcs`` writes idx/best/second
with streaming stores (``__stcs``) and ``plainst`` with plain ones,
instead of the kernel's L2 "evict last" cache policy; ``plainld`` reads
the points, the order and the weights with ordinary loads instead of the
kernel's streaming ones (``__ldcs``);
``gatherk`` gathers the weights inside the kernel through the order
instead of in the wrapper before the launch, and ``gatherk_pfw`` also
has every block prefetch its share of the weights into L2 first. Each
copy also times the wrapper's gather (``torch.index_select``) alone.

``mutant slack`` drops the rounding slack of the per-center lower bound and
scales the bound by 1.5, so the kernel skips centers that can be a
point's best or second. Each copy runs chip_smoke's ``kernels`` phase
(``--quick``), whose layout cases hold the pruned kernel bit-equal to the
same kernel with pruning off: that check must fail, and say so. Exits
non-zero if a copy passes or fails another check.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = "src/repro_torch/kernels/csrc/assign.cu"
WRAPPER = "src/repro_torch/kernels/assign_kernel.py"

_STORES = ("        st_keep(idx_out + g[q], bi[q], keep);\n"
           "        st_keep(best_out + g[q], best[q], keep);\n"
           "        st_keep(second_out + g[q], second[q], keep);\n")
# the weights gathered inside the kernel (through the order), not by the
# wrapper before the launch
_GATHER_IN_KERNEL = (
    (KERNEL, "      if (MOMENTS) wq[q] = ok ? __ldcs(weights + pid[q]) : "
             "0.f;\n",
     "      if (MOMENTS) wq[q] = g[q] >= 0 ? weights[g[q]] : 0.f;\n"),
    (WRAPPER, "    rows_w = weights if order is None else "
              "torch.index_select(weights, 0,\n"
              "                                                              "
              "order)\n",
     "    rows_w = weights\n"))
_TILE_LOOP = ("  const int n_tiles = (n + TILE - 1) / TILE;\n"
              "  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {\n"
              "    const int base = t * TILE;\n"
              "    __syncthreads();  // the previous tile's shared memory "
              "has been read\n")
_PREFETCH = (KERNEL, _TILE_LOOP,
             "  if (MOMENTS && order)   // weights into L2 before the gather\n"
             "    for (int l = blockIdx.x * THREADS + tid; l < (n + 31) / 32;"
             "\n         l += gridDim.x * THREADS)\n"
             "      asm volatile(\"prefetch.global.L2::evict_last [%0];\"\n"
             "                   :: \"l\"(weights + static_cast<size_t>(l) * "
             "32));\n" + _TILE_LOOP)

# name -> (file, old, new) edits
TUNES = {
    "base": (),
    "minblocks3": ((KERNEL, "__global__ void __launch_bounds__(THREADS)\n"
                            "assign_pruned(",
                    "__global__ void __launch_bounds__(THREADS, 3)\n"
                    "assign_pruned("),),
    "stcs": ((KERNEL, _STORES,
              "        __stcs(idx_out + g[q], bi[q]);\n"
              "        __stcs(best_out + g[q], best[q]);\n"
              "        __stcs(second_out + g[q], second[q]);\n"),),
    "plainst": ((KERNEL, _STORES,
                 "        idx_out[g[q]] = bi[q];\n"
                 "        best_out[g[q]] = best[q];\n"
                 "        second_out[g[q]] = second[q];\n"),),
    "plainld": ((KERNEL, "        const float v = __ldcs(row + j);\n",
                 "        const float v = row[j];\n"),
                (KERNEL, "      g[q] = ok ? (order ? __ldcs(order + pid[q]) "
                         ": pid[q]) : -1;\n",
                 "      g[q] = ok ? (order ? order[pid[q]] : pid[q]) : -1;\n"),
                (KERNEL, "      if (MOMENTS) wq[q] = ok ? __ldcs(weights + "
                         "pid[q]) : 0.f;\n",
                 "      if (MOMENTS) wq[q] = ok ? weights[pid[q]] : 0.f;\n")),
    "gatherk": _GATHER_IN_KERNEL,
    "gatherk_pfw": _GATHER_IN_KERNEL + (_PREFETCH,),
}

TIME_COPY = """
import sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
from repro_torch.kernels.ops import point_layout
ctx = {"kernels": {}}
cs.phase_card(torch, ctx)
pts, _, ctr, infl = cs.main_state(torch, ctx)
bp = cs.path_block_p()
lay = point_layout(pts, bp)
w = torch.ones(cs.MAIN_N, device=cs.DEVICE)
rows = lay.order.long()
gather = cs.time_ms(torch, lambda: torch.index_select(w, 0, rows), iters=30)
print(f"[tune] {sys.argv[1]}: gathering the weights into layout order "
      f"(torch.index_select) {gather:.4f} ms  [{ctx['card']}]", flush=True)
for name, (_, _, sorted_, _) in cs.entry_points().items():
    inputs = cs.kernel_inputs(torch, sorted_, pts, ctr, infl, w, bp, 128, lay)
    got = cs.run_entry(name, inputs, cs.MAIN_K, bp, 128, "f32")
    ref = cs.run_unpruned(torch, name, inputs, cs.MAIN_K, bp, "f32")
    equal = all(a is None or torch.equal(a, b) for a, b in zip(got, ref))
    cs.check(equal, f"{sys.argv[1]} {name}: differs from pruning off")
    runs = [cs.time_ms(torch, lambda: cs.run_entry(
        name, inputs, cs.MAIN_K, bp, 128, "f32"), iters=30) for _ in range(2)]
    print(f"[tune] {sys.argv[1]} {name}: kernel {runs} ms, bit-equal to "
          f"pruning off  [{ctx['card']}]", flush=True)
"""

MUTANTS = {
    "slack": ((KERNEL, "  *lb = (g2 * (1.f - SHRINK) - slack) * iv * "
                       "(1.f - SHRINK);\n",
               "  *lb = 1.5f * g2 * iv;\n"),),
}


def copy_tree(name: str) -> Path:
    dest = ROOT / "build" / f"assign_{name}"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dest)
    return dest


def edited_copy(name: str, edits) -> Path:
    dest = copy_tree(name)
    for path, old, new in edits:
        text = (dest / path).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{path}: expected one line {old!r}")
        (dest / path).write_text(text.replace(old, new))
    return dest


def tune(name: str) -> bool:
    dest = edited_copy(f"tune_{name}", TUNES[name])
    run = subprocess.run([sys.executable, "-c", TIME_COPY, name], cwd=dest,
                         capture_output=True, text=True, timeout=900)
    print(run.stdout + run.stderr[-2000:], flush=True)
    return run.returncode == 0


def mutant(name: str) -> bool:
    dest = edited_copy(name, MUTANTS[name])
    run = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                          "build,kernels", "--quick"], cwd=dest,
                         capture_output=True, text=True, timeout=900)
    failed = [line for line in run.stderr.splitlines() if "FAILED" in line]
    print(f"[mutant] {name}: exit {run.returncode}; "
          f"{failed[0] if failed else 'no check failed'}", flush=True)
    return run.returncode != 0 and bool(failed) and "pruning off" in failed[0]


def main() -> int:
    acts = {"tune": (tune, TUNES), "mutant": (mutant, MUTANTS)}
    if len(sys.argv) < 3 or sys.argv[1] not in acts or \
            set(sys.argv[2:]) - set(acts[sys.argv[1]][1]):
        print(__doc__, file=sys.stderr)
        return 2
    act = acts[sys.argv[1]][0]
    results = [act(name) for name in sys.argv[2:]]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
