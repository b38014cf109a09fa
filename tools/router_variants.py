#!/usr/bin/env python3
"""Modified copies of the port's MoE-router kernel
(``src/repro_torch/kernels/csrc/router.cu``), run on the card.

Each copy is the repository's ``src/`` and ``chip_smoke.py`` under
``build/router_<name>/`` (``build/`` is listed in ``.gitignore``) with one
change to the kernel's source; nothing in the tree itself changes. Run
from the root of a checkout on a machine with an H100::

    python3 tools/router_variants.py tune split token th2 ring2 split
    python3 tools/router_variants.py mutant ties multiply droplast

``tune`` times the two designs of the decode form against each other:
``split`` (the source as it is: experts split across blocks, the last
block ranks the rows) and ``token`` (design (b), which this file adds to
the copy: one block a token over all of E x D);
and the tiled form: ``ring2`` stages two chunks where the source stages
three, ``th2`` splits the warps into two token halves x four D slices (4
tokens a thread) where the source has eight D slices (8 tokens a thread).
Each copy holds the kernel against the plain version at granite's
widths in every mode and on planted near-ties, then times it at T = 1,
4, 8, 32 and 4096 (unit form, bf16 tokens as on the serving path, and
float32 tokens at 4096): CUDA events
over launches of its C entry (chip_smoke's ``router_launcher``), three
runs, and the device time a call by torch.profiler.
Name a design twice, in turns, to see the spread.

``mutant`` makes deliberately broken copies and runs chip_smoke's
``lm_kernels`` phase on each, which must fail: ``ties`` puts the higher
expert first on ties, ``multiply`` multiplies by 1 / influence^2 in place
of the divide, ``droplast`` leaves the last expert out of every merge
(the decode form's last expert block, the tiled form's last expert).
Exits non-zero if a mutant passes or a tuned copy fails its check.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = Path("src/repro_torch/kernels/csrc/router.cu")

# design (b) of the decode form, one block a token over all of E x D: the
# source no longer carries it (it took 4-5 times as long as the split form)
_TOKEN_KERNEL = """// ---------------------------------------------------------------------------
// decode form (b): one block a token over all of E x D
// ---------------------------------------------------------------------------

template <typename XT>
__global__ void __launch_bounds__(DEC_THREADS)
router_decode_token(const XT* __restrict__ x, const float* __restrict__ c,
                    const float* __restrict__ scale, int mode, int E, int D,
                    int top_k, int* __restrict__ idx_out,
                    float* __restrict__ eff_out) {
  extern __shared__ float tok_s[];          // x_t [D], then eff [E]
  float* eff_s = tok_s + D;
  __shared__ float red[DEC_WARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t = blockIdx.x;
  const XT* xt = x + static_cast<size_t>(t) * D;
  float xn = 0.0f;
  for (int d = tid; d < D; d += DEC_THREADS) {
    const float v = to_f32(xt[d]);
    tok_s[d] = v;
    xn = fmaf(v, v, xn);
  }
  xn = warp_sum(xn);
  if (lane == 0) red[warp] = xn;
  __syncthreads();
  float xs = 0.0f;
  for (int w = 0; w < DEC_WARPS; ++w) xs += red[w];
  for (int e = warp; e < E; e += DEC_WARPS) {
    const float* ce = c + static_cast<size_t>(e) * D;
    float dot = 0.0f, cn = 0.0f;
#pragma unroll 8
    for (int d = lane; d < D; d += 32) {
      const float cv = ce[d];
      dot = fmaf(tok_s[d], cv, dot);
      cn = fmaf(cv, cv, cn);
    }
    dot = warp_sum(dot);
    cn = warp_sum(cn);
    if (lane == 0) eff_s[e] = effective(xs, cn, dot, scale, mode, e);
  }
  __syncthreads();
  merge_rows(eff_s, 1, E, top_k, t, idx_out, eff_out);
}

"""
_BEFORE_LAUNCH = "template <typename XT>\nint launch(const XT* x,"
_LAUNCH_SPLIT = ("    router_decode_split<XT><<<E, DEC_THREADS, T * E * "
                 "sizeof(float), st>>>(\n"
                 "        x, c, scale, mode, T, E, D, top_k, scratch, ticket, "
                 "idx, eff);\n")
_LAUNCH_TOKEN = ("    router_decode_token<XT><<<T, DEC_THREADS, (D + E) * "
                 "sizeof(float), st>>>(\n"
                 "        x, c, scale, mode, E, D, top_k, idx, eff);\n")
_RING = "  static constexpr int STAGES = 4 * floats(3) <= 232448 ? 3 : 2;"
# name -> (old, new) edits of router.cu
TUNES = {
    "split": (),
    "token": ((_LAUNCH_SPLIT, _LAUNCH_TOKEN),
              (_BEFORE_LAUNCH, _TOKEN_KERNEL + _BEFORE_LAUNCH)),
    "ring2": ((_RING, "  static constexpr int STAGES = 2;"),),
    "th2": (("constexpr int TH = 1;", "constexpr int TH = 2;"),),
}
MUTANTS = {
    "ties": (("  return va < vb || (va == vb && ia < ib);",
              "  return va < vb || (va == vb && ia > ib);"),),
    "multiply": (("    return __fdiv_rn(v, __fmul_rn(i, i));",
                  "    return __fmul_rn(v, __frcp_rn(__fmul_rn(i, i)));"),),
    "droplast": (("  const int n = E;   // experts the merge reads",
                  "  const int n = E - 1;"),
                 ("      const int n_tile = min(BE, E - e0);  "
                  "// experts of this tile merged",
                  "      const int n_tile = min(BE, E - e0) - "
                  "(e0 + BE >= E);")),
}

TIME_COPY = """
import sys
sys.path[:0] = [".", "src"]
import torch
import chip_smoke as cs
cs.phase_card(torch, {})
for T in (1, 4, 32):
    for mode in cs.ROUTER_MODES:
        cs.compare_router(torch, T, 40, 1536, 8, T, torch.bfloat16, mode)
cs.router_planted(torch, 4, 8, torch.bfloat16)
out = []
cs.compare_router(torch, 4096, 40, 1536, 8, 1, torch.bfloat16, "divide")
for T, dt in ((1, torch.bfloat16), (4, torch.bfloat16), (8, torch.bfloat16),
              (32, torch.bfloat16), (4096, torch.bfloat16),
              (4096, torch.float32)):
    x, c, _ = cs.router_inputs(torch, T, 40, 1536, T, dt, True)
    fn = cs.router_launcher(torch, x, c, None, 8)
    runs = [cs.time_ms(torch, fn, iters=500) for _ in range(3)]
    dev, each = cs.router_device_ms(torch, fn)
    out.append(f"T={T} {str(dt)[6:]} " + ", ".join(f"{t:.4f}" for t in runs)
               + f" ms (device {dev:.4f} ms{': ' + each if T > 32 else ''})")
print(f"[tune] {sys.argv[1]}: " + "; ".join(out) + f"  [{cs.card_line()}]")
"""


def copy_tree(name: str) -> Path:
    dest = ROOT / "build" / f"router_{name}"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copytree(ROOT / "src", dest / "src",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dest)
    return dest


def edit(dest: Path, edits) -> None:
    path = dest / KERNEL
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{KERNEL}: expected one line {old!r}")
        text = text.replace(old, new)
    path.write_text(text)


def tune(name: str) -> bool:
    dest = copy_tree(name)
    edit(dest, TUNES[name])
    run = subprocess.run([sys.executable, "-c", TIME_COPY, name], cwd=dest,
                         capture_output=True, text=True, timeout=600)
    tail = [line for line in run.stdout.splitlines() if "[tune]" in line]
    print("\n".join(tail) or run.stdout[-2000:], run.stderr[-2000:],
          flush=True)
    return run.returncode == 0


def mutant(name: str) -> bool:
    dest = copy_tree(name)
    edit(dest, MUTANTS[name])
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
