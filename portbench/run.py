"""The benchmark of ``repro_torch``, the PyTorch and CUDA port::

    python3 -m portbench.run --workload CELL --seed N --seconds S --trace T

run from the root of a checkout on a machine with the cell's cards. It
sets up the cell named in ``BENCHMARK.json`` (inputs from ``--seed``,
the program warmed up on the cell's shapes), measures for ``--seconds``
seconds, checks what the window produced against the plain reference in
``portbench/reference/``, and prints one JSON line last on standard
output. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
runs the window under ``torch.profiler`` and reports its per-layer
metrics. (The configuration's lower-precision control, and the program
with a fault planted, run through ``portbench.readings``.)

Exits with a non-zero code, printing no result, when no card (or too few)
is present, when the program cannot be imported, and when ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (``/proc``; 0 elsewhere)."""
    try:
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def measure(spec, seed: int, seconds: float, trace: bool, device: str,
            t0: float | None = None) -> dict:
    """One run of the cell ``spec`` (``spec.load``): set-up, window,
    check. Returns the result line as a dict (``checks`` last)."""
    import torch

    from portbench.driver import Cell
    from portbench.readers import Record
    from portbench.trace import StackSampler, summarize
    from portbench.spec import reader

    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(spec.config, spec.traffic, device, spans=trace)
    cell.setup(seed)
    setup_s = time.perf_counter() - t0
    on_card = cell.dev.type == "cuda"
    summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        with profile(activities=acts) as prof, StackSampler() as sampler:
            win = cell.window(seconds)
        summary = summarize(prof.profiler.kineto_results.events(), sampler,
                            win.start_ns)
        del prof
    else:
        win = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(cell.dev) if on_card else 0
    checks = cell.check(win)
    kind = torch.cuda.get_device_name(cell.dev) if on_card else "cpu"
    metrics = {}
    if trace:
        rec = Record(cell.dev.type, kind, cell.inputs.n, cell.inputs.d,
                     spec.config["k"], win.calls, summary)
        for m in spec.per_layer:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s,
                  spec.traffic["metric"]: win.wall_s / len(win.calls)}
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    numbers = checks["numbers"]
    correct = (checks["failed"] == 0 and checks["checked"] > 0
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": spec.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(win.calls),
           "failed": checks["failed"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops(),
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch

    from portbench.spec import load
    spec = load(ROOT, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < spec.chips:
        print(f"portbench: {args.workload} needs {spec.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program repro_torch cannot be imported "
              f"({exc})", file=sys.stderr)
        return 2
    out = measure(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                  t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}; the benchmark and the port may "
              "load none of jax, jaxlib, flax or repro", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
