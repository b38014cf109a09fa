"""Dry run of every (arch x shape) cell on ``meta`` tensors: the fit check
and the cost of each cell with no card and no memory (reference:
``repro/launch/dryrun.py``).

For each cell this module:

1. builds the cell's step at full depth on ``meta`` tensors (the abstract
   train state or parameters, ``launch/shapes.py``'s batch, a ``meta``
   decode cache) and runs it under ``live_mem.LiveMemory``: argument,
   output, alias and temp bytes and the liveness peak, and whether the
   cell fits one H100's 80 GB (the reference compiles and reads XLA's
   ``memory_analysis()``);
2. runs the step at depth 1x and 2x the layer pattern period under
   ``CostCounter`` (FLOPs of the aten ops by ``torch.utils.flop_counter``'s
   formulas, bytes each op reads and writes, and the kernels' own counts
   from their ``meta`` routes) and extrapolates to the full depth:
       f(L) = f(g) + (L/g - 1) * (f(2g) - f(g))
   the reference's method (its ``cost_analysis()`` counts a scan body
   once; eager counting has no scan, and the extrapolation equals the
   full-depth count because cost is affine in the repeat count);
3. derives the three roofline terms (``launch/roofline.py``) and writes
   one JSON record per cell.

A cell is a ``launch/shapes.py`` name or a ``ShapeCell`` (the card's own
cells: ``chip_smoke.py`` dry-runs the cells whose peaks it measures).
``--mesh single`` is one rank on one card, a deliberate departure from the
reference, whose single mesh is a 256-chip pod (ROADMAP.md queue 3).
``--mesh multi`` raises: the production mesh over ranks, the pod's
``(data, model)`` = 16 x 16, and a per-rank dry run of it are still to
come (ROADMAP.md queue 1 item 4.10 step 3).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-7b \
        --shape train_4k --mesh single --out results/dryrun/sc2.json
    python -m repro_torch.launch.dryrun --all --mesh single \
        --out-dir results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import dataclass, replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.dist.rules import resolve_rules
from repro_torch.kernels import meta as KMETA
from repro_torch.launch import roofline as RL
from repro_torch.launch.live_mem import LiveMemory, storage_key, tensors
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.shapes import SHAPES, ShapeCell, input_specs
from repro_torch.models import model as M
from repro_torch.serve.engine import make_serve_step
from repro_torch.train.step import (TrainHParams, abstract_train_state,
                                    make_train_step)

# NVIDIA H100 80GB HBM3: the data sheet's 80 GB (the reference's
# HBM_PER_CHIP is a TPU v5e's 16 GiB)
HBM_PER_CARD = 80 * 10 ** 9

MULTI_POD = ("--mesh multi needs the production mesh over ranks, "
             "launch/mesh.py::make_production_mesh, and a per-rank dry run "
             "of it, which the port does not have yet (ROADMAP.md queue 1 "
             "item 4.10 step 3); use --mesh single")

# the reference's decode step takes its position as an int32 scalar
# argument; the port's takes a Python int
POS_BYTES = 4

# ops that write no value (their output is uninitialized memory)
_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


class CostCounter(TorchDispatchMode):
    """FLOPs and bytes of a call: ``with CostCounter() as c: fn()``, then
    ``c.flops``, ``c.bytes`` and ``c.kernels`` ({name: [calls, flops,
    bytes]}, what the kernels' ``meta`` routes reported; included in
    ``flops`` and ``bytes``).

    An aten op's FLOPs are ``torch.utils.flop_counter``'s formula for it
    (matmuls, convolutions, attention; elementwise ops count 0); its bytes
    are the tensors it reads and writes, once each (views count 0)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: dict = {}
        self._costs = None
        self._collect = None

    def __enter__(self):
        self._collect = KMETA.kernel_costs()
        self._costs = self._collect.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._collect.__exit__(*exc)
        for name, flops, nbytes, _ in self._costs:
            rec = self.kernels.setdefault(name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += flops
            rec[2] += nbytes
            self.flops += flops
            self.bytes += nbytes
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        if not func.is_view and packet not in _NO_TRAFFIC:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


@dataclass
class Cell:
    """One cell's step on ``meta`` tensors: ``fn(*args)``; ``args`` holds
    what the step reads (state or parameters, batch, cache), made before
    the step runs. ``scalar_bytes``: the int32 decode position the
    reference's step takes as an argument where a layer reads it (the
    port's takes a Python int)."""
    fn: object
    args: tuple
    scalar_bytes: int = 0

    def run(self):
        return self.fn(*self.args)


def _shape(shape) -> ShapeCell:
    return shape if isinstance(shape, ShapeCell) else SHAPES[shape]


def build_cell(arch: str, shape, multi_pod: bool = False,
               n_layers: int | None = None, unroll: bool = False,
               hp: TrainHParams | None = None, overrides: dict | None = None,
               cfg_overrides: dict | None = None):
    """One cell on ``meta`` tensors. Returns (cell, meta, cfg).

    Raises:
        ValueError: ``multi_pod`` (the production mesh over ranks is
            ROADMAP.md queue 1 item 4.10).
    """
    if multi_pod:
        raise ValueError(MULTI_POD)
    mesh = make_host_mesh(device="meta")
    cfg = configs.get_config(arch)
    if cfg_overrides:
        cfg = replace(cfg, **cfg_overrides)
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    cell = _shape(shape)
    ov = dict(configs.sharding_overrides(arch, cell.mode))
    if overrides:
        ov.update(overrides)
    rules = resolve_rules(mesh, cfg, cell.mode, batch_size=cell.batch,
                          overrides=ov)
    batch = input_specs(cfg, cell)
    meta = {"arch": arch, "shape": cell.name, "mode": cell.mode,
            "batch": cell.batch, "seq": cell.seq, "mesh": "single",
            "n_devices": 1, "n_layers": cfg.n_layers}

    if cell.mode == "train":
        if hp is None:
            arch_hp = dict(getattr(configs.get(arch), "TRAIN_HPARAMS", {}))
            hp = TrainHParams(remat=True, **arch_hp)
        hp = replace(hp, unroll=unroll)
        state = abstract_train_state(cfg, hp)
        built = Cell(make_train_step(cfg, rules, hp), (state, batch))
    elif cell.mode == "prefill":
        params = M.abstract_params(cfg)

        def fn(p, b):
            return M.prefill(p, b, cfg, rules, unroll=unroll)
        built = Cell(fn, (params, batch))
    else:                                   # decode / long_decode
        params = M.abstract_params(cfg)
        cache = M.init_cache(cfg, cell.batch, cell.seq, rules, device="meta")
        key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
        # the newest position: every cache slot is read. Attention reads
        # the position (rope, the cache write); SSM layers do not
        reads_pos = any(s.attn in ("full", "swa") for s in cfg.pattern)
        built = Cell(make_serve_step(cfg, rules, unroll=unroll),
                     (params, cache, batch[key], cell.seq - 1),
                     POS_BYTES if reads_pos else 0)
    return built, meta, cfg


def memory_info(cell: Cell, top: int = 8) -> dict:
    """Run ``cell`` under ``LiveMemory``: per-device memory accounting.

    ``argument_size_in_bytes``: the arguments the step reads (state or
    parameters, batch, cache, the decode position), as the reference's
    ``jit`` keeps only the arguments its step uses;
    ``resident_argument_bytes``: every argument, read or not (what sits
    on the card); ``output_size_in_bytes``: what the step returns;
    ``alias_size_in_bytes``: the outputs that are arguments updated in
    place (the train state, the decode cache); ``temp_size_in_bytes``:
    every storage the step made, summed with no reuse (what the
    reference's CPU backend reports); ``peak_temp_estimate``: the
    liveness peak of those storages; ``live_bytes`` = resident arguments
    + the liveness peak (in-place outputs were never allocated, so
    nothing is subtracted), fit against one card's 80 GB; and the largest
    storages live at the peak."""
    args = {storage_key(t): t.untyped_storage().nbytes()
            for t in tensors(cell.args)}
    with LiveMemory() as mem:
        out = cell.run()
    outs = {storage_key(t): t.untyped_storage().nbytes()
            for t in tensors(out)}
    rec = {"argument_size_in_bytes": int(cell.scalar_bytes + sum(
               b for k, b in args.items() if k in mem.read)),
           "resident_argument_bytes": int(cell.scalar_bytes +
                                          sum(args.values())),
           "output_size_in_bytes": int(sum(outs.values())),
           "alias_size_in_bytes": int(sum(b for k, b in outs.items()
                                          if k in args)),
           "temp_size_in_bytes": int(mem.allocated),
           "peak_temp_estimate": int(mem.peak)}
    rec["live_bytes"] = rec["resident_argument_bytes"] + rec[
        "peak_temp_estimate"]
    rec["fits_hbm_80g"] = bool(rec["live_bytes"] <= HBM_PER_CARD)
    rec["largest_at_peak"] = mem.largest_at_peak(top)
    del out
    return rec


def cost_info(cell: Cell, n_devices: int = 1) -> dict:
    """Run ``cell`` under ``CostCounter``: FLOPs, bytes and the
    collectives' wire bytes (none on one rank)."""
    with CostCounter() as cc:
        out = cell.run()
    del out
    return {"flops": cc.flops, "bytes": cc.bytes,
            "kernels": {k: list(v) for k, v in cc.kernels.items()},
            "wire": RL.collective_wire((), n_devices)}


def _extrap(v1: float, v2: float, reps: int) -> float:
    return v1 + (reps - 1) * (v2 - v1)


def run_cell(arch: str, shape, mesh_kind: str = "single",
             do_roofline: bool = True, hp: TrainHParams | None = None,
             overrides: dict | None = None, tag: str = "",
             cfg_overrides: dict | None = None) -> dict:
    """One cell's record: its memory at full depth and, with
    ``do_roofline``, its cost extrapolated from 1x and 2x the pattern
    period and the roofline terms. A long_500k cell of a config with pure
    full attention is skipped, as the reference skips it."""
    multi = mesh_kind == "multi"
    cell_shape = _shape(shape)
    rec: dict = {"arch": arch, "shape": cell_shape.name, "mesh": mesh_kind,
                 "tag": tag, "ok": False}
    if cell_shape.mode == "long_decode" and not configs.long_context_ok(arch):
        rec.update(ok=True, skipped=True,
                   reason="pure full attention: long_500k skipped per "
                          "assignment (see DESIGN.md Arch-applicability)")
        return rec
    t0 = time.perf_counter()
    cell, meta, cfg = build_cell(arch, cell_shape, multi, hp=hp,
                                 overrides=overrides,
                                 cfg_overrides=cfg_overrides)
    t1 = time.perf_counter()
    rec.update(meta)
    rec["memory"] = memory_info(cell)
    t2 = time.perf_counter()
    rec["dryrun_s"] = {"build": t1 - t0, "memory": t2 - t1}
    print(f"[{arch} x {cell_shape.name} x {mesh_kind}] traced on meta "
          f"({t2 - t1:.1f}s); memory:")
    print("  " + json.dumps({k: v for k, v in rec["memory"].items()
                             if k != "largest_at_peak"}))

    if do_roofline:
        period = cfg.period
        infos = []
        for mult in (1, 2):
            co, me, _ = build_cell(arch, cell_shape, multi,
                                   n_layers=mult * period, unroll=True,
                                   hp=hp, overrides=overrides,
                                   cfg_overrides=cfg_overrides)
            infos.append(cost_info(co, me["n_devices"]))
        reps = cfg.n_layers // period
        flops = _extrap(infos[0]["flops"], infos[1]["flops"], reps)
        nbytes = _extrap(infos[0]["bytes"], infos[1]["bytes"], reps)
        wire = {k: _extrap(infos[0]["wire"][k], infos[1]["wire"][k], reps)
                for k in RL.KINDS + ("total",)}
        counts = {k: [infos[0]["wire"]["counts"][k],
                      infos[1]["wire"]["counts"][k]]
                  for k in infos[0]["wire"]["counts"]}
        rec["unrolled_cost"] = {"g": infos[0], "2g": infos[1]}
        rec["cost"] = {"flops_per_dev": flops, "bytes_per_dev": nbytes,
                       "wire_per_dev": wire, "collective_counts_g_2g": counts}
        rec["roofline"] = RL.summarize(
            cfg, cell_shape.mode, cell_shape.batch, cell_shape.seq,
            meta["n_devices"], flops, nbytes, wire["total"])
        rec["dryrun_s"]["cost"] = time.perf_counter() - t2
        print("  cost (extrapolated to full depth): "
              f"flops/dev={flops:.3e} bytes/dev={nbytes:.3e} "
              f"wire/dev={wire['total']:.3e}")
        print("  roofline: " + json.dumps(
            {k: (f"{v:.4e}" if isinstance(v, float) else v)
             for k, v in rec["roofline"].items()}))
    rec["ok"] = True
    return rec


def cell_list():
    cells = []
    for arch in configs.ARCHS:
        for shape in SHAPES:
            cells.append((arch, shape))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--out-dir", default="results/dryrun")
    args = ap.parse_args(argv)

    if args.mesh != "single":
        raise ValueError(MULTI_POD)
    cells = cell_list() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        out = args.out or os.path.join(
            args.out_dir, f"{configs.ALIASES.get(arch, arch)}"
            f"__{shape}__single.json")
        try:
            rec = run_cell(arch, shape, do_roofline=not args.no_roofline)
        except Exception as e:               # record, keep sweeping
            failures += 1
            rec = {"arch": arch, "shape": shape, "mesh": "single",
                   "ok": False, "error": repr(e),
                   "traceback": traceback.format_exc()}
            print(f"[{arch} x {shape} x single] FAILED: {e!r}")
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
