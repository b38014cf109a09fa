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

**Meshes.** A record is one rank's. ``--mesh single`` is one rank on one
card, a deliberate departure from the reference, whose single mesh is a
256-chip pod (ROADMAP.md queue 3 item 23). ``--mesh pod`` is the
reference's single: rank ``--rank`` (default 0) of
``launch.mesh.make_production_mesh()``, 16 x 16 over ``(data, model)``;
``--mesh multi`` is a rank of the 2 x 16 x 16 ``(pod, data, model)`` mesh,
``both`` the two. The rank is traced alone, in this process, through the
port's real step code on the rank's shards (``abstract_train_state`` /
``abstract_params`` with the rules, its own cache and batch argument,
``shapes.BATCH_ARGUMENT``), its communicator a
``dist.comm.meta_communicator``: the collectives complete at once, their
outputs allocated as a real rank's are, and each is logged. The record
holds the rank (``rank``, ``n_devices``), its memory and fit against one
H100, its collectives a step at full depth (``collectives``, as
``Communicator.counters`` counts them) and their wire bytes
(``cost.wire_per_dev``, ``roofline.collective_wire``), and (``single``,
``pod``; not ``multi``, as in the reference) its FLOPs, bytes and
roofline terms. A dimension the
mesh extent does not divide is held whole, where the reference's ``jit``
refuses the cell (ROADMAP.md departure 28: the KV heads of 7 of the 10
configs at ``model`` = 16).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-7b \
        --shape train_4k --mesh single --out results/dryrun/sc2.json
    python -m repro_torch.launch.dryrun --arch granite-moe-3b-a800m \
        --shape train_4k --mesh pod --rank 0
    python -m repro_torch.launch.dryrun --all --mesh both \
        --out-dir results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from dataclasses import dataclass, field, replace

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.dist.comm import log_counters, meta_communicator, using
from repro_torch.dist.rules import resolve_rules
from repro_torch.kernels import meta as KMETA
from repro_torch.launch import roofline as RL
from repro_torch.launch.live_mem import LiveMemory, storage_key, tensors
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.shapes import (BATCH_ARGUMENT, SHAPES, ShapeCell,
                                       input_specs)
from repro_torch.models import model as M
from repro_torch.serve.engine import make_serve_step
from repro_torch.train.step import (TrainHParams, abstract_train_state,
                                    make_train_step)

# NVIDIA H100 80GB HBM3: the data sheet's 80 GB (the reference's
# HBM_PER_CHIP is a TPU v5e's 16 GiB)
HBM_PER_CARD = 80 * 10 ** 9

#: the meshes a record can be of (``--mesh``; ``both`` is pod and multi)
MESHES = ("single", "pod", "multi")

#: the collectives of a dry-run rank run as the card's: NCCL on CUDA
#: tensors, which reduce-scatters natively
CARD_COLLECTIVES = ("nccl", "cuda")

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
    port's takes a Python int). ``comm``: the rank's meta communicator
    (None on one rank), bound while the step runs, and ``log`` its
    collectives of the last run."""
    fn: object
    args: tuple
    scalar_bytes: int = 0
    comm: object = None
    log: list = field(default_factory=list)

    def run(self):
        del self.log[:]
        with _bound(self.comm):
            return self.fn(*self.args)


def _bound(comm):
    """``comm`` bound as the calling rank's (nothing on one rank)."""
    return contextlib.nullcontext() if comm is None else using(comm)


def _shape(shape) -> ShapeCell:
    return shape if isinstance(shape, ShapeCell) else SHAPES[shape]


def _mesh(mesh) -> tuple:
    """(name, Mesh) of a ``MESHES`` name (its ``meta`` mesh) or a ``Mesh``
    (named by its extents)."""
    if isinstance(mesh, Mesh):
        return "x".join(map(str, mesh.extents)), mesh
    if mesh == "single":
        return mesh, make_host_mesh(device="meta")
    if mesh in ("pod", "multi"):
        return mesh, make_production_mesh(multi_pod=mesh == "multi",
                                          device="meta")
    raise ValueError(f"mesh {mesh!r}: one of {MESHES}")


def build_cell(arch: str, shape, mesh="single", rank: int = 0,
               n_layers: int | None = None, unroll: bool = False,
               hp: TrainHParams | None = None, overrides: dict | None = None,
               cfg_overrides: dict | None = None,
               collectives=CARD_COLLECTIVES):
    """One cell of rank ``rank`` of ``mesh`` (a ``MESHES`` name or a
    ``Mesh``) on ``meta`` tensors. Returns (cell, meta, cfg).
    ``collectives``: the (backend, device type) the rank's collectives
    run as (``dist.comm.meta_communicator``)."""
    name, mesh = _mesh(mesh)
    cfg = configs.get_config(arch)
    if cfg_overrides:
        cfg = replace(cfg, **cfg_overrides)
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    cell = _shape(shape)
    ov = dict(configs.sharding_overrides(arch, cell.mode))
    if overrides:
        ov.update(overrides)
    comm = None
    if mesh.size > 1:
        comm, log = meta_communicator(mesh.extents, rank,
                                      backend=collectives[0],
                                      device_type=collectives[1])
    else:
        rank, log = 0, []
    meta = {"arch": arch, "shape": cell.name, "mode": cell.mode,
            "batch": cell.batch, "seq": cell.seq, "mesh": name,
            "mesh_shape": mesh.shape, "n_devices": mesh.size, "rank": rank,
            "batch_argument": BATCH_ARGUMENT[cell.mode],
            "n_layers": cfg.n_layers}
    with _bound(comm):
        built = _build(cfg, cell, arch, resolve_rules(
            mesh, cfg, cell.mode, batch_size=cell.batch, overrides=ov),
            hp, unroll)
    built.comm, built.log = comm, log
    return built, meta, cfg


def _build(cfg, cell, arch, rules, hp, unroll) -> Cell:
    """The cell's step and arguments, the rank's (its communicator
    bound)."""
    batch = input_specs(cfg, cell, rules)
    if cell.mode == "train":
        if hp is None:
            arch_hp = dict(getattr(configs.get(arch), "TRAIN_HPARAMS", {}))
            hp = TrainHParams(remat=True, **arch_hp)
        hp = replace(hp, unroll=unroll)
        state = abstract_train_state(cfg, hp, rules)
        return Cell(make_train_step(cfg, rules, hp), (state, batch))
    params = M.abstract_params(cfg, rules)
    if cell.mode == "prefill":
        def fn(p, b):
            return M.prefill(p, b, cfg, rules, unroll=unroll)
        return Cell(fn, (params, batch))
    # decode / long_decode
    cache = M.init_cache(cfg, cell.batch, cell.seq, rules, device="meta")
    key = "embeddings" if cfg.input_mode == "embeddings" else "tokens"
    # the newest position: every cache slot is read. Attention reads the
    # position (rope, the cache write); SSM layers do not
    reads_pos = any(s.attn in ("full", "swa") for s in cfg.pattern)
    return Cell(make_serve_step(cfg, rules, unroll=unroll),
                (params, cache, batch[key], cell.seq - 1),
                POS_BYTES if reads_pos else 0)


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
    nothing is subtracted), fit against one card's 80 GB; the largest
    storages live at the peak; and the rank's collectives
    (``collectives``: ``Communicator.counters``' calls and bytes of each
    kind; none on one rank)."""
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
    rec["collectives"] = log_counters(cell.log)
    del out
    return rec


def wire_of(log, n_devices: int) -> dict:
    """``roofline.collective_wire`` of a ``meta_communicator`` log: each
    collective's result bytes from the bytes it logged (an all-gather's
    part times the group, a reduce-scatter's operand over it)."""
    result = {"all_gather": lambda b, g: b * g,
              "reduce_scatter": lambda b, g: b / g}
    return RL.collective_wire(
        ((kind, result.get(kind, lambda b, g: b)(nbytes, group), group)
         for kind, nbytes, group in log), n_devices)


def cost_info(cell: Cell, n_devices: int = 1) -> dict:
    """Run ``cell`` under ``CostCounter``: FLOPs, bytes and the
    collectives' wire bytes (none on one rank)."""
    with CostCounter() as cc:
        out = cell.run()
    del out
    return {"flops": cc.flops, "bytes": cc.bytes,
            "kernels": {k: list(v) for k, v in cc.kernels.items()},
            "wire": wire_of(cell.log, n_devices)}


def _extrap(v1: float, v2: float, reps: int) -> float:
    return v1 + (reps - 1) * (v2 - v1)


def run_cell(arch: str, shape, mesh="single", rank: int = 0,
             do_roofline: bool = True, hp: TrainHParams | None = None,
             overrides: dict | None = None, tag: str = "",
             cfg_overrides: dict | None = None,
             collectives=CARD_COLLECTIVES) -> dict:
    """Rank ``rank``'s record of one cell on ``mesh`` (a ``MESHES`` name
    or a ``Mesh``): its memory, collectives and their wire bytes
    (``cost.wire_per_dev``, by kind with counts) at full depth and, with
    ``do_roofline`` (not on ``multi``, as in the reference), its FLOPs
    and bytes extrapolated from 1x and 2x the pattern period and the
    roofline terms. A long_500k cell of a config with pure full attention is
    skipped, as the reference skips it."""
    name = _mesh(mesh)[0]
    cell_shape = _shape(shape)
    rec: dict = {"arch": arch, "shape": cell_shape.name, "mesh": name,
                 "rank": rank, "tag": tag, "ok": False}
    if cell_shape.mode == "long_decode" and not configs.long_context_ok(arch):
        rec.update(ok=True, skipped=True,
                   reason="pure full attention: long_500k skipped per "
                          "assignment (see DESIGN.md Arch-applicability)")
        return rec
    kw = dict(hp=hp, overrides=overrides, cfg_overrides=cfg_overrides,
              collectives=collectives)
    t0 = time.perf_counter()
    cell, meta, cfg = build_cell(arch, cell_shape, mesh, rank, **kw)
    t1 = time.perf_counter()
    rec.update(meta)
    rec["memory"] = memory_info(cell)
    t2 = time.perf_counter()
    rec["collectives"] = rec["memory"].pop("collectives")
    # the wire of every collective at full depth: exact, as logged
    rec["cost"] = {"wire_per_dev": wire_of(cell.log, meta["n_devices"])}
    rec["dryrun_s"] = {"build": t1 - t0, "memory": t2 - t1}
    where = f"{name} rank {meta['rank']} of {meta['n_devices']}"
    print(f"[{arch} x {cell_shape.name} x {where}] traced on meta "
          f"({t2 - t1:.1f}s); memory:")
    print("  " + json.dumps({k: v for k, v in rec["memory"].items()
                             if k != "largest_at_peak"}))

    if do_roofline and name != "multi":
        period = cfg.period
        infos = []
        for mult in (1, 2):
            co, me, _ = build_cell(arch, cell_shape, mesh, rank,
                                   n_layers=mult * period, unroll=True, **kw)
            infos.append(cost_info(co, me["n_devices"]))
        reps = cfg.n_layers // period
        flops = _extrap(infos[0]["flops"], infos[1]["flops"], reps)
        nbytes = _extrap(infos[0]["bytes"], infos[1]["bytes"], reps)
        wire = rec["cost"]["wire_per_dev"]
        counts = {k: [infos[0]["wire"]["counts"][k],
                      infos[1]["wire"]["counts"][k]]
                  for k in infos[0]["wire"]["counts"]}
        rec["unrolled_cost"] = {"g": infos[0], "2g": infos[1]}
        rec["cost"].update(flops_per_dev=flops, bytes_per_dev=nbytes,
                           collective_counts_g_2g=counts)
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
    ap.add_argument("--mesh", choices=list(MESHES) + ["both"],
                    default="single")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the pod or multi mesh to trace")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--out-dir", default="results/dryrun")
    args = ap.parse_args(argv)

    meshes = ["pod", "multi"] if args.mesh == "both" else [args.mesh]
    cells = cell_list() if args.all else [(args.arch, args.shape)]
    os.makedirs(args.out_dir, exist_ok=True)
    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            out = args.out or os.path.join(
                args.out_dir, f"{configs.ALIASES.get(arch, arch)}"
                f"__{shape}__{mk}.json")
            try:
                rec = run_cell(arch, shape, mk, args.rank,
                               do_roofline=not args.no_roofline)
            except Exception as e:               # record, keep sweeping
                failures += 1
                rec = {"arch": arch, "shape": shape, "mesh": mk,
                       "rank": args.rank, "ok": False, "error": repr(e),
                       "traceback": traceback.format_exc()}
                print(f"[{arch} x {shape} x {mk}] FAILED: {e!r}")
            with open(out, "w") as f:
                json.dump(rec, f, indent=1)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
