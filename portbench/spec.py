"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. The configuration's file is the ``file`` of its ``configs`` entry;
the traffic mix is ``traffic/<traffic>.json``; each per-layer metric is
read by ``metrics/<name>.py``. The code a mix or a configuration names by
its ``"kind"`` is the module of that name in ``kinds/`` (traffic),
``pointsets/`` or ``weights/``. Adding a cell, a configuration, a mix, a
kind of any of these or a metric is adding files and entries: nothing
here changes. A cell held out of the benchmark keeps its entries in
``held/<cell>.json``, which the CPU tests and ``portbench.readings`` read
and a benchmark run does not.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class CellSpec:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str, cell_e2e: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return cell_e2e is None or metric["moves"] in cell_e2e


def benchmark(root: Path, held: bool = False) -> dict:
    """``root/BENCHMARK.json``; with ``held``, joined by the entries of
    each cell held out of it (``held/<cell>.json``: the configurations,
    workloads and metrics that the cell would add back), for the CPU
    tests and the readings. A benchmark run never runs a held cell."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if held:
        for path in sorted((HERE / "held").glob("*.json")):
            extra = json.loads(path.read_text())
            for key in ("configs", "workloads", "end_to_end", "per_layer"):
                have = {e["name"] for e in bench[key]}
                bench[key] += [e for e in extra.get(key, [])
                               if e["name"] not in have]
    return bench


def load(root: Path, cell: str, held: bool = False) -> CellSpec:
    """The cell ``cell`` of ``root/BENCHMARK.json`` (with ``held``, also
    of ``held/``) with its files read."""
    bench = benchmark(root, held)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, cell, names)]
    return CellSpec(cell, w["chips"], config, traffic, e2e, per_layer)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def plugin(package: str, kind: str):
    """The module ``portbench.<package>.<kind>`` (``kinds``,
    ``pointsets`` or ``weights``), with its ``KEYS`` held against
    ``params``'s keys by ``refuse_unread``."""
    if not kind.isidentifier():
        raise ValueError(f"{package} kind {kind!r} is no module name")
    if not (HERE / package / f"{kind}.py").is_file():
        raise ValueError(f"unknown {package} kind {kind!r}: no "
                         f"{package}/{kind}.py")
    return importlib.import_module(f"portbench.{package}.{kind}")


def refuse_unread(what: str, params: dict, read) -> None:
    """Raise where ``params`` holds a key that nothing reads: a
    configuration that states what no code acts on would run otherwise
    than it says."""
    extra = sorted(set(params) - set(read))
    if extra:
        raise ValueError(f"{what}: no code reads {extra}")
