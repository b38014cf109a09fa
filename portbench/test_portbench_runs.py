"""CPU runs of every cell's traffic at a toy size through the harness
(``portbench.toy``, a process each), and a throwaway cell and metric
added to a copy of the benchmark by new files and entries alone."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.spec import benchmark

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# every cell of BENCHMARK.json and of held/, each at a toy size
TOY = {"uniform3d-n16M-k1024.cold": ("8192", "16"),
       "uniform3d-n16M-k1024.drift": ("8192", "16"),
       "tri2d-n4M-k1024.refine": ("64", "8")}


def toy(cell, *args, root=ROOT, size=None):
    """(result line, loaded top-level module names) of a toy run."""
    n, k = size or TOY[cell]
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{ROOT / 'src'}")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.toy", cell, n, k, *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2]), set(json.loads(lines[-1]))


@pytest.mark.parametrize("cell", sorted(TOY))
@pytest.mark.parametrize("trace", [False, True], ids=["timed", "traced"])
def test_cell_runs_on_cpu(cell, trace):
    out, modules = toy(cell, *(["--trace"] if trace else []))
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    bench = benchmark(ROOT, held=True)
    if trace:
        assert out["device"]["window_s"] > 0
        assert "breakdown" in out
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(out["metrics"]) == want
        assert all(v["value"] > 0 for v in out["metrics"].values())
    # nothing of JAX or the JAX package, by whole top-level names
    assert not modules & FORBIDDEN
    assert "repro_torch" in modules


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric by new files and new entries; no file it had
    changes, and the new metric is read in the new cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    conf = json.loads((HERE / "configs" / "tri2d-n4M-k1024.json").read_text())
    conf["name"] = "tri2d-toy"
    (tmp_path / "portbench/configs/tri2d-toy.json").write_text(
        json.dumps(conf))
    (tmp_path / "portbench/metrics/calls.toy.py").write_text(
        "def read(record):\n    return float(len(record.calls))\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tri2d-toy", "source": "a test",
                             "file": "portbench/configs/tri2d-toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tri2d-toy.cold",
                               "config": "tri2d-toy", "traffic": "cold",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "partition_s":
            m["workloads"].append("tri2d-toy.cold")
    bench["per_layer"].append({"name": "calls.toy", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "Front door", "moves": "partition_s",
                               "workloads": ["tri2d-toy.cold"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out, _ = toy("tri2d-toy.cold", "--trace", root=tmp_path,
                 size=("48", "8"))
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["calls.toy"]["value"] >= 1
    assert set(out["checks"]) == {"assign_gap", "center_gap", "imbalance"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


KIND = """
from portbench.kinds import closed_loop
from portbench.reference import assign as ref_assign

KEYS = ("repeat",)


def setup(cell):
    cell.arrays = cell.inputs.problem_arrays(0)
    if not cell.warm:
        cell.partition(cell.problem(**cell.arrays))


def unit(cell, index):
    res, wall, sweeps = cell.partition(cell.problem(**cell.arrays))
    return [{"wall": wall, "sweeps": sweeps}], res.labels


def check(cell, labels):
    w = cell.arrays["weights"]
    return [{"imbalance": ref_assign.imbalance(labels, cell.config["k"], w)}]


def faults(traffic):
    return []
"""
POINTS = """
import torch

KEYS = ("n",)


def size(spec):
    return spec["n"], 2


def points(spec, gen, device):
    t = torch.rand(spec["n"], dtype=torch.float64, generator=gen,
                   device=device) * 6.283
    return torch.stack([torch.cos(t), torch.sin(t)], 1)


def graph(spec, device):
    return None


def cut(spec, size):
    return dict(spec, n=size)
"""
WEIGHTS = """
KEYS = ("slope",)


def weights(spec, points, t, gen):
    return (1.0 + spec["slope"] * points[:, 0]).float()
"""


def test_a_traffic_kind_and_input_kinds_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark gains a new kind of traffic (a caller that
    partitions one input again and again), of point set (a circle) and of
    weights (a ramp), with a configuration and a cell that use them, by
    new files and new entries; no file it had changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "kinds/repeat.py").write_text(KIND)
    (pb / "pointsets/circle.py").write_text(POINTS)
    (pb / "weights/ramp.py").write_text(WEIGHTS)
    (pb / "traffic/repeat.json").write_text(json.dumps({
        "kind": "repeat", "why": "a test", "metric": "partition_s",
        "repeat": True, "check": 1, "limits": {"imbalance": "epsilon"}}))
    (pb / "configs/circle.json").write_text(json.dumps({
        "name": "circle", "points": {"kind": "circle", "n": 4096},
        "weights": {"kind": "ramp", "slope": 0.5}, "k": 8,
        "epsilon": 0.03, "method": "geographer", "options": {},
        "control": {"assign_precision": "bf16"}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "circle", "source": "a test",
                             "file": "portbench/configs/circle.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "circle.repeat", "config": "circle",
                               "traffic": "repeat", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "partition_s":
            m["workloads"].append("circle.repeat")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out, _ = toy("circle.repeat", root=tmp_path, size=("4096", "8"))
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"partition_s", "setup_s"}
    assert set(out["checks"]) == {"imbalance"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("where,key", [("config", "precision"),
                                       ("points", "spacing"),
                                       ("traffic", "rate")])
def test_a_key_that_nothing_reads_is_refused(where, key):
    """A configuration or mix that states what no code acts on would run
    otherwise than it says: the cell refuses it."""
    from portbench.driver import Cell
    from portbench.spec import load
    spec = load(ROOT, "uniform3d-n16M-k1024.cold")
    target = {"config": spec.config, "points": spec.config["points"],
              "traffic": spec.traffic}[where]
    target[key] = 1
    with pytest.raises(ValueError, match=key):
        cell = Cell(spec.config, spec.traffic, "cpu")
        cell.setup(1)
