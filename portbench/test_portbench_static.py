"""CPU tests of the benchmark's pieces that need no run: BENCHMARK.json
against the files it names, the imports of the harness and of its
reference, the frozen byte count, the frozen mesh generator, and the
plain label propagation against the program's."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import assign as ref_assign
from portbench.reference import label_prop, meshes, roofline
from portbench.spec import benchmark, load

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return sorted(p for p in (HERE / sub).rglob("*.py")
                  if not p.name.startswith("test_"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_jax_package(path):
    """Whole top-level names: ``repro_torch`` is not ``repro``."""
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"repro_torch", "jax", "repro"}


def _names_its_files(bench: dict) -> None:
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert w["config"] in configs
        mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (HERE / "kinds" / f"{mix['kind']}.py").is_file()
        reported = {n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
    for m in bench["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_benchmark_json_names_its_files():
    _names_its_files(BENCH)


def test_held_cells_name_their_files_and_stay_out():
    """A held cell's entries name files that are there, and a benchmark
    run refuses the cell: only the CPU tests and the readings run it."""
    _names_its_files(benchmark(ROOT, held=True))
    held = [json.loads(p.read_text()) for p in (HERE / "held").glob("*.json")]
    assert held
    cells = {w["name"] for w in BENCH["workloads"]}
    for entry in held:
        for w in entry["workloads"]:
            assert w["name"] not in cells
            with pytest.raises(KeyError):
                load(ROOT, w["name"])
            assert load(ROOT, w["name"], held=True).name == w["name"]


def test_sweep_bytes_by_hand():
    # n=1024, d=3, k=16: points 12288 + weights 4096 + centers 192 +
    # influence 64 in; labels 4096 + best and second 8192 + moments 320 out
    assert roofline.sweep_bytes(1024, 3, 16) == 29248
    share = roofline.bw_share(1024, 3, 16, 10, 292480 / 3.35e12 * 4,
                              "NVIDIA H100 80GB HBM3")
    assert share == pytest.approx(25.0)
    assert roofline.bw_share(1024, 3, 16, 10, 1.0, "unknown") is None


@pytest.mark.parametrize("nx,ny", [(7, 5), (16, 16)])
def test_grid_csr_is_the_frozen_generator(nx, ny):
    pts, indptr, indices = meshes.grid_triangulation(nx, ny)
    ip, ix = meshes.grid_csr(nx, ny, torch.device("cpu"))
    assert np.array_equal(ip.numpy(), indptr)
    assert np.array_equal(ix.numpy(), indices)
    gen = torch.Generator().manual_seed(3)
    moved = meshes.grid_points(nx, ny, 0.2, gen, torch.device("cpu")).numpy()
    assert np.all(np.abs(moved - pts) <= 0.2)


def test_label_prop_is_the_programs():
    """The plain rounds from the same start as the program's refiner give
    its labels, here at a size where both run on the CPU."""
    from repro_torch.partition import PartitionProblem
    from repro_torch.partition.refine import label_prop_refine
    pts, indptr, indices = meshes.grid_triangulation(40, 40, 0.2, seed=1)
    k = 16
    # 10 x 10 squares with a tenth of the nodes thrown into other blocks
    i, j = np.divmod(np.arange(pts.shape[0]), 40)
    start = i // 10 * 4 + j // 10
    rng = np.random.default_rng(0)
    noise = rng.random(start.size) < 0.1
    start[noise] = rng.integers(0, k, int(noise.sum()))
    prob = PartitionProblem(points=pts, k=k, indptr=indptr, indices=indices)
    theirs, info = label_prop_refine(prob, start, device="cpu")
    src, dst = label_prop.edges(torch.as_tensor(indptr),
                                torch.as_tensor(indices))
    mine, rounds = label_prop.refine(torch.as_tensor(start), src, dst, k,
                                     0.03)
    assert info["moves"] > 0
    assert np.array_equal(mine.numpy(), theirs)
    assert rounds == info["rounds"]
    assert label_prop.edge_cut(mine, src, dst) < label_prop.edge_cut(
        torch.as_tensor(start), src, dst)


def test_assignment_gap_reads_a_wrong_label():
    pts = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.9, 0.0]])
    centers = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    infl = np.ones(2, np.float32)
    gap, ref = ref_assign.assignment(pts, centers, infl, [0, 1, 1])
    assert gap == 0.0 and ref.tolist() == [0, 1, 1]
    gap, _ = ref_assign.assignment(pts, centers, infl, [0, 1, 0])
    assert gap > 0.1
    assert ref_assign.imbalance([0, 1, 1, 1], 2) == pytest.approx(0.5)
    assert ref_assign.migration([0, 1, 1], [0, 1, 0], [1.0, 1.0, 2.0]) == \
        pytest.approx(0.5)


def test_center_gap_reads_a_center_off_its_block():
    """Two blocks of four points at the corners of unit squares (radius
    sqrt(1/2)): centers at the blocks' means read 0, a center moved by
    half a unit reads 0.5 / sqrt(1/2); weights move the means."""
    sq = [[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]
    pts = torch.tensor(sq + [[x + 5.0, y] for x, y in sq])
    labels = [0] * 4 + [1] * 4
    centers = np.array([[0.5, 0.5], [5.5, 0.5]])
    assert ref_assign.center_gap(pts, labels, centers) == pytest.approx(0.0)
    moved = centers + [[0.5, 0.0], [0.0, 0.0]]
    assert ref_assign.center_gap(pts, labels, moved, chunk=3) == \
        pytest.approx(0.5 / np.sqrt(0.5))
    w = np.array([3.0, 1.0, 3.0, 1.0] + [1.0] * 4)
    assert ref_assign.center_gap(pts, labels, centers, w) > 0.2
