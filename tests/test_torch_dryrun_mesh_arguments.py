"""The per-rank dry run's argument bytes against the reference's on
``(2, 4)`` and ``(2, 2, 2)`` of the 8 virtual CPU devices: every config's
SMOKE train, prefill and decode cell, rank 0 of the port against a device
of the reference, or the reference's refusal pinned beside the port's
record (tests/dryrun_mesh_cases.py). jamba's train cell on ``(2, 2, 2)``,
whose reference compile takes ~40 s, is in
tests/test_torch_dryrun_mesh_jamba.py."""
import pytest

from repro_torch import configs

from dryrun_mesh_cases import MESHES, SMOKE_CELLS, check_cell

JAMBA = "jamba_1p5_large_398b"


CASES = [(arch, cell, shape) for shape in MESHES for arch in configs.ARCHS
         for cell in SMOKE_CELLS
         if (arch, cell.mode, shape) != (JAMBA, "train", (2, 2, 2))]


@pytest.mark.parametrize("arch,cell,shape", CASES, ids=[
    f"{a}-{c.mode}-{'x'.join(map(str, s))}" for a, c, s in CASES])
def test_rank_argument_bytes_equal_reference(arch, cell, shape):
    check_cell(arch, cell, shape)
