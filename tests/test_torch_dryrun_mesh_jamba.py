"""The per-rank dry run's argument bytes against the reference's for
jamba's SMOKE train cell on ``(2, 2, 2)`` of the 8 virtual CPU devices,
the one case whose reference compile takes ~40 s (the others:
tests/test_torch_dryrun_mesh_arguments.py; set-up:
tests/dryrun_mesh_cases.py)."""
from dryrun_mesh_cases import SMOKE_CELLS, check_cell


def test_jamba_train_argument_bytes_equal_reference_on_pod_mesh():
    check_cell("jamba_1p5_large_398b", SMOKE_CELLS[0], (2, 2, 2))
