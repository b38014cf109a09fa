"""``{"kind": "grid_triangulation", "nx": X, "ny": Y, "jitter": J}``: the
2-D FEM triangle mesh of ``reference/meshes.py``; its graph (CSR) is made
once, each call draws new jitter of the coordinates."""
import torch

from portbench.reference import meshes

KEYS = ("nx", "ny", "jitter")


def size(spec: dict) -> tuple:
    return spec["nx"] * spec["ny"], 2


def points(spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    return meshes.grid_points(spec["nx"], spec["ny"], spec["jitter"], gen,
                              device)


def graph(spec: dict, device):
    return meshes.grid_csr(spec["nx"], spec["ny"], device)


def cut(spec: dict, size: int) -> dict:
    """The spec on a ``size`` x ``size`` grid, for a toy run."""
    return dict(spec, nx=size, ny=size)
