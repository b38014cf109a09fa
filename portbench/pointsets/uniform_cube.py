"""``{"kind": "uniform_cube", "n": N, "d": D}``: N points uniform in the
unit cube of D dimensions, drawn anew for every call."""
import torch

KEYS = ("n", "d")


def size(spec: dict) -> tuple:
    return spec["n"], spec["d"]


def points(spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    return torch.rand((spec["n"], spec["d"]), dtype=torch.float64,
                      generator=gen, device=device)


def graph(spec: dict, device):
    return None


def cut(spec: dict, size: int) -> dict:
    """The spec at ``size`` points, for a toy run."""
    return dict(spec, n=size)
