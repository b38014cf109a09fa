"""The training mesh (reference: ``repro/launch/mesh.py``).

The reference lays a ``(data, model)`` mesh over its devices. The port
trains on one rank: a ``Mesh`` names its axes and their extents and
holds the rank's device, and ``make_host_mesh`` makes the one-rank
``(1, 1)`` mesh. Data- and tensor-parallel training over ranks (an
extent above 1) needs a gradient all-reduce and an all-reduce of the
balanced-k-means router's expert loads, which the port does not have yet
(ROADMAP.md queue 1 item 4.9).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names, their extents (``shape``: name -> extent, as the
    reference's ``Mesh.shape``) and the device of this rank."""
    axis_names: tuple[str, ...]
    extents: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.extents))


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """The ``(data, model)`` mesh of one rank on ``device`` (default
    ``cuda``).

    Raises:
        ValueError: ``data`` or ``model`` is not 1 (training over ranks is
            ROADMAP.md queue 1 item 4.9).
    """
    if (int(data), int(model)) != (1, 1):
        raise ValueError(
            f"a ({data}, {model}) mesh needs data- or tensor-parallel "
            f"training over ranks, which the port does not have yet "
            f"(ROADMAP.md queue 1 item 4.9); use data=1, model=1")
    return Mesh(("data", "model"), (1, 1), resolve_device(device))
