"""Where the port's entry points run: on the card unless the caller asks
for another device."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``. Raises when
    a CUDA device is asked for (or defaulted to) and none is present:
    nothing carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev


def on_card(dev: torch.device):
    """A context with ``dev`` as the current CUDA device (a rank's kernels
    launch on its own card); a no-op for other devices."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()
