"""Carry the JAX package's state into the port.

Plain data in, port objects out: these take dicts and numpy arrays, never
objects of the reference, so the port still imports nothing of it.

* ``bkm_config_from_reference`` turns the fields of a reference
  ``BKMConfig`` (``dataclasses.asdict`` of it, with ``dtype`` as a string
  such as ``"float32"``) into the port's ``BKMConfig``;
* ``state_from_numpy`` turns a reference result's warm-start pair
  (centers, influence) into tensors on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.balanced_kmeans import BKMConfig

#: reference assign-backend name -> the port's
BACKENDS = {"auto": "auto", "jnp": "torch", "pallas": "cuda",
            "triton": "cuda_flat"}


def bkm_config_from_reference(fields: dict) -> BKMConfig:
    """The port's ``BKMConfig`` from a reference config's fields.

    ``backend`` is renamed through ``BACKENDS``; the deprecated
    ``use_kernel=True`` means ``backend="pallas"`` in the reference and so
    ``"cuda"`` here; ``dtype`` is a numpy dtype name."""
    kw = dict(fields)
    use_kernel = kw.pop("use_kernel", False)
    backend = "pallas" if use_kernel else kw.get("backend", "auto")
    if backend not in BACKENDS:
        raise KeyError(f"reference backend {backend!r} has no counterpart; "
                       f"known: {sorted(BACKENDS)}")
    kw["backend"] = BACKENDS[backend]
    if "dtype" in kw:
        kw["dtype"] = getattr(torch, np.dtype(str(kw["dtype"])).name)
    return BKMConfig(**kw)


def state_from_numpy(centers: np.ndarray, influence: np.ndarray | None,
                     device, dtype: torch.dtype = torch.float32):
    """(centers [k, d], influence [k] or None) as tensors on ``device``."""
    c = torch.tensor(np.asarray(centers), device=device).to(dtype)
    infl = (None if influence is None else
            torch.tensor(np.asarray(influence), device=device).to(dtype))
    return c, infl
