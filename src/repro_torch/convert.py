"""Carry the JAX package's state into the port.

Plain data in, port objects out: these take dicts and numpy arrays, never
objects of the reference, so the port still imports nothing of it.

* ``bkm_config_from_reference`` turns the fields of a reference
  ``BKMConfig`` (``dataclasses.asdict`` of it, with ``dtype`` as a string
  such as ``"float32"``) into the port's ``BKMConfig``;
* ``state_from_numpy`` turns a reference result's warm-start pair
  (centers, influence) into tensors on a device;
* ``result_from_numpy`` turns the fields of a reference
  ``PartitionResult`` or ``WarmState`` (numpy ``labels``, ``centers``,
  ``influence``) into the port's ``PartitionResult``, so that both
  packages can resume from the same previous state (the port's
  ``WarmState`` holds numpy fields as the reference's does);
* ``params_from_numpy`` turns a reference model's parameter tree (numpy
  leaves) into the port's tree of tensors;
* ``train_state_from_numpy`` turns a reference train state (params,
  ``opt``, ``influence``, ``ef``, numpy leaves) into the port's.
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


def result_from_numpy(problem, labels: np.ndarray,
                      centers: np.ndarray | None = None,
                      influence: np.ndarray | None = None,
                      method: str = "geographer"):
    """The port's ``PartitionResult`` of ``problem`` (a port
    ``PartitionProblem``) from a reference result's fields: what
    ``repartition()`` takes as ``previous``."""
    from repro_torch.partition.problem import PartitionResult
    res = PartitionResult(
        labels=np.array(labels, dtype=np.int64), k=problem.k,
        method=method, problem=problem,
        centers=None if centers is None else np.array(centers),
        influence=None if influence is None else np.array(influence))
    res.stats = {"final_imbalance": res.imbalance()}
    return res


def params_from_numpy(tree, device, dtype: torch.dtype | None = None):
    """A reference parameter tree, as nested dicts of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tree of tensors
    on ``device``: the same keys, the arrays copied, cast to ``dtype`` when
    given. bfloat16 leaves (``ml_dtypes.bfloat16``, which numpy gives for
    a jax bfloat16 array and ``torch.from_numpy`` refuses) carry their
    bits over as ``torch.bfloat16``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    a = np.array(tree, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def train_state_from_numpy(state, device):
    """A reference train state (``jax.tree.map(np.asarray, state)``:
    ``params``, ``opt`` {mu, nu, step}, and ``influence`` and ``ef`` where
    present) as the port's state dict on ``device``, every leaf in its
    own dtype (bfloat16 moments included), the step an int32 scalar."""
    opt = state["opt"]
    out = {"params": params_from_numpy(state["params"], device),
           "opt": {"mu": params_from_numpy(opt["mu"], device),
                   "nu": params_from_numpy(opt["nu"], device),
                   "step": torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32, device=device)}}
    if "influence" in state:
        out["influence"] = torch.tensor(np.asarray(state["influence"]),
                                        dtype=torch.float32, device=device)
    if "ef" in state:
        out["ef"] = params_from_numpy(state["ef"], device)
    return out
