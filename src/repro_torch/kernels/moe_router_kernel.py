"""Hand-written CUDA MoE router (balanced-k-means top-k) and its plain
PyTorch version.

Counterpart of ``repro/kernels/moe_router_kernel.py``: the TPU kernel it
replaces is ``_router_kernel`` (``router_topk_pallas``). The CUDA source is
``csrc/router.cu``; its header says what bounds the kernel on the H100 and
what the design does about it.

Contract: ``x [T, D]`` bfloat16 or float32 (read as it is: no float32 copy
is made), ``centroids [E, D]`` float32, ``top_k <= min(KMAX, E)``. Returns
``(idx [T, top_k] int32, eff [T, top_k] float32)``: the ``top_k`` smallest
effective squared distances, ascending, the lower expert index first on
ties. ``sq = max(|x|^2 + |c|^2 - 2 x.c, 0)`` is scaled in one of three
modes, all one kernel:

* multiply (``router_topk_cuda``): ``sq * inv2``, ``inv2 [E]`` given, the
  TPU kernel's and ``ops.router_topk``'s contract;
* divide (``router_topk_divide_cuda`` with an influence): ``sq /
  (influence * influence)``, the reference model's ``router_logits`` bit
  for bit for the same ``sq``;
* unit (``router_topk_divide_cuda`` with ``influence=None``): ``sq``
  unscaled, which the other two equal bit for bit at influence 1.

Neither axis needs padding to a tile: the kernel masks ragged tiles
itself. The kernel picks its form from T (``csrc/router.cu``): at decode
sizes its expert blocks leave their distances in a scratch buffer and the
last one to finish, counted by a ticket, ranks them. The wrapper allocates
the scratch with ``torch.empty`` and keeps one ticket a (device, stream).

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel, with no fallback; a ``meta`` tensor (the dry run's) is checked as
the kernel's inputs are and goes to ``meta.router_topk`` (outputs and
scratch of the kernel's shapes, no launch, nothing counted). ``router_topk_cuda.launches`` counts kernel
launches of every mode and ``router_topk_plain.calls`` plain calls.
"""
from __future__ import annotations

import torch

from . import meta

KMAX = 32       # the largest top_k the kernel keeps
UNIT, MULTIPLY, DIVIDE = 0, 1, 2

_TICKETS: dict = {}


def router_topk_plain(x, centroids, inv2, top_k: int):
    """Plain version of ``router_topk_cuda``: the dense oracle
    ``ref.router_topk_ref``."""
    from .ref import router_topk_ref
    router_topk_plain.calls += 1
    return router_topk_ref(x, centroids, inv2, top_k)


def router_topk_divide_plain(x, centroids, influence, top_k: int):
    """Plain version of ``router_topk_divide_cuda``: the dense oracle
    ``ref.router_topk_div_ref``."""
    from .ref import router_topk_div_ref
    router_topk_plain.calls += 1
    return router_topk_div_ref(x, centroids, influence, top_k)


router_topk_plain.calls = 0


def _check_inputs(x, centroids, scale, top_k: int) -> None:
    T, D = x.shape
    E = centroids.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"router_topk_cuda: x must be bfloat16 or float32, "
                         f"got {x.dtype}")
    named = [("centroids", centroids)] + \
        ([] if scale is None else [("scale", scale)])
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"router_topk_cuda: {name} must be float32, "
                             f"got {t.dtype}")
    for _, t in [("x", x)] + named:
        if t.device != x.device:
            raise ValueError(f"router_topk_cuda: all inputs must be on "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("router_topk_cuda: inputs must be contiguous")
    if centroids.shape != (E, D) or (scale is not None
                                     and scale.shape != (E,)):
        raise ValueError(f"router_topk_cuda: centroids "
                         f"{tuple(centroids.shape)} / scale "
                         f"{None if scale is None else tuple(scale.shape)} "
                         f"do not match D={D}")
    if not 1 <= top_k <= min(KMAX, E):
        raise ValueError(f"router_topk_cuda: top_k={top_k} outside "
                         f"[1, min({KMAX}, E={E})]")


def _ticket(stream):
    """The decode form's ticket of ``stream``: one int32, 0 between
    launches (the kernel's last block resets it)."""
    key = (stream.device_index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                        device=stream.device)
    return t


def _launch(x, centroids, scale, mode: int, top_k: int):
    from .build import load_library
    _check_inputs(x, centroids, scale, top_k)
    if x.device.type == "meta":
        return meta.router_topk(x, centroids, scale, top_k)
    T, D = x.shape
    E = centroids.shape[0]
    dev = x.device
    idx = torch.empty(T, top_k, dtype=torch.int32, device=dev)
    eff = torch.empty(T, top_k, dtype=torch.float32, device=dev)
    scratch = torch.empty(max(T, 1) * E, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    load_library("router").call(
        "repro_router_topk", x.data_ptr(), centroids.data_ptr(),
        None if scale is None else scale.data_ptr(), mode,
        int(x.dtype == torch.bfloat16), T, E, D, top_k, idx.data_ptr(),
        eff.data_ptr(), scratch.data_ptr(), _ticket(stream).data_ptr(),
        stream.cuda_stream)
    router_topk_cuda.launches += 1
    return idx, eff


def router_topk_cuda(x, centroids, inv2, top_k: int):
    """Top-k experts of every token, multiplied by ``inv2``. Replaces
    ``router_topk_pallas``."""
    if x.device.type == "cpu":
        return router_topk_plain(x, centroids, inv2, top_k)
    return _launch(x, centroids, inv2, MULTIPLY, top_k)


def router_topk_divide_cuda(x, centroids, influence, top_k: int):
    """Top-k experts of every token, divided by ``influence^2`` (``None``:
    unscaled), as the reference model's ``router_logits`` + ``top_k``."""
    if x.device.type == "cpu":
        return router_topk_divide_plain(x, centroids, influence, top_k)
    return _launch(x, centroids, influence,
                   UNIT if influence is None else DIVIDE, top_k)


router_topk_cuda.launches = 0
