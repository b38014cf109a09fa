"""Hand-written CUDA MoE router (balanced-k-means top-k) and its plain
PyTorch version.

Counterpart of ``repro/kernels/moe_router_kernel.py``: the TPU kernel it
replaces is ``_router_kernel`` (``router_topk_pallas``). The CUDA source is
``csrc/router.cu``; its header says what bounds the kernel on the H100 and
what the design does about it.

Contract: ``x [T, D]`` bfloat16 or float32 (read as it is: no float32 copy
is made), ``centroids [E, D]`` float32, ``inv2 [E]`` float32, ``top_k <=
min(KMAX, E)``. Returns ``(idx [T, top_k] int32, eff [T, top_k]
float32)``: the ``top_k`` smallest effective squared distances ``max(|x|^2 + |c|^2 - 2 x.c, 0) * inv2``, ascending, the lower
expert index first on ties. Unlike the TPU kernel, neither axis needs
padding to a tile: the kernel masks a ragged last tile of each itself.

The kernel multiplies by ``inv2 = 1 / influence^2``; the reference model
divides by ``influence^2``. The two agree bit for bit only where influence
is 1, as on the serving paths.

Dispatch: a CPU tensor goes to the plain version, a CUDA tensor to the
kernel, with no fallback. ``router_topk_cuda.launches`` counts kernel
launches and ``router_topk_plain.calls`` plain calls.
"""
from __future__ import annotations

import torch

FAR = 1e30
KMAX = 32       # the largest top_k the kernel keeps


def router_topk_plain(x, centroids, inv2, top_k: int):
    """Plain version of ``router_topk_cuda``: the dense oracle
    ``ref.router_topk_ref``."""
    from .ref import router_topk_ref
    router_topk_plain.calls += 1
    return router_topk_ref(x, centroids, inv2, top_k)


router_topk_plain.calls = 0


def _check_inputs(x, centroids, inv2, top_k: int) -> None:
    T, D = x.shape
    E = centroids.shape[0]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"router_topk_cuda: x must be bfloat16 or float32, "
                         f"got {x.dtype}")
    for name, t in (("centroids", centroids), ("inv2", inv2)):
        if t.dtype != torch.float32:
            raise ValueError(f"router_topk_cuda: {name} must be float32, "
                             f"got {t.dtype}")
    for t in (x, centroids, inv2):
        if t.device != x.device:
            raise ValueError(f"router_topk_cuda: all inputs must be on "
                             f"{x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("router_topk_cuda: inputs must be contiguous")
    if centroids.shape != (E, D) or inv2.shape != (E,):
        raise ValueError(f"router_topk_cuda: centroids "
                         f"{tuple(centroids.shape)} / inv2 "
                         f"{tuple(inv2.shape)} do not match D={D}")
    if not 1 <= top_k <= min(KMAX, E):
        raise ValueError(f"router_topk_cuda: top_k={top_k} outside "
                         f"[1, min({KMAX}, E={E})]")


def router_topk_cuda(x, centroids, inv2, top_k: int):
    """Top-k experts of every token. Replaces ``router_topk_pallas``."""
    if x.device.type == "cpu":
        return router_topk_plain(x, centroids, inv2, top_k)
    from .build import load_library
    _check_inputs(x, centroids, inv2, top_k)
    T, D = x.shape
    E = centroids.shape[0]
    idx = torch.empty(T, top_k, dtype=torch.int32, device=x.device)
    eff = torch.empty(T, top_k, dtype=torch.float32, device=x.device)
    load_library("router").call(
        "repro_router_topk", x.data_ptr(), centroids.data_ptr(),
        inv2.data_ptr(), int(x.dtype == torch.bfloat16), T,
        E, D, E, top_k, idx.data_ptr(),
        eff.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    router_topk_cuda.launches += 1
    return idx, eff


router_topk_cuda.launches = 0
