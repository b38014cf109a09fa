"""Float64 prefix sum in index order, the cumulative weights of the
weighted SFC bootstrap, with its plain PyTorch version.

The reference computes them on the host with ``np.cumsum``
(``repro/core/sfc.py``, ``sfc_initial_centers``); there is no TPU kernel
for this step. The kernel is ``csrc/scan.cu``: it adds in index order,
one rounding per addition, so its sums equal numpy's bit for bit and
never change from run to run. Its header says what bounds it.

Dispatch: a CPU tensor goes to the plain version (``torch.cumsum``, which
also adds in index order on the CPU), a CUDA tensor to the kernel, with
no fallback. ``prefix_sum.launches`` counts kernel launches and
``prefix_sum_plain.calls`` plain calls.
"""
from __future__ import annotations

import torch


def prefix_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``prefix_sum``."""
    prefix_sum_plain.calls += 1
    return torch.cumsum(x, dim=0)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D float64 tensor, added in index order
    (equal to ``np.cumsum``)."""
    if x.dim() != 1 or x.dtype != torch.float64:
        raise ValueError(f"prefix_sum takes a 1-D float64 tensor, got "
                         f"{x.dtype} of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return prefix_sum_plain(x)
    from .build import load_library
    x = x.contiguous()
    out = torch.empty_like(x)
    load_library("scan").call(
        "repro_prefix_sum_f64", x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    prefix_sum.launches += 1
    return out


def add_chain(v: float, n: int, device) -> torch.Tensor:
    """``n`` dependent float64 additions of ``v`` on one thread of the card
    (``csrc/scan.cu`` ``add_chain``): a float64 [1] tensor equal to
    ``np.cumsum(np.full(n, v))[-1]``. Its time is the latency bound of
    ``prefix_sum``; it is on no path and is not counted."""
    from .build import load_library
    out = torch.empty(1, dtype=torch.float64, device=device)
    load_library("scan").call(
        "repro_f64_add_chain", out.data_ptr(), float(v), int(n),
        torch.cuda.current_stream(out.device).cuda_stream)
    return out


prefix_sum.launches = 0
prefix_sum_plain.calls = 0
