"""The language-model kernels on the card against their plain versions.

Marked ``cuda``: they need a CUDA device and skip without one (this file
imports neither JAX nor the JAX package, so it runs on a machine with
PyTorch alone). Run on the card with
``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` holds the kernels at the serving path's shapes.

Tolerances: flash attention 2e-5 absolute in float32 (the CUDA-core
kernel); in bfloat16 (the tensor-core kernel) the per-row relative error
of ``ref.row_relative_error`` within ``FLASH_BF16_ROW_TOL``, the limit
chip_smoke.py holds it to (set from the kernel's and SDPA's measured
errors, PERF.md); the router's effective distances 1e-4 (those of
tests/test_kernels_flash_router.py), with every index held against the
plain version's dense [T, E] distances: distinct experts, each named
expert's distance, the stable order except at a tie.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_router_kernel as mr
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (router_eff_ref, router_topk_disagreements,
                                     row_relative_error)


@pytest.fixture
def cuda_device():
    """The card; the tests that ask for it skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


FLASH_BF16_ROW_TOL = 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh", [(torch.float32, 64),
                                      (torch.float32, 256)] +
                         [(torch.bfloat16, dh) for dh in fa.HEAD_DIMS])
def test_flash_kernel_matches_plain(cuda_device, dtype, dh):
    """GQA 4:1 with a ragged last tile and a softcap, B = 2: float32 on
    the CUDA-core kernel, bfloat16 on the tensor-core kernel."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.tensor(rng.standard_normal((2, 300, n, dh)),
                            dtype=torch.float32, device=cuda_device).to(dtype)
               for n in (8, 2, 2))
    ops.reset_launch_counts()
    got = fa.flash_attention_cuda(q, k, v, softcap=30.0)
    want = fa.flash_attention_plain(q, k, v, softcap=30.0)
    torch.cuda.synchronize()
    kernel = "flash_attention_tc" if dtype == torch.bfloat16 \
        else "flash_attention"
    assert ops.launch_counts()[kernel] == 1
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert row_relative_error(got, want) <= FLASH_BF16_ROW_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T,dtype", [(4, torch.bfloat16),
                                     (300, torch.float32)])
def test_router_kernel_matches_plain(cuda_device, T, dtype):
    """granite's router width: decode (T=4, bf16 tokens) and a ragged
    token tile (float32 tokens) with random influence."""
    rng = np.random.default_rng(T)
    x = torch.tensor(rng.standard_normal((T, 1536)), dtype=torch.float32,
                     device=cuda_device).to(dtype)
    c = torch.tensor(rng.standard_normal((40, 1536)) / 1536 ** 0.5,
                     dtype=torch.float32, device=cuda_device)
    infl = torch.tensor(rng.uniform(0.5, 2.0, 40), dtype=torch.float32,
                        device=cuda_device)
    idx, eff = ops.router_topk(x, c, infl, top_k=8)
    inv2 = 1.0 / (infl * infl)
    _, peff = mr.router_topk_plain(x, c, inv2, 8)
    full = router_eff_ref(x, c, inv2)
    torch.cuda.synchronize()
    torch.testing.assert_close(eff, peff, rtol=1e-4, atol=1e-4)
    assert router_topk_disagreements(idx, eff, full, rtol=1e-4,
                                     atol=1e-4) == []
