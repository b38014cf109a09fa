"""The language-model kernels on the card against their plain versions.

Marked ``cuda``: they need a CUDA device and skip without one (this file
imports neither JAX nor the JAX package, so it runs on a machine with
PyTorch alone). Run on the card with
``python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py``;
``chip_smoke.py`` holds the kernels at the serving path's shapes.

Tolerances: flash attention 2e-5 in float32 and 2e-2 in bfloat16, the
router's effective distances 1e-4 (those of
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
from repro_torch.kernels.ref import router_eff_ref, router_topk_disagreements


@pytest.fixture
def cuda_device():
    """The card; the tests that ask for it skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [64, 256])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, dh):
    """GQA 4:1 with a ragged last tile and a softcap."""
    rng = np.random.default_rng(dh)
    q, k, v = (torch.tensor(rng.standard_normal((2, 300, n, dh)),
                            dtype=torch.float32, device=cuda_device).to(dtype)
               for n in (8, 2, 2))
    got = fa.flash_attention_cuda(q, k, v, softcap=30.0)
    want = fa.flash_attention_plain(q, k, v, softcap=30.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
