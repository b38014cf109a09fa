"""The hand-written kernels on the card against their plain versions:
the assignment sweep on the Hilbert-ordered layout, where it prunes, and
the language-model kernels.

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
expert's distance, the stable order except at a tie. The pruned sweep
must equal the same kernel with pruning off bit for bit (idx, best,
second, moments) and its plain version within the tolerances of
tests/test_kernels.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import assign_kernel as ak
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind,precision", [("uniform", "f32"),
                                            ("clustered", "f32"),
                                            ("lattice", "f32"),
                                            ("uniform", "bf16")])
def test_pruned_sweep_equals_unpruned(cuda_device, kind, precision):
    """n = 2^16 points in the layout, k = 64 SFC-picked centers (lattice
    points on the lattice: exact ties), fused sorted entry point."""
    from repro_torch.core.sfc import sfc_initial_centers
    rng = np.random.default_rng(11)
    n, k, bp = 1 << 16, 64, 1024
    if kind == "lattice":
        grid = np.stack(np.meshgrid(*[np.arange(41)] * 3), -1).reshape(-1, 3)
        pts = grid[rng.permutation(len(grid))[:n]] * 0.125
    elif kind == "clustered":
        pts = rng.uniform(0, 1, (32, 3))[rng.integers(0, 32, n)] \
            + rng.normal(0, 0.01, (n, 3))
    else:
        pts = rng.uniform(0, 1, (n, 3))
    ctr = sfc_initial_centers(pts, k)
    f = dict(dtype=torch.float32, device=cuda_device)
    p = torch.tensor(pts, **f)
    lay = ops.point_layout(p, bp)
    c = torch.tensor(ctr, **f)
    iv = torch.tensor(rng.uniform(0.8, 1.25, k) ** -2, **f)
    w = torch.tensor(rng.uniform(0.5, 2.0, n), **f)
    pairs = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    got = ak.assign_reduce_cuda(lay.points, c, iv, w, k, block_p=bp,
                                block_c=64, precision=precision,
                                order=lay.order, pairs=pairs)
    idx, best, second, part = ak.launch_sweep(
        lay.points, c, iv, w, k, 4, precision, lay.order, prune=False)
    want = ak.assign_reduce_plain(lay.points, c, iv, w, k, precision,
                                  lay.order)
    torch.cuda.synchronize()
    for a, b in zip(got, (idx, best, second, torch.sum(part, 0))):
        assert torch.equal(a, b)
    assert float((got[0] == want[0]).float().mean()) >= 0.99
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-5)
    if kind == "uniform":
        # 1024 points a center: ~46% of the pairs survive on the CPU's
        # emulation of the rule (at the main shape ~2%)
        assert int(pairs) < 0.6 * n * k
