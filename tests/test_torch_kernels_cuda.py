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
expert's distance, the stable order except at a tie. The router is held in
its three modes on both sides of its T threshold (decode form at T <= 32,
tiled above), two launches must give the same bits, and on planted
near-ties (integer-valued inputs, exact dot products) its divide form
must equal the reference's arithmetic bit for bit. The pruned sweep
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
from repro_torch.kernels.ref import (router_eff_div_ref, router_eff_ref,
                                     router_near_tie_case,
                                     router_topk_disagreements,
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
                                      (torch.float32, 96),
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


def _router_mode(mode, x, c, infl, K):
    """(kernel result, plain result, dense distances) in one mode."""
    if mode == "multiply":
        inv2 = 1.0 / (infl * infl)
        return (mr.router_topk_cuda(x, c, inv2, K),
                mr.router_topk_plain(x, c, inv2, K),
                router_eff_ref(x, c, inv2))
    i = infl if mode == "divide" else None
    return (mr.router_topk_divide_cuda(x, c, i, K),
            mr.router_topk_divide_plain(x, c, i, K),
            router_eff_div_ref(x, c, i))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["unit", "multiply", "divide"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 4, 31, 33, 48, 4096, 4100])
def test_router_forms_match_plain(cuda_device, T, dtype, mode):
    """granite's widths (E = 40, D = 1536, top-8) in every mode, on both
    sides of the kernel's T threshold; a second launch gives the same
    bits."""
    rng = np.random.default_rng(T)
    x = torch.tensor(rng.standard_normal((T, 1536)), dtype=torch.float32,
                     device=cuda_device).to(dtype)
    c = torch.tensor(rng.standard_normal((40, 1536)) / 1536 ** 0.5,
                     dtype=torch.float32, device=cuda_device)
    infl = torch.tensor(rng.uniform(0.5, 2.0, 40), dtype=torch.float32,
                        device=cuda_device)
    (idx, eff), (_, peff), full = _router_mode(mode, x, c, infl, 8)
    again = _router_mode(mode, x, c, infl, 8)[0]
    torch.cuda.synchronize()
    assert torch.equal(idx, again[0])
    assert torch.equal(eff.view(torch.int32), again[1].view(torch.int32))
    torch.testing.assert_close(eff, peff, rtol=1e-4, atol=1e-4)
    assert router_topk_disagreements(idx, eff, full, rtol=1e-4,
                                     atol=1e-4) == []


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,dtype", [(100, 30, torch.float32),
                                       (100, 100, torch.bfloat16),
                                       (5, 30, torch.bfloat16)])
def test_router_unaligned_widths_match_plain(cuda_device, T, D, dtype):
    """D off the 16-byte copies: the tiled form stages synchronously."""
    rng = np.random.default_rng(D)
    x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32,
                     device=cuda_device).to(dtype)
    c = torch.tensor(rng.standard_normal((24, D)) / D ** 0.5,
                     dtype=torch.float32, device=cuda_device)
    infl = torch.tensor(rng.uniform(0.5, 2.0, 24), dtype=torch.float32,
                        device=cuda_device)
    for mode in ("unit", "multiply", "divide"):
        (idx, eff), (_, peff), full = _router_mode(mode, x, c, infl, 4)
        torch.cuda.synchronize()
        torch.testing.assert_close(eff, peff, rtol=1e-4, atol=1e-4)
        assert router_topk_disagreements(idx, eff, full, rtol=1e-4,
                                         atol=1e-4) == []


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 48, 4096])
@pytest.mark.parametrize("K", [2, 8])
def test_router_divide_form_at_planted_near_ties(cuda_device, T, K):
    """Integer-valued tokens and centroids with planted near-ties
    (ref.router_near_tie_case): the divide form equals the plain divide's
    arithmetic bit for bit in idx and eff; the multiply form ranks every
    planted pair the other way."""
    x, c, infl = (torch.from_numpy(a).to(cuda_device)
                  for a in router_near_tie_case(T, 40, 1536, seed=T + K))
    idx, eff = mr.router_topk_divide_cuda(x.bfloat16(), c, infl, K)
    pidx, peff = mr.router_topk_divide_plain(x, c, infl, K)
    midx, _ = mr.router_topk_cuda(x, c, 1.0 / (infl * infl), K)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx)
    assert torch.equal(eff.view(torch.int32), peff.view(torch.int32))
    assert bool((midx[:, 1] != pidx[:, 1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 4096])
def test_router_exact_ties_keep_the_lower_expert(cuda_device, T):
    """Every centroid twice: the twins tie exactly, and indices rise
    across every exact tie (distinct experts can tie too: at |x|^2 ~ D the
    distances are coarse)."""
    rng = np.random.default_rng(T)
    x = torch.tensor(rng.standard_normal((T, 1536)), dtype=torch.bfloat16,
                     device=cuda_device)
    c = torch.tensor(rng.standard_normal((20, 1536)) / 1536 ** 0.5,
                     dtype=torch.float32, device=cuda_device)
    idx, eff = mr.router_topk_divide_cuda(x, torch.cat([c, c]), None, 8)
    torch.cuda.synchronize()
    assert torch.equal(eff[:, 0::2], eff[:, 1::2])
    tie = eff[:, 1:] == eff[:, :-1]
    assert bool((idx[:, 1:] > idx[:, :-1])[tie].all())
    assert bool((idx[:, 0] < 20).all())


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


# ---------------------------------------------------------------------------
# the batched, warm and served paths on the card: the same bit-equalities
# the CPU tests hold, with the assign kernel in every sweep
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_batched_equals_sequential_on_card(cuda_device):
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.sfc import sfc_initial_centers
    from repro_torch.partition import (batched_balanced_kmeans,
                                       sequential_balanced_kmeans)
    rng = np.random.default_rng(12)
    real, n, k = 3000, 4096, 16
    pts = rng.uniform(0, 1, (3, real, 3))[:, np.arange(n) % real]
    w = np.where(np.arange(n) < real, rng.uniform(1, 2, (3, n)), 0.0)
    c0 = np.stack([sfc_initial_centers(p[:real], k) for p in pts])
    ops.reset_launch_counts()
    a = batched_balanced_kmeans(pts, w, c0, BKMConfig(k=k),
                                device=cuda_device)
    assert ops.launch_counts()["assign_reduce"] > 0
    b = sequential_balanced_kmeans(pts, w, c0, BKMConfig(k=k),
                                   device=cuda_device)
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x, y)
    assert torch.equal(a[3]["iters"], b[3]["iters"])
    # a padded duplicate takes its source's label
    src = np.arange(n) % real
    assert torch.equal(a[0], a[0][:, torch.from_numpy(src).to(cuda_device)])


@pytest.mark.cuda
def test_server_equals_partition_and_repartition_on_card(cuda_device):
    from repro_torch.partition import (PartitionProblem, partition,
                                       repartition)
    from repro_torch.serve import PartitionRequest, PartitionServer
    pts = np.random.default_rng(13).uniform(0, 1, (2048, 2))
    w = 1.0 + 6 * np.exp(-np.sum((pts - 0.3) ** 2, axis=1) / 0.03)
    server = PartitionServer(tiers=(2048,), slots=2, device=cuda_device)
    [r0] = server.serve([PartitionRequest(tenant=0, points=pts, k=16,
                                          seed=13)])
    [r1] = server.serve([PartitionRequest(tenant=0, points=pts, k=16,
                                          weights=w, seed=13)])
    prob = PartitionProblem(points=pts, k=16, seed=13)
    prev = partition(prob, device=cuda_device)
    ref = repartition(prob.replace(weights=w), prev, device=cuda_device)
    np.testing.assert_array_equal(r0.labels, prev.labels)
    assert r1.warm
    np.testing.assert_array_equal(r1.labels, ref.labels)
    assert r1.iters == ref.stats["iters"]


@pytest.mark.cuda
def test_scan_semantics_equals_host_loop_on_card(cuda_device):
    from repro_torch.core.balanced_kmeans import BKMConfig
    from repro_torch.core.meshes import DriftingHotspot
    from repro_torch.core.timeseries import (simulate_loadbalance,
                                             simulate_loadbalance_scan)
    from repro_torch.partition import PartitionProblem, partition
    from repro_torch.partition.repartition import WARM_DELTA_TOL
    pts = np.random.default_rng(14).uniform(0, 1, (20000, 2))
    prob = PartitionProblem(points=pts, k=32, seed=14)
    wl = DriftingHotspot()
    host = simulate_loadbalance(prob, wl, steps=3, device=cuda_device)
    w0 = wl.weights_at(torch.from_numpy(pts).to(cuda_device), 0)
    prev = partition(prob.replace(weights=w0.cpu().numpy()),
                     device=cuda_device)
    perm = np.random.default_rng(14).permutation(prob.n)
    _, recs = simulate_loadbalance_scan(
        pts[perm], prev.centers, prev.influence, prev.labels[perm], wl, 3,
        BKMConfig(k=32, warmup=False, delta_tol=WARM_DELTA_TOL),
        device=cuda_device)
    assert recs["iters"].tolist() == [r["iters"] for r in host["per_step"]]
    np.testing.assert_allclose(
        recs["migration_fraction"].numpy(),
        [r["migration_fraction"] for r in host["per_step"]], rtol=1e-5,
        atol=1e-7)


# ---------------------------------------------------------------------------
# label-propagation refinement: the sparse rounds on the card against the
# dense plain version on the card and the rounds on the CPU, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_refinement_rounds_on_card_equal_plain(cuda_device, weighted):
    from repro_torch.core import meshes
    from repro_torch.partition import PartitionProblem, partition, refine
    from repro_torch.partition.refine import (DEFAULT_MAX_ROUNDS,
                                              _canonicalize, _lp_rounds,
                                              _lp_rounds_plain, _node_keys,
                                              refinement_quantization)
    mesh = meshes.REGISTRY["delaunay2d"](20000, seed=15)
    prob = PartitionProblem.from_mesh(mesh, k=24, seed=15)
    if weighted:
        prob = prob.replace(weights=np.random.default_rng(15).lognormal(
            0.0, 0.5, prob.n))
    rng = np.random.default_rng(16)
    for labels in (partition(prob, device=cuda_device).labels,
                   rng.integers(0, prob.k, prob.n)):
        keys = _node_keys(prob, rng.permutation(prob.n))
        iw, limit = refinement_quantization(prob)
        lc, _ = _canonicalize(np.asarray(labels, np.int64), keys, prob.k)
        args = (lc, prob.indptr, prob.indices, iw, keys, prob.k, limit,
                DEFAULT_MAX_ROUNDS)
        card = _lp_rounds(*args, device=cuda_device)
        for other in (_lp_rounds_plain(*args, device=cuda_device),
                      _lp_rounds(*args, device="cpu")):
            np.testing.assert_array_equal(card[0], other[0])
            assert card[1:] == other[1:]
        assert card[2] > 0
    out = refine(prob, labels)                  # on the card by default
    np.testing.assert_array_equal(out.labels,
                                  refine(prob, labels, device="cpu").labels)


# ---------------------------------------------------------------------------
# the multi-device path on the card: NCCL at one rank, gloo ranks sharing
# the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_partition_on_card(cuda_device, monkeypatch):
    """``devices=1`` (NCCL, one rank) equals ``partition()`` on the card
    bit for bit; ``devices=2`` on one card (two gloo ranks sharing it) is
    deterministic, balanced and, with ``warmup=False``, agrees with the
    same solve on CPU ranks within the reference's contract for sums
    taken in another order (``LABEL_AGREEMENT`` = 0.97 of
    tests/test_sharded_partition.py). On this instance the card and the
    CPU agree on 0.9957 single-device and 0.9898 at ``devices=2``
    (tools/sharded_agreement.py, PERF.md)."""
    from repro_torch.dist import launch
    from repro_torch.partition import PartitionProblem, partition
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", 600.0)
    pts = np.random.default_rng(21).uniform(0.0, 1.0, (1 << 16, 3))
    prob = PartitionProblem(points=pts, k=64, seed=21)
    single = partition(prob, device=cuda_device)
    one = partition(prob, devices=1)
    assert one.stats["backend"] == "nccl"
    np.testing.assert_array_equal(one.labels, single.labels)
    np.testing.assert_array_equal(one.centers, single.centers)
    np.testing.assert_array_equal(one.influence, single.influence)
    two = partition(prob, devices=2, warmup=False)
    assert two.stats["backend"] == launch.choose_backend("cuda", 2)
    again = partition(prob, devices=2, warmup=False)
    np.testing.assert_array_equal(two.labels, again.labels)
    cpu = launch.launch(partition, 2, args=(prob,),
                        kwargs={"device": "cpu", "devices": 2,
                                "warmup": False},
                        device="cpu", threads=True, timeout=600)
    assert float(np.mean(two.labels == cpu.labels)) >= 0.97
    assert two.imbalance() <= prob.epsilon + 1e-6
