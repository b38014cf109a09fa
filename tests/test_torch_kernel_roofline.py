"""The port's assign-kernel roofline (``repro_torch.launch.kernel_roofline``)
against the reference's (``repro.launch.kernel_roofline``).

* Every test of ``tests/test_kernel_roofline.py``, as cases over both
  packages.
* Bit-equality with the reference for every platform and backend in the
  reference's ``PLATFORMS``.
* The port's own ``h100`` row and ``cuda`` / ``cuda_flat`` backends: equal
  to the bound ``chip_smoke.py`` computed before it called this module
  (the ``_former_bound`` below, kept as it was), which gives the kernel
  table's rows 1-4 (PERF.md §6).
"""
import math

import pytest

from repro.launch import kernel_roofline as REF

from repro_torch.launch import kernel_roofline as PORT

PACKAGES = {"reference": REF, "port": PORT}

# must stay in sync with tools/bench_compare.py::ROOFLINE_FIELDS
ROOFLINE_FIELDS = ("platform", "backend", "n", "d", "k", "ai", "compute_s",
                   "memory_s", "bound_s", "bottleneck", "measured_s",
                   "utilization")


@pytest.fixture(params=list(PACKAGES))
def kr(request):
    return PACKAGES[request.param]


# ---------------------------------------------------------------------------
# tests/test_kernel_roofline.py over both packages
# ---------------------------------------------------------------------------

def test_platform_table_sane(kr):
    for name, p in kr.PLATFORMS.items():
        assert p["hbm_bw"] > 0, name
        for prec in ("f32", "bf16"):
            assert p["peak_flops"][prec] > 0, (name, prec)
        # bf16 never slower than f32 on any modeled platform
        assert p["peak_flops"]["bf16"] >= p["peak_flops"]["f32"], name


def test_detect_platform_is_known(kr):
    assert kr.detect_platform() in kr.PLATFORMS


def test_intensity_positive_and_scales_with_d(kr):
    lo = kr.assign_intensity(1 << 16, 2, 64)
    hi = kr.assign_intensity(1 << 16, 128, 64)
    for block in ("distance", "moments", "total"):
        assert lo[block]["flops"] > 0
        assert lo[block]["hbm_bytes"] > 0
        assert lo[block]["ai"] > 0
    assert hi["distance"]["flops"] > lo["distance"]["flops"]
    assert hi["total"]["ai"] > lo["total"]["ai"]


def test_intensity_prune_frac_cuts_distance_flops(kr):
    base = kr.assign_intensity(1 << 18, 2, 256)
    pruned = kr.assign_intensity(1 << 18, 2, 256, prune_frac=0.5)
    assert pruned["distance"]["flops"] == pytest.approx(
        0.5 * base["distance"]["flops"])
    assert pruned["moments"]["flops"] == base["moments"]["flops"]


def test_intensity_unfused_drops_moment_block(kr):
    unfused = kr.assign_intensity(1 << 16, 2, 64, fused=False)
    assert unfused["moments"]["flops"] == 0.0
    assert unfused["moments"]["hbm_bytes"] == 0.0


def test_jnp_memory_model_has_scratch_traffic(kr):
    jnp_b = kr.assign_intensity(1 << 18, 2, 256, backend="jnp")
    pal_b = kr.assign_intensity(1 << 18, 2, 256, backend="pallas")
    assert jnp_b["total"]["hbm_bytes"] > pal_b["total"]["hbm_bytes"]
    assert jnp_b["total"]["ai"] < pal_b["total"]["ai"]


def test_predict_bottleneck_selection(kr):
    cpu = kr.predict(1 << 18, 2, 64, platform="cpu_host", backend="jnp")
    assert cpu["bottleneck"] == "memory"
    assert cpu["bound_s"] == pytest.approx(
        max(cpu["compute_s"], cpu["memory_s"]))
    for plat in kr.PLATFORMS:
        p = kr.predict(1 << 20, 2, 64, platform=plat)
        assert math.isfinite(p["bound_s"]) and p["bound_s"] > 0


def test_predict_bf16_speeds_distance_only(kr):
    f32 = kr.predict(1 << 20, 128, 256, platform="tpu_v5e", precision="f32")
    b16 = kr.predict(1 << 20, 128, 256, platform="tpu_v5e",
                     precision="bf16")
    assert b16["compute_s"] < f32["compute_s"]
    assert b16["memory_s"] == f32["memory_s"]


def test_utilization_edge_cases(kr):
    assert kr.utilization(1.0, 2.0) == pytest.approx(0.5)
    assert kr.utilization(1.0, 0.0) == 0.0
    assert kr.utilization(1.0, float("nan")) == 0.0
    assert kr.utilization(1.0, float("inf")) == 0.0


def test_record_schema_complete(kr):
    rec = kr.kernel_roofline_record(1 << 20, 2, 64, measured_s=1.0,
                                    platform="cpu_host", backend="jnp")
    for field in ROOFLINE_FIELDS:
        assert field in rec and rec[field] is not None, field
    assert 0.0 < rec["utilization"]
    rec2 = kr.kernel_roofline_record(1 << 20, 2, 64, platform="cpu_host")
    assert rec2["measured_s"] is None and rec2["utilization"] is None
    assert rec2["bound_s"] > 0


# ---------------------------------------------------------------------------
# bit-equality on the reference's platforms and backends
# ---------------------------------------------------------------------------

SHAPES = [dict(n=1 << 16, d=2, k=64), dict(n=1 << 22, d=3, k=1024),
          dict(n=100_003, d=7, k=300, block_p=512, block_c=64),
          dict(n=1 << 20, d=128, k=256, fused=False),
          dict(n=4096, d=3, k=16, prune_frac=0.9776),
          dict(n=1 << 18, d=2, k=256, prune_frac=1.5)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("backend", ["pallas", "triton", "jnp"])
@pytest.mark.parametrize("platform", list(REF.PLATFORMS))
def test_bit_equal_on_reference_platforms(platform, backend, shape):
    kw = dict(shape)
    n, d, k = kw.pop("n"), kw.pop("d"), kw.pop("k")
    kw["backend"] = backend
    assert PORT.assign_intensity(n, d, k, **kw) == \
        REF.assign_intensity(n, d, k, **kw)
    for precision in ("f32", "bf16"):
        assert PORT.predict(n, d, k, platform=platform, precision=precision,
                            **kw) == REF.predict(
            n, d, k, platform=platform, precision=precision, **kw)
        for measured in (None, 1e-3, 0.0):
            assert PORT.kernel_roofline_record(
                n, d, k, measured_s=measured, platform=platform,
                precision=precision, **kw) == REF.kernel_roofline_record(
                n, d, k, measured_s=measured, platform=platform,
                precision=precision, **kw)


def test_reference_rows_kept_and_h100_added():
    assert {k: v for k, v in PORT.PLATFORMS.items() if k != "h100"} == \
        REF.PLATFORMS
    assert PORT.PLATFORMS["h100"] == {
        "peak_flops": {"f32": 67e12, "bf16": 989e12}, "hbm_bw": 3.35e12}


def test_detect_platform_maps_cards(monkeypatch):
    import torch
    assert PORT.detect_platform() == "cpu_host"     # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, want in (("NVIDIA H100 80GB HBM3", "h100"),
                       ("NVIDIA H100 PCIe", "h100"),
                       ("NVIDIA A100-SXM4-80GB", "gpu_a100")):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0, name=name: name)
        assert PORT.detect_platform() == want
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "Some Other GPU")
    with pytest.raises(ValueError, match="no roofline peaks"):
        PORT.detect_platform()


# ---------------------------------------------------------------------------
# the port's CUDA kernel: h100 + cuda / cuda_flat
# ---------------------------------------------------------------------------

PEAK_F32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12
MAIN_N, MAIN_K, MAIN_D = 1 << 22, 1024, 3
# the launch's blocks on the H100 at the main cell: two resident blocks on
# each of its 132 SMs
H100_BLOCKS = 264


def _former_bound(n, k, d, fused, blocks, pairs=None, layout=False):
    """chip_smoke.py's ``bound`` before it called kernel_roofline:
    (ms, "operations" | "bytes")."""
    pairs = n * k if pairs is None else pairs
    flops = pairs * (2 * d + 7) + (2 * (d + 2) * n if fused else 0)
    nbytes = 4 * (n * d + k * (d + 1) + 3 * n + (n if layout else 0))
    if fused:
        nbytes += 4 * (n + blocks * (d + 2) * k)
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _bound(n, k, d, fused, blocks, pairs=None, layout=False, backend="cuda"):
    prune = 0.0 if pairs is None else 1.0 - pairs / (n * k)
    rec = PORT.kernel_roofline_record(
        n, d, k, platform="h100", backend=backend, fused=fused,
        blocks=blocks, layout=layout, prune_frac=prune)
    return (rec["bound_s"] * 1e3,
            "operations" if rec["bottleneck"] == "compute" else "bytes")


@pytest.mark.parametrize("backend", PORT.CUDA_BACKENDS)
@pytest.mark.parametrize("layout", [True, False])
@pytest.mark.parametrize("pairs", [None, 96_207_000, 0, 1 << 30])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("n,k,d,blocks", [
    (MAIN_N, MAIN_K, MAIN_D, H100_BLOCKS), (1 << 16, 64, 2, 128),
    (131_072, 64, 3, 264), (1000, 7, 5, 1)])
def test_cuda_backend_equals_former_bound(n, k, d, blocks, fused, pairs,
                                          layout, backend):
    if pairs is not None and pairs > n * k:
        pairs = n * k
    got, got_by = _bound(n, k, d, fused, blocks, pairs, layout, backend)
    want, want_by = _former_bound(n, k, d, fused, blocks, pairs, layout)
    assert got_by == want_by
    assert got == pytest.approx(want, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("fused,dense_ms,bytes_ms", [(True, 0.8340, 0.0417),
                                                      (False, 0.8334,
                                                       0.0351)])
def test_cuda_backend_gives_the_kernel_table_rows(fused, dense_ms, bytes_ms):
    """Rows 1-4 of PERF.md §6: the dense bound (every pair) and the bound
    of the work done at the main state (97.76% of the pairs skipped),
    in the layout."""
    dense, by = _bound(MAIN_N, MAIN_K, MAIN_D, fused, H100_BLOCKS,
                       layout=True)
    assert (round(dense, 4), by) == (dense_ms, "operations")
    done = int(MAIN_N * MAIN_K * (1 - 0.9776))
    pruned, by = _bound(MAIN_N, MAIN_K, MAIN_D, fused, H100_BLOCKS, done,
                        layout=True)
    assert (round(pruned, 4), by) == (bytes_ms, "bytes")


def test_cuda_backend_counts_pairs_not_tiles():
    """The CUDA model counts 2d+7 operations a pair computed and 2(d+2) a
    point for the moments; the pallas model's one-hot moment matmul alone
    would exceed the kernel's measured 0.5353 ms at the main cell."""
    pallas = PORT.predict(MAIN_N, MAIN_D, MAIN_K, platform="h100",
                          prune_frac=0.9776)
    assert pallas["moments"]["flops"] / 67e12 > 0.5353e-3
    cuda = PORT.assign_intensity(MAIN_N, MAIN_D, MAIN_K, backend="cuda",
                                 prune_frac=0.5, blocks=1)
    assert cuda["distance"]["flops"] == MAIN_N * MAIN_K * 0.5 * 13
    assert cuda["moments"]["flops"] == 2 * 5 * MAIN_N
    # default blocks: one a block_p point tile
    a = PORT.assign_intensity(10_000, 3, 64, backend="cuda_flat",
                              block_p=1024)
    b = PORT.assign_intensity(10_000, 3, 64, backend="cuda_flat", blocks=10)
    assert a == b
