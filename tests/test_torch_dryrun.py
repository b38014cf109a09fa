"""The port's launch analyses on ``meta`` tensors: the liveness peak
(``repro_torch.launch.live_mem``, the counterpart of
``repro/launch/hlo_mem.py``), the kernels' ``meta`` routes
(``repro_torch.kernels.meta``) and the dry run
(``repro_torch.launch.dryrun``) of every config's SMOKE train, prefill and
decode cell. The reference's argument bytes for the same cells are held
in ``tests/test_torch_dryrun_arguments.py``.

The liveness tests are the counterparts of ``tests/test_flash_path.py``'s
HLO tests: a loop with a 16 MB temp an iteration peaks at two temps, not
the trip count; eight products alive at once count at least two; and the
flash path at S = 4096 peaks below the dense path."""
import dataclasses
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import meta as KMETA
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_cuda,
                                                 flash_attention_f32,
                                                 flash_attention_tc)
from repro_torch.kernels.moe_router_kernel import (router_topk_cuda,
                                                   router_topk_divide_cuda)
from repro_torch.launch import dryrun as D
from repro_torch.launch.live_mem import (LiveMemory, storage_bytes,
                                         storage_key)
from repro_torch.launch.shapes import ShapeCell
from repro_torch.models import layers as L
from repro_torch.models import model as M

MB16 = 2048 * 2048 * 4

# the SMOKE cells: train, prefill and decode at small shapes
SMOKE_CELLS = (ShapeCell("train_smoke", 64, 4, "train"),
               ShapeCell("prefill_smoke", 64, 2, "prefill"),
               ShapeCell("decode_smoke", 64, 2, "decode"))


def smoke_overrides(arch):
    """``cfg_overrides`` that turn ``arch``'s CONFIG into its SMOKE."""
    smoke = configs.get_config(arch, smoke=True)
    return {f.name: getattr(smoke, f.name)
            for f in dataclasses.fields(smoke)}


# ---------------------------------------------------------------------------
# the liveness peak
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_peak_bounded_by_two_temps(device):
    """A loop whose body makes a 16 MB product peaks at the accumulator
    and one product, not the trip count's eight."""
    x = torch.ones(8, 2048, 2048, device=device)
    w = torch.ones(2048, 2048, device=device)
    with LiveMemory() as mem:
        acc = torch.zeros(2048, 2048, device=device)
        for i in range(8):
            acc.add_(x[i] @ w)
    assert mem.peak <= 2 * MB16, mem.peak / 2 ** 20
    assert mem.allocated == 9 * MB16       # summed with no reuse
    assert mem.live == MB16                # the accumulator
    del acc


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_parallel_products_count_all(device):
    x = torch.ones(8, 1024, 1024, device=device)
    w = torch.ones(1024, 1024, device=device)
    with LiveMemory() as mem:
        prods = [x[i] @ w for i in range(8)]
        out = prods[0]
        for p in prods[1:]:
            out = out + p
    assert mem.peak >= 2 * 1024 * 1024 * 4
    assert mem.peak >= 8 * 1024 * 1024 * 4   # all eight alive at once
    del prods, out


def test_flash_path_peaks_below_dense(monkeypatch):
    """One granite attention layer at S = 4096 on meta: the flash path
    (the kernel's meta route) against the dense path's S x S scores."""
    cfg = configs.get_config("granite_moe_3b_a800m")
    p = M._index(M.abstract_params(cfg)["layers"]["pos0"]["attn"], 0)
    x = torch.empty(1, 4096, cfg.d_model, dtype=cfg.act_dtype,
                    device="meta")
    peaks = {}
    for path, s_min in (("flash", L.FLASH_S_MIN), ("dense", 1 << 30)):
        monkeypatch.setattr(L, "FLASH_S_MIN", s_min)
        with LiveMemory() as mem:
            out, _ = L.attention(p, x, cfg)
        peaks[path] = mem.peak
        assert tuple(out.shape[:2]) == (1, 4096)
    scores = cfg.n_heads * 4096 * 4096 * 4
    assert peaks["flash"] < scores <= peaks["dense"], peaks


def test_views_inplace_and_out_add_nothing():
    x = torch.empty(1 << 20, device="meta")
    with LiveMemory() as mem:
        v = x.view(1024, 1024).t()[3:]
        x.mul_(2.0)
        torch.exp(x, out=x)
        y = x.clone()
        y.add_(1.0)
        z = y[::2]
        torch.sin(x, out=y)
    assert mem.allocated == mem.peak == 4 << 20     # the clone alone
    del v, z, y


def test_saved_tensors_stay_live_until_backward():
    """A tensor autograd saves stays live after its last Python reference
    is dropped, and dies with the graph."""
    a = torch.empty(1 << 20, device="meta", requires_grad=True)
    with LiveMemory() as mem:
        y = a.exp()                 # exp saves its output
        s = (y * 3.0).sum()
        del y
        held = mem.live
        s.backward()
        del s
    assert held >= 4 << 20
    assert mem.live == 4 << 20          # a.grad, made in the backward
    a.grad = None
    assert mem.live == 0


def test_storage_bytes_counts_views_once():
    x = torch.empty(10, 10, device="meta")
    assert storage_bytes({"a": x, "b": [x[1], x.t()]}) == 400


def test_largest_at_peak_names_the_op():
    with LiveMemory() as mem:
        a = torch.empty(1 << 20, device="meta")
        b = torch.exp(a)
        del a
        c = torch.zeros(10, device="meta")
    top = mem.largest_at_peak(2)
    assert top[0]["op"] in ("aten.empty", "aten.exp")
    assert top[0]["bytes"] == 4 << 20 and top[0]["shape"] == [1 << 20]
    del b, c


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------

@pytest.fixture
def meta_routes_raise(monkeypatch):
    """Every meta route raises: a CPU tensor must never get there."""
    def boom(*args, **kwargs):
        raise AssertionError("a CPU tensor took a meta route")
    monkeypatch.setattr(KMETA, "flash_attention", boom)
    monkeypatch.setattr(KMETA, "router_topk", boom)


def test_cpu_tensors_never_take_a_meta_route(meta_routes_raise):
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 4, 16, generator=g) for _ in range(3))
    for fn in (flash_attention_cuda, flash_attention_tc,
               flash_attention_f32):
        fn(q, k, v)
    qg = q.clone().requires_grad_()
    FlashAttentionFn.apply(qg, k, v, 0.0).sum().backward()
    x = torch.randn(8, 16, generator=g)
    c = torch.randn(4, 16, generator=g)
    infl = torch.rand(4, generator=g) + 0.5
    router_topk_cuda(x, c, 1.0 / (infl * infl), 2)
    router_topk_divide_cuda(x, c, infl, 2)
    router_topk_divide_cuda(x, c, None, 2)
    ops.router_topk(x, c, infl, 2)
    counts = ops.launch_counts()
    assert counts["flash_attention_tc"] == counts["flash_attention"] == 0
    assert counts["router_topk"] == 0
    assert counts["flash_attention_plain"] == 4
    assert counts["router_topk_plain"] == 4


def test_cpu_model_step_never_takes_a_meta_route(meta_routes_raise):
    """A SMOKE granite prefill on the CPU at S = FLASH_S_MIN (flash and
    the router on their plain versions), with no meta route taken."""
    cfg = dataclasses.replace(configs.get_config("granite_moe_3b_a800m",
                                                 smoke=True),
                              dtype="float32", n_layers=1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = torch.zeros(1, L.FLASH_S_MIN, dtype=torch.int32)
    ops.reset_launch_counts()
    logits, _ = M.prefill(params, {"tokens": toks}, cfg)
    counts = ops.launch_counts()
    assert counts["flash_attention_plain"] == 1
    assert counts["router_topk_plain"] == 1
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16,
                                         "flash_attention_tc"),
                                        (torch.float32, "flash_attention")])
def test_flash_meta_route(dtype, name):
    B, S, H, KV, dh = 2, 4096, 8, 2, 64
    q = torch.empty(B, S, H, dh, dtype=dtype, device="meta")
    k, v = (torch.empty(B, S, KV, dh, dtype=dtype, device="meta")
            for _ in range(2))
    ops.reset_launch_counts()
    with KMETA.kernel_costs() as costs:
        out = flash_attention_cuda(q, k, v)
    assert out.device.type == "meta" and out.dtype == dtype
    assert tuple(out.shape) == (B, S, H, dh)
    w = q.element_size()
    assert [c[:3] for c in costs] == [
        (name, float(4 * dh * H * S * (S + 1) // 2 * B),
         float(w * B * S * dh * (2 * H + 2 * KV)))]
    assert len(costs[0][3]) == 3       # q, k and v read
    assert all(c == 0 for c in ops.launch_counts().values())


def test_flash_meta_route_keeps_the_kernels_checks():
    q = torch.empty(1, 4096, 4, 48, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("T", [4, 4096])
def test_router_meta_route(T):
    E, D, K = 40, 1536, 8
    x = torch.empty(T, D, dtype=torch.bfloat16, device="meta")
    c = torch.empty(E, D, device="meta")
    infl = torch.empty(E, device="meta")
    ops.reset_launch_counts()
    with KMETA.kernel_costs() as costs, LiveMemory() as mem:
        idx, eff = router_topk_divide_cuda(x, c, infl, K)
    assert (idx.dtype, eff.dtype) == (torch.int32, torch.float32)
    assert tuple(idx.shape) == tuple(eff.shape) == (T, K)
    # the [T*E] float32 scratch was live with the outputs
    assert mem.peak == T * E * 4 + T * K * 8
    assert [c[:3] for c in costs] == [
        ("router_topk", float(T * E * (2 * D + 3)),
         float(2 * T * D + 4 * E * (D + 1) + 8 * T * K))]
    assert storage_key(c) in mem.read and storage_key(infl) in mem.read
    assert all(n == 0 for n in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the dry run of every config's SMOKE cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", SMOKE_CELLS, ids=lambda c: c.mode)
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_run_cell_smoke(arch, cell):
    """The cell runs on meta at full SMOKE depth; its memory record adds
    up; its extrapolated cost equals the full-depth count."""
    ov = smoke_overrides(arch)
    rec = D.run_cell(arch, cell, cfg_overrides=ov)
    json.dumps(rec)
    assert rec["ok"] and rec["shape"] == cell.name
    mem = rec["memory"]
    assert mem["live_bytes"] == mem["resident_argument_bytes"] + \
        mem["peak_temp_estimate"]
    assert 0 < mem["argument_size_in_bytes"] <= \
        mem["resident_argument_bytes"]
    assert 0 < mem["peak_temp_estimate"] <= mem["temp_size_in_bytes"]
    assert mem["fits_hbm_80g"]
    assert mem["largest_at_peak"][0]["bytes"] > 0
    if cell.mode == "train":
        # the state is updated in place: params and moments come back
        assert mem["alias_size_in_bytes"] > 0.9 * (
            mem["argument_size_in_bytes"])
    full, _, cfg = D.build_cell(arch, cell, cfg_overrides=ov)
    counted = D.cost_info(full)
    assert rec["cost"]["flops_per_dev"] == pytest.approx(
        counted["flops"], rel=1e-12)
    assert rec["cost"]["bytes_per_dev"] == pytest.approx(
        counted["bytes"], rel=1e-12)
    assert rec["cost"]["flops_per_dev"] > 0
    assert rec["roofline"]["model_flops"] > 0
    assert rec["cost"]["wire_per_dev"]["total"] == 0.0


def test_extrap_is_affine_in_repeats():
    assert D._extrap(10.0, 14.0, 1) == 10.0
    assert D._extrap(10.0, 14.0, 5) == 26.0


def test_kernels_counted_at_full_width():
    """granite's prefill at S = 4096 on meta: the flash kernel once a
    layer and the router once a MoE layer reported their costs."""
    cell, _, cfg = D.build_cell("granite_moe_3b_a800m",
                                ShapeCell("p4k", 4096, 1, "prefill"),
                                n_layers=2)
    info = D.cost_info(cell)
    assert info["kernels"]["flash_attention_tc"][0] == 2
    assert info["kernels"]["router_topk"][0] == 2
    assert info["flops"] > sum(v[1] for v in info["kernels"].values())


def test_long_context_skipped_as_the_reference_skips():
    rec = D.run_cell("starcoder2_7b", "long_500k")
    assert rec["ok"] and rec["skipped"]


def test_main_writes_a_record(tmp_path):
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path /
                      "gemma3_1b__decode_32k__single.json").read_text())
    assert rec["ok"] and rec["memory"]["live_bytes"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")


@pytest.mark.parametrize("compress", ["none", "bf16", "int8"])
def test_train_cell_with_gradient_compression(compress):
    """The error-feedback tree is an argument and is updated in place;
    int8's noise has no generator on meta."""
    from repro_torch.train import TrainHParams
    rec = D.run_cell("granite_moe_3b_a800m", SMOKE_CELLS[0],
                     do_roofline=False,
                     hp=TrainHParams(grad_compress=compress, microbatches=2),
                     cfg_overrides=smoke_overrides("granite_moe_3b_a800m"))
    mem = rec["memory"]
    params = M.param_count(M.abstract_params(
        configs.get_config("granite_moe_3b_a800m", smoke=True)))
    ef = 0 if compress == "none" else 4 * params
    assert mem["resident_argument_bytes"] >= 3 * 4 * params + ef
    assert mem["fits_hbm_80g"]
