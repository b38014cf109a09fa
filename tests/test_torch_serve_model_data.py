"""Serving over a ``(2, 2)`` mesh of ranks: the cases of
tests/test_torch_serve_model.py on four thread ranks against the
reference on ``make_host_mesh(2, 2)`` (each data rank serves two of the
four rows, each model rank half of the heads, ``mlp``, experts and
vocabulary); then the query heads that straddle their KV groups unevenly
(no config does at ``model=2``: K/V expanded to a rank's heads), and the
serving driver over ranks (``launch.serve --model-parallel``). Set-up
and tolerances: tests/serve_model_cases.py.
"""
import dataclasses

import pytest
import torch

import serve_model_cases as C
from repro_torch import configs
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch import serve as LS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M

torch.set_num_threads(1)

MESH = (2, 2)
SERVED = [c for c in C.CASES if c[0] != "internvl2_76b"]


@pytest.mark.parametrize("case", C.CASES, ids=C.case_id)
def test_prefill_matches_reference(case):
    C.check_prefill(case, MESH)


@pytest.mark.parametrize("case", C.CASES, ids=C.case_id)
def test_decode_steps_match_reference(case):
    C.check_decode(case, MESH)


@pytest.mark.parametrize("case", SERVED, ids=C.case_id)
def test_engine_transcripts_match_reference(case):
    C.check_engine(case, MESH)


@pytest.mark.parametrize("case", [c for c in C.CASES if c[0] in C.MOE],
                         ids=C.case_id)
def test_routing_is_bit_equal_across_model_ranks(case):
    C.check_routing(case, MESH)


@pytest.mark.parametrize("case", C.CASES, ids=C.case_id)
def test_embedding_and_shard_shapes(case):
    C.check_embedding_and_shapes(case, MESH)


def test_each_data_rank_holds_its_rows():
    """Rank (d, m) of the ``(2, 2)`` mesh is ``2 d + m`` and serves rows
    ``[2 d, 2 d + 2)``."""
    ranks = C.port((C.GEMMA, "float32", False), MESH)
    assert [r["coord"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["rows"] for r in ranks] == [(0, 2), (0, 2), (2, 4), (2, 4)]


def _kv_choices(cfg, model):
    """``layers._rank_kv`` on each of ``model`` thread ranks."""
    def body():
        rules = resolve_rules(make_host_mesh(1, model, device=C.CPU), cfg,
                              "decode")
        sel = L._rank_kv(cfg, rules)
        return sel.tolist() if isinstance(sel, torch.Tensor) else sel
    return C._launch(body, model)


def test_uneven_kv_groups_expand_to_the_rank_heads():
    """6 query heads over 3 KV heads at ``model=2``: rank 0's heads 0-2
    read KV heads 0, 0, 1 and rank 1's 1, 2, 2, groups straddled
    unevenly, so K/V are expanded to each rank's heads. No config does
    this at ``model=2`` (each slices whole groups, gemma3's one KV head
    included). Decode and prefill against ``model=1``."""
    for arch in configs.ARCHS:
        for smoke in (True, False):
            cfg = configs.get_config(arch, smoke=smoke)
            if all(s.attn in ("full", "swa") for s in cfg.pattern):
                assert all(not isinstance(sel, list)
                           for sel in _kv_choices(cfg, 2)), (arch, smoke)
    cfg = dataclasses.replace(configs.get_config("starcoder2_7b",
                                                 smoke=True),
                              n_heads=6, n_kv_heads=3, dtype="float32")
    assert cfg.d_model % 6 == 0
    assert _kv_choices(cfg, 2) == [[0, 0, 1], [1, 2, 2]]
    whole = M.init_params(cfg, torch.Generator().manual_seed(0), C.CPU)
    tok = torch.randint(0, cfg.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(1))

    def serve(model):
        rules = resolve_rules(make_host_mesh(1, model, device=C.CPU), cfg,
                              "decode", batch_size=2)
        p = M.shard_params(whole, cfg, rules)
        with torch.no_grad():
            logits, _ = M.prefill(p, {"tokens": tok}, cfg, rules)
            cache = M.init_cache(cfg, 2, 8, rules, device=C.CPU)
            steps = [M.decode_step(p, cache, {"tokens": tok[:, t:t + 1]},
                                   t, cfg, rules)[0] for t in range(6)]
        return logits, torch.stack(steps)

    want = serve(1)
    for got in C._launch(lambda: serve(2), 2):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **C.TOL["float32"])


def test_serve_driver_over_ranks(monkeypatch, capsys):
    """``launch.serve --data-parallel 2 --model-parallel 2`` outside a
    rank launches four ranks running the same command (thread ranks
    here, for time) and returns rank 0's transcripts: those of the
    driver on one rank (granite's SMOKE in its bfloat16)."""
    launched = []
    inner = LS.launch.launch

    def threads(fn, nranks, **kw):
        launched.append((fn, nranks, kw["args"]))
        return inner(fn, nranks, args=kw["args"], device=kw["device"],
                     threads=True, timeout=120)

    monkeypatch.setattr(LS.launch, "launch", threads)
    base = ["--arch", "granite-moe-3b-a800m", "--requests", "4",
            "--max-new", "4", "--device", "cpu"]
    one = LS.main(base)
    argv = base + ["--data-parallel", "2", "--model-parallel", "2"]
    got = LS.main(argv)
    assert launched == [(LS._rank_main, 4, (argv,))]
    assert got == one and [len(t) for t in got] == [4] * 4
    assert "{'data': 2, 'model': 2} ranks on cpu" in capsys.readouterr().out
