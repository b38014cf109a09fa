"""The per-rank dry run's collectives against real ranks: granite and
jamba SMOKE train, prefill and decode cells, a rank of ``(1, 2)``,
``(2, 1)``, ``(2, 2)`` and ``(2, 2, 2)`` traced alone on ``meta``
(``launch.dryrun.build_cell``, its ``dist.comm.meta_communicator``
standing for CPU gloo ranks) against the same step on thread ranks
(``dist.launch``, gloo): the meta log of one step equals, kind by kind in
calls and bytes, ``Communicator.counters(rank=True)`` of the real rank
around the step, for the first rank and the last; and every real rank
moves the same."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.dist import launch
from repro_torch.dist.comm import current, log_counters
from repro_torch.dist.rules import local_range, resolve_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.serve.engine import make_serve_step
from repro_torch.train import (TrainHParams, init_train_state,
                               make_train_step)

from test_torch_dryrun import SMOKE_CELLS, smoke_overrides

torch.set_num_threads(1)

AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
MESHES = [(1, 2), (2, 1), (2, 2), (2, 2, 2)]
ARCHS = ["granite_moe_3b_a800m", "jamba_1p5_large_398b"]
CPU_GLOO = ("gloo", None)


def _hp(arch):
    return TrainHParams(remat=True, **dict(
        getattr(configs.get(arch), "TRAIN_HPARAMS", {})))


def _moved(before, after):
    return {k: after[k] - before[k] for k in after
            if not k.endswith("seconds")}


def real_rank(arch, cell, shape):
    """On this thread rank: the cell's step on its own shards (made from
    seed 0), the collectives it moved (every group of the rank)."""
    cfg = configs.get_config(arch, smoke=True)
    mesh = make_mesh(shape, AXES[len(shape)], device="cpu")
    rules = resolve_rules(mesh, cfg, cell.mode, batch_size=cell.batch,
                          overrides=configs.sharding_overrides(arch,
                                                               cell.mode))
    gen = torch.Generator().manual_seed(0)
    B, S = cell.batch, cell.seq
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32))
    comm = current()
    if cell.mode == "train":
        state = init_train_state(cfg, gen, _hp(arch), device="cpu",
                                 rules=rules)
        step = make_train_step(cfg, rules, _hp(arch))
        batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
        before = comm.counters(rank=True)
        step(state, batch)
    else:
        params = M.init_params(cfg, gen, device="cpu", rules=rules)
        if cell.mode == "prefill":
            b0, b1 = local_range(rules, "act_batch", B)
            before = comm.counters(rank=True)
            M.prefill(params, {"tokens": tok[b0:b1]}, cfg, rules)
        else:
            cache = M.init_cache(cfg, B, S, rules, device="cpu")
            step = make_serve_step(cfg, rules)
            before = comm.counters(rank=True)
            step(params, cache, tok[:, :1], S - 1)
    return _moved(before, comm.counters(rank=True))


def meta_rank(arch, cell, shape, rank):
    mesh = make_mesh(shape, AXES[len(shape)], device="meta")
    built, _, _ = D.build_cell(arch, cell, mesh, rank,
                               cfg_overrides=smoke_overrides(arch),
                               collectives=CPU_GLOO)
    built.run()
    return log_counters(built.log)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cell", SMOKE_CELLS, ids=lambda c: c.mode)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_log_equals_real_ranks_counters(arch, cell, shape):
    n = int(np.prod(shape))
    out = {}

    def body():
        out[current().rank] = real_rank(arch, cell, shape)

    launch.launch(body, n, device="cpu", threads=True, timeout=300.0)
    real = [out[r] for r in range(n)]
    assert all(r == real[0] for r in real[1:])
    # serving over data alone moves nothing: each rank its own rows
    assert real[0]["all_reduces"] > 0 or (cell.mode != "train"
                                          and shape[-1] == 1)
    for rank in sorted({0, n - 1}):
        assert meta_rank(arch, cell, shape, rank) == real[rank]
