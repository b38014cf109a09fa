"""Data-parallel training over ranks in the port (``make_host_mesh(2)``:
``train.step`` with the batch dealt per microbatch, FSDP of every
``embed`` leaf, the router's loads summed over the ranks; ``Trainer``,
checkpoints and ``launch.train`` over ranks) against the reference's
step on ``make_host_mesh(2, 1)`` (two of the 8 virtual jax devices:
GSPMD over ``dist/rules.py``'s table) and against the port's own
one-rank step.

The port's ranks are threads with their own gloo groups
(``dist.launch.launch(..., threads=True)``); one test spawns two rank
processes through ``launch.train.main``. SMOKE configs in float32.

Tolerances, those of tests/test_torch_train.py: loss and moe_dropped_frac
within 1e-5 relative, grad_norm within 1e-3 relative (the reference's
(2, 1) step reads 1.3e-4 from its own (1, 1) step at granite's step 2:
a sum over the two devices' rows in another order), parameters and
moments within 1e-4 relative and 1e-5 absolute (1e-4 absolute with bf16
or int8 compression: a gradient rounding to the other neighbour of its
grid point), the influence within 1e-6 relative (it comes from integer
loads) and bit-equal across the ranks. Checkpoints: bit for bit.
"""
import dataclasses
import itertools
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.dist.rules import resolve_rules as ref_resolve_rules
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import model as RM
from repro.train import TrainHParams as RTrainHParams
from repro.train import init_train_state as ref_init_train_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import train_state_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.dist import fsdp, launch
from repro_torch.dist.comm import current
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import (Trainer, TrainerConfig, TrainHParams,
                               abstract_train_state, make_train_step)
from repro_torch.train import step as STEP

torch.set_num_threads(1)

CPU = "cpu"
GRANITE = "granite_moe_3b_a800m"
GEMMA = "gemma3_1b"
HP = dict(lr_peak=5e-3, warmup_steps=2, total_steps=50, z_loss=1e-4)
DEADLINE = 300.0
D = 2


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _ranks(fn, nranks=D, *args):
    """``fn(*args)`` on every thread rank; the list of their values in
    rank order."""
    out = {}

    def body():
        out[current().rank] = fn(*args)

    launch.launch(body, nranks, device=CPU, threads=True, timeout=DEADLINE)
    return [out[r] for r in range(nranks)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_tree(got, want, **tol):
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = tree_leaves(got)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


def _whole_state(state, cfg, rules, hp):
    """The whole train state from a rank's shards (every rank calls it)."""
    return STEP.whole_state(state, cfg, rules, hp)


def _rules(pcfg, data, batch):
    return resolve_rules(make_host_mesh(data, device=CPU), pcfg, "train",
                         batch_size=batch)


def _port_steps(rstate_np, pcfg, php, batches, data, keep=(0, 2)):
    """The port's step over ``data`` ranks from the reference's state on
    the global ``batches``: on every rank, (the metrics and the whole
    state after each step in ``keep``, the rank's shard shapes)."""
    def run():
        rules = _rules(pcfg, data, batches[0]["labels"].shape[0])
        state = STEP.shard_state(train_state_from_numpy(rstate_np, CPU),
                                 pcfg, rules, php)
        shapes = [tuple(x.shape) for x in tree_leaves(state["params"])]
        step = make_train_step(pcfg, rules, php)
        kept = []
        for i, b in enumerate(batches):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
            if i in keep:
                whole = _whole_state(state, pcfg, rules, php)
                kept.append(({k: float(v) for k, v in m.items()},
                             jax.tree.map(lambda x: x.detach().clone(),
                                          whole)))
        return kept, shapes

    if data == 1:
        return [run()]
    return _ranks(run, data)


def _reference(arch, hp, batch, steps=3, keep=(0, 2), mesh=(D, 1)):
    """The reference's jitted step on ``make_host_mesh(*mesh)``: (its
    state as numpy, the SMOKE configs, its metrics and states after the
    steps in ``keep``, the batches); no step runs when ``keep`` is
    empty."""
    rcfg = _f32(ref_configs.get_config(arch, smoke=True))
    pcfg = _f32(configs.get_config(arch, smoke=True))
    rhp = RTrainHParams(**hp)
    rstate = ref_init_train_state(rcfg, jax.random.PRNGKey(0), rhp)
    rstate_np = jax.tree.map(np.asarray, rstate)
    rules = ref_resolve_rules(ref_host_mesh(*mesh), rcfg, "train",
                              batch_size=batch)
    rstep = jax.jit(ref_make_train_step(rcfg, rules, rhp))
    batches = list(itertools.islice(iter(RefSyntheticLM(rcfg, batch=batch,
                                                        seq=32)), steps))
    kept = []
    for i, b in enumerate(batches if keep else []):
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, b))
        if i in keep:
            kept.append((rm, rstate))
    return rstate_np, pcfg, kept, batches


def _assert_step(pm, pstate, rm, rstate, compress):
    for key in ("loss", "lr", "moe_dropped_frac"):
        np.testing.assert_allclose(pm[key], float(rm[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_allclose(pm["grad_norm"], float(rm["grad_norm"]),
                               rtol=1e-3)
    assert int(pm["step"]) == int(rm["step"])
    tol = dict(rtol=1e-4, atol=1e-5 if compress == "none" else 1e-4)
    _assert_tree(pstate["params"], rstate["params"], **tol)
    _assert_tree(pstate["opt"]["mu"], rstate["opt"]["mu"], **tol)
    _assert_tree(pstate["opt"]["nu"], rstate["opt"]["nu"], **tol)
    if "influence" in rstate:
        np.testing.assert_allclose(_np(pstate["influence"]),
                                   _np(rstate["influence"]), rtol=1e-6)
    if "ef" in rstate:
        _assert_tree(pstate["ef"], rstate["ef"], rtol=0, atol=2e-4)


def _assert_ranks_agree(ranks):
    """Every rank's metrics and whole state bit-equal to rank 0's (the
    influence among them)."""
    for kept, _ in ranks[1:]:
        for (m, st), (m0, st0) in zip(kept, ranks[0][0]):
            assert m == m0
            for a, b in zip(tree_leaves(st), tree_leaves(st0)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("arch", [GRANITE, GEMMA])
@pytest.mark.parametrize("micro,compress", [(1, "none"), (2, "none"),
                                            (1, "bf16"), (2, "bf16")])
def test_data_parallel_step_matches_reference(arch, micro, compress):
    """data=2 on thread ranks against the reference's step on a (2, 1)
    host mesh: batch 4 x 32, three steps, held after the first (lr 0)
    and the third; every rank's state and metrics the same bits."""
    hp = dict(HP, microbatches=micro, grad_compress=compress)
    rstate_np, pcfg, want, batches = _reference(arch, hp, 4)
    ranks = _port_steps(rstate_np, pcfg, TrainHParams(**hp), batches, D)
    _assert_ranks_agree(ranks)
    for (pm, pstate), (rm, rstate) in zip(ranks[0][0], want):
        _assert_step(pm, pstate, rm, rstate, compress)


def test_uneven_batch_is_replicated_on_every_rank():
    """B = 3 on two ranks: the rules drop ``act_batch`` (the reference's
    rule), every rank computes every row, the loads are not summed and
    the gradients not counted twice: the reference's (2, 1) step."""
    hp = dict(HP, microbatches=1)
    rstate_np, pcfg, want, batches = _reference(GRANITE, hp, 3)
    assert _rules(pcfg, D, 3).table["act_batch"] is None
    ranks = _port_steps(rstate_np, pcfg, TrainHParams(**hp), batches, D)
    _assert_ranks_agree(ranks)
    for (pm, pstate), (rm, rstate) in zip(ranks[0][0], want):
        _assert_step(pm, pstate, rm, rstate, "none")


def test_int8_on_two_ranks_equals_one_rank():
    """int8 compression (the port's own noise, so against the port's
    data=1): the whole leaf's scale by an all-reduce max, the shard's
    noise sliced from the whole leaf's stream."""
    hp = TrainHParams(**HP, microbatches=2, grad_compress="int8")
    rstate_np, pcfg, _, batches = _reference(
        GRANITE, dict(HP, microbatches=2, grad_compress="int8"), 4, keep=())
    one = _port_steps(rstate_np, pcfg, hp, batches, 1)[0][0]
    ranks = _port_steps(rstate_np, pcfg, hp, batches, D)
    _assert_ranks_agree(ranks)
    for (m2, s2), (m1, s1) in zip(ranks[0][0], one):
        np.testing.assert_allclose(m2["loss"], m1["loss"], rtol=1e-5)
        np.testing.assert_allclose(m2["grad_norm"], m1["grad_norm"],
                                   rtol=1e-3)
        for a, b in zip(tree_leaves(s2), tree_leaves(s1)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4,
                                       atol=1e-4)


def test_shard_shapes_are_the_references():
    """Each rank's parameter shards have the reference's
    ``rules.sharding(spec).shard_shape(shape)`` on a (2, 1) mesh, where
    the extent divides (every ``embed`` leaf of the SMOKE configs), and
    the port's ``NamedSharding.shard_shape`` says the same."""
    for arch in (GRANITE, GEMMA):
        rcfg = ref_configs.get_config(arch, smoke=True)
        pcfg = configs.get_config(arch, smoke=True)
        rrules = ref_resolve_rules(ref_host_mesh(D, 1), rcfg, "train")
        specs = jax.tree.leaves(RM.param_logical_specs(rcfg),
                                is_leaf=lambda x: isinstance(x, tuple))
        shapes = [x.shape for x in jax.tree.leaves(RM.abstract_params(rcfg))]
        want = [rrules.sharding(s).shard_shape(x)
                for s, x in zip(specs, shapes)]
        assert any(w != x for w, x in zip(want, shapes))
        hp = TrainHParams()

        def shards():
            rules = _rules(pcfg, D, 4)
            state = STEP.init_train_state(pcfg, torch.Generator()
                                          .manual_seed(0), hp, device=CPU)
            local = STEP.shard_state(state, pcfg, rules, hp)["params"]
            sh = tree_leaves(STEP.state_shardings(pcfg, rules, hp)["params"])
            return ([tuple(x.shape) for x in tree_leaves(local)],
                    [s.shard_shape(x) for s, x in zip(sh, shapes)])

        for got, named in _ranks(shards):
            assert got == [tuple(w) for w in want] == named


def test_step_influence_equals_the_per_layer_form():
    """The step's update from the forward's stacked loads
    (``_influence_from_loads``, one call a layer of
    ``moe.update_influence``) is the forward's own per-layer influence,
    bit for bit, with and without remat."""
    pcfg = _f32(configs.get_config(GRANITE, smoke=True))
    state = STEP.init_train_state(pcfg, torch.Generator().manual_seed(0),
                                  TrainHParams(), device=CPU)
    batch = next(iter(SyntheticLM(pcfg, 4, 32)))
    infl = state["influence"] * 1.25
    m = pcfg.moe
    for remat in (False, True):
        _, ninf, st = M.forward(state["params"],
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                pcfg, remat=remat, influence=infl)
        got = STEP._influence_from_loads(infl, st["moe_load"],
                                         m.top_k * 4 * 32 / m.n_experts, m)
        assert st["moe_load"].shape == infl.shape
        assert torch.equal(got, ninf)


def _trainer_states(tmp, data, steps, resume_from=None, ckpt_every=0):
    """``Trainer.fit`` of granite SMOKE over ``data`` ranks: (history,
    whole final state) on every rank."""
    pcfg = _f32(configs.get_config(GRANITE, smoke=True))
    hp = TrainHParams(**HP, microbatches=2)

    def run():
        rules = _rules(pcfg, data, 4)
        tc = TrainerConfig(steps=steps, log_every=1, ckpt_every=ckpt_every,
                           ckpt_dir=None if tmp is None else str(tmp))
        t = Trainer(pcfg, rules, hp, tc)
        state, hist = t.fit(iter(SyntheticLM(pcfg, 4, 32)))
        return hist, _whole_state(state, pcfg, rules, hp)

    return [run()] if data == 1 else _ranks(run, data)


def test_trainer_over_ranks_matches_one_rank(tmp_path):
    """``Trainer.fit`` over two ranks (each drawing the same stream,
    its shards made from the seed and cut) against one rank: the
    metrics and the whole state within the step's tolerances; a
    checkpoint every step, written by rank 0 alone."""
    one = _trainer_states(None, 1, 2)[0]
    ranks = _trainer_states(tmp_path, D, 2, ckpt_every=1)
    assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2]
    for hist, state in ranks:
        for a, b in zip(hist, one[0]):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                       rtol=1e-3)
        for a, b in zip(tree_leaves(state), tree_leaves(one[1])):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)
    assert all(torch.equal(ranks[0][1]["influence"], h[1]["influence"])
               for h in ranks)


@pytest.mark.parametrize("written,read", [(D, 1), (1, D)])
def test_checkpoints_cross_the_number_of_ranks(tmp_path, written, read):
    """A checkpoint written at data=2 restores at data=1 bit for bit and
    the other way round: the on-disk format is the whole state's; each
    rank reads its slices. The restored trainer then trains on."""
    pcfg = _f32(configs.get_config(GRANITE, smoke=True))
    hp = TrainHParams(**HP, microbatches=2)
    saved = _trainer_states(tmp_path, written, 2)[0][1]
    like = abstract_train_state(pcfg, hp)
    on_disk, step = CheckpointManager(str(tmp_path)).restore(like,
                                                             device=CPU)
    assert step == 2
    for a, b in zip(tree_leaves(on_disk), tree_leaves(saved)):
        assert torch.equal(a, b)

    def restore():
        rules = _rules(pcfg, read, 4)
        t = Trainer(pcfg, rules, hp, TrainerConfig(
            steps=3, log_every=1, ckpt_dir=str(tmp_path)))
        state, start = t.init_or_resume()
        local = STEP.shard_state(on_disk, pcfg, rules, hp)
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(state), tree_leaves(local)))
        state, hist = t.fit(iter(SyntheticLM(pcfg, 4, 32)), state, start)
        return start, same, [m["step"] for m in hist]

    got = [restore()] if read == 1 else _ranks(restore, read)
    assert got == [(2, True, [3.0])] * read


def test_launch_train_spawns_two_ranks(capfd, monkeypatch):
    """``launch.train.main(["--data-parallel", "2", "--device", "cpu",
    ...])`` outside a rank spawns two rank processes (gloo), each
    training on its rows; rank 0 prints a one-rank run's lines and
    its history comes back, within the step's tolerances of
    ``--data-parallel 1``."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", DEADLINE)
    argv = ["--arch", "granite-moe-3b-a800m", "--steps", "2", "--batch",
            "4", "--seq", "16", "--microbatches", "2", "--log-every", "1",
            "--device", "cpu"]
    trainer, hist = LT.main(argv + ["--data-parallel", "2"])
    out = capfd.readouterr().out
    assert trainer is None and [m["step"] for m in hist] == [1.0, 2.0]
    assert "final loss" in out and "2 data ranks" in out
    assert not multiprocessing.active_children()
    _, one = LT.main(argv)
    for a, b in zip(hist, one):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-3)


def _axis_facts():
    mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
    rank = current().rank
    col, row = mesh.axis_comm("data"), mesh.axis_comm("model")
    x = torch.arange(8.0).reshape(4, 2) * (rank + 1)
    return ((mesh.coordinate("data"), mesh.coordinate("model")),
            col.size, col.rank, row.rank,
            col.all_reduce(torch.tensor([float(rank)])).item(),
            row.all_reduce(torch.tensor([float(rank)])).item(),
            col.reduce_scatter(x, 0).tolist(),
            col.gather_along(x[:, :1], 1).tolist())


def test_mesh_axis_groups_are_rows_and_columns():
    """On a (2, 2) mesh, rank r sits at (r // 2, r % 2), row-major as
    ``jax.make_mesh`` lays devices; the data axis's group is the column
    (ranks {0, 2} or {1, 3}), the model axis's the row;
    ``reduce_scatter`` sums over the group and keeps the rank's chunk,
    ``gather_along`` concatenates in the group's order."""
    facts = _ranks(_axis_facts, 4)
    for r, f in enumerate(facts):
        d, m = r // 2, r % 2
        base = np.arange(8.0).reshape(4, 2)
        col = [m + 1, m + 3]            # the column's rank + 1 factors
        assert f[:4] == ((d, m), 2, d, m)
        assert f[4] == float(m + (m + 2)) and f[5] == float(2 * d + 2 * d + 1)
        np.testing.assert_array_equal(
            f[6], (base * sum(col))[2 * d:2 * d + 2])
        np.testing.assert_array_equal(
            f[7], np.concatenate([base[:, :1] * c for c in col], 1))


def test_rules_reduce_and_the_mesh_outside_a_rank():
    """``Rules.reduce`` is the identity on one data rank and the sum over
    the data ranks on two; a mesh of two ranks used outside a rank
    raises, a one-rank mesh has no communicator; the step's data axis is
    None on a (1, 2) mesh and the column of two ranks on (2, 2)."""
    pcfg = configs.get_config(GEMMA, smoke=True)
    x = torch.tensor([1.0, 2.0])
    assert _rules(pcfg, 1, 4).reduce(x, "act_batch") is x
    got = _ranks(lambda: _rules(pcfg, D, 4).reduce(
        x * (current().rank + 1), "act_batch").tolist())
    assert got == [[3.0, 6.0]] * D
    with pytest.raises(RuntimeError, match="outside a rank"):
        _rules(pcfg, D, 4).reduce(x, "act_batch")
    rules = resolve_rules(make_mesh((1, 2), ("data", "model"), device=CPU),
                          pcfg, "train")
    assert STEP._data_comm(rules) is None

    def data_axis():
        comm = STEP._data_comm(resolve_rules(
            make_mesh((2, 2), ("data", "model"), device=CPU), pcfg, "train"))
        return comm.size, comm.rank, comm.all_reduce(
            torch.tensor([float(current().rank)])).item()

    assert _ranks(data_axis, 4) == [(2, 0, 2.0), (2, 0, 4.0), (2, 1, 2.0),
                                    (2, 1, 4.0)]
    assert fsdp.gather(x, None) is x
