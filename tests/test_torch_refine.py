"""Label-propagation refinement in the port against the reference, on the
CPU.

Contract: exact equality, no tolerance. The rounds are integer arithmetic,
so the port's sparse rounds (``_lp_rounds`` on ``device="cpu"``) and its
dense plain version (``_lp_rounds_plain``) give the reference's host
rounds (``_lp_rounds_host``) bit for bit: labels, ``rounds``, ``moves``
and the last round's move count; ``refine(device="cpu")`` gives the
reference's ``refine(devices=None)``: labels, ``method`` and every
``stats["refine"]`` value. The accepted gains add up to the cut's fall.
The front doors (``partition(refine=)``, flat and hierarchical,
``repartition(refine=)``, ``PartitionResult.refine``) refine exactly what
``refine()`` does to the same base labels, and the reference's error
paths raise the same exception types here.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.core import meshes as ref_meshes
from repro.core import metrics as ref_metrics
from repro.partition import PartitionProblem as RefProblem
from repro.partition import partition as ref_partition
from repro.partition import refine as ref_refine
from repro.partition import repartition as ref_repartition
from repro_torch.convert import result_from_numpy
from repro_torch.core import meshes, metrics
from repro_torch.dist import launch
from repro_torch.partition import (PartitionProblem, PartitionResult,
                                   UnknownRefinerError, available_refiners,
                                   partition, refine,
                                   refinement_budgets,
                                   refinement_quantization, refiner_short_name,
                                   repartition, resolve_refiner)

ref_lp = importlib.import_module("repro.partition.refine")
lp = importlib.import_module("repro_torch.partition.refine")

torch.set_num_threads(1)

CPU = "cpu"
FAMILIES = ["tri", "delaunay2d", "aniso", "rggpow", "climate25d"]


def _problems(family, n, k, seed, weighted=False, eps=0.03):
    """The same instance as a port and a reference problem; ``weighted``
    adds lognormal weights (seeded) where the family has none."""
    mesh = ref_meshes.REGISTRY[family](n, seed=seed)
    w = mesh.weights
    if weighted and w is None:
        w = np.random.default_rng(seed + 3).lognormal(0.0, 0.5, mesh.n)
    kw = dict(points=mesh.points, k=k, weights=w, epsilon=eps,
              indptr=mesh.indptr, indices=mesh.indices, seed=seed)
    return PartitionProblem(**kw), RefProblem(**kw)


def _labels(n, k, seed, used=None):
    """Random labels over the first ``used`` blocks (default all k): the
    rest stay empty."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, k if used is None else used, n).astype(np.int64)


def _round_inputs(ref_prob, labels, keys):
    iw, limit = ref_lp.refinement_quantization(ref_prob)
    lc, _ = ref_lp._canonicalize(labels, keys, ref_prob.k)
    return (lc, np.asarray(ref_prob.indptr, np.int64),
            np.asarray(ref_prob.indices, np.int64), iw, keys, ref_prob.k,
            limit)


def _assert_same_result(got, want):
    np.testing.assert_array_equal(np.asarray(got.labels),
                                  np.asarray(want.labels))
    assert got.method == want.method
    assert got.stats["refine"] == want.stats["refine"]
    assert got.stats["final_imbalance"] == want.stats["final_imbalance"]


# ---------------------------------------------------------------------------
# the rounds

ROUND_CASES = [(fam, k, used, weighted)
               for fam in FAMILIES
               for k, used, weighted in ((2, None, False), (7, 5, False),
                                         (13, None, fam == "rggpow"))]


@pytest.mark.parametrize("family,k,used,weighted", ROUND_CASES)
def test_rounds_equal_reference(family, k, used, weighted):
    """Sparse and dense rounds against the host rounds, on random labels
    (empty blocks where ``used < k``) and a permuted priority order."""
    _, rp = _problems(family, 400, k, seed=k, weighted=weighted)
    labels = _labels(rp.n, k, seed=k, used=used)
    for keys in (np.arange(rp.n, dtype=np.int64),
                 np.random.default_rng(9).permutation(rp.n)):
        args = _round_inputs(rp, labels, keys)
        want = ref_lp._lp_rounds_host(*args, lp.DEFAULT_MAX_ROUNDS)
        for rounds in (lp._lp_rounds, lp._lp_rounds_plain):
            got = rounds(*args, lp.DEFAULT_MAX_ROUNDS, device=CPU)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:4] == want[1:], rounds.__name__
        cut = [ref_metrics.edge_cut(x, rp.indptr, rp.indices)
               for x in (args[0], want[0])]
        assert got[4] == cut[0] - cut[1] and got[2] <= got[4]


def test_rounds_on_a_graph_without_edges():
    args = (np.arange(20) % 4, np.zeros(21, np.int64), np.zeros(0, np.int64),
            np.ones(20, np.int64), np.arange(20), 4, 6)
    want = ref_lp._lp_rounds_host(*args, 8)
    for rounds in (lp._lp_rounds, lp._lp_rounds_plain):
        got = rounds(*args, 8, device=CPU)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == (1, 0, 0, 0)


def test_target_outside_the_candidates():
    """Node 0 sits in block 0 with its two neighbours in block 1; blocks 0
    and 1 are full, block 2 is open but holds none of its neighbours.
    The dense histogram names block 2 as its target (``Hm = 0`` there,
    -1 elsewhere), the sparse one names none (``k``); its gain is 0 in
    both, so the target is never read and the rounds agree."""
    # 0-1, 0-2, 1-2 triangle; 3-4-5-6 a path
    rows = [[1, 2], [0, 2], [0, 1], [4], [3, 5], [4, 6], [5]]
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate(rows).astype(np.int64)
    labels = np.array([0, 1, 1, 2, 0, 0, 0], np.int64)
    k, iw = 3, np.ones(7, np.int64)
    limit = 2                        # floor((1 + 0) * 7 / 3)
    budget = np.maximum(limit - np.bincount(labels, minlength=k), 0)
    assert budget.tolist() == [0, 0, 1]
    # the reference's dense target and gain, its own lines
    src = np.repeat(np.arange(7), np.diff(indptr))
    H = np.zeros((7, k), np.int64)
    np.add.at(H, (src, labels[indices]), 1)
    own = H[np.arange(7), labels]
    Hm = np.where(budget[None, :] >= iw[:, None], H, -1)
    d_tgt = np.argmax(Hm, axis=1)
    d_gain = np.where(Hm[np.arange(7), d_tgt] > own,
                      Hm[np.arange(7), d_tgt] - own, 0)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64)   # noqa: E731
    s_tgt, s_gain = lp._targets(t(labels), t(src), t(indices), t(iw),
                                t(budget), k)
    np.testing.assert_array_equal(s_gain.numpy(), d_gain)
    pos = d_gain > 0
    np.testing.assert_array_equal(s_tgt.numpy()[pos], d_tgt[pos])
    assert d_tgt[0] == 2 and s_tgt[0] == k and d_gain[0] == 0
    args = (labels, indptr, indices, iw, np.arange(7), k, limit, 4)
    want = ref_lp._lp_rounds_host(*args)
    for rounds in (lp._lp_rounds, lp._lp_rounds_plain):
        got = rounds(*args, device=CPU)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:4] == want[1:]


# ---------------------------------------------------------------------------
# refine() against the reference's

REFINE_CASES = {
    "default": {},
    "eps0": {"eps": 0.0},
    "one_round": {"max_rounds": 1},
    "node_order": {"node_order": "perm"},
    "loose": {"eps": 0.25},
}


@pytest.mark.parametrize("case", sorted(REFINE_CASES))
@pytest.mark.parametrize("family", FAMILIES)
def test_refine_equals_reference(family, case):
    weighted = family == "rggpow"
    prob, rp = _problems(family, 500, 6, seed=2, weighted=weighted)
    labels = _labels(prob.n, 6, seed=2)
    opts = dict(REFINE_CASES[case])
    if opts.get("node_order") == "perm":
        opts["node_order"] = np.random.default_rng(4).permutation(prob.n)
    want = ref_refine(rp, labels, **opts)
    got = refine(prob, labels, device=CPU, **opts)
    _assert_same_result(got, want)
    assert got.method == "labels+lp"
    st = got.stats["refine"]
    assert st["cut_after"] <= st["cut_before"]
    # the port's own info: its gains are the cut's fall
    out, info = lp.label_prop_refine(prob, labels, device=CPU, **opts)
    np.testing.assert_array_equal(out, got.labels)
    assert info["gain"] == st["cut_before"] - st["cut_after"]
    assert info["moves"] == st["moves"] and info["converged"] == \
        st["converged"]


def test_every_budget_at_zero_moves_nothing():
    """Unit weights, eps = 0 and exactly n/k nodes a block: every budget
    is 0, so no move is admissible; one round, no move, converged."""
    prob, rp = _problems("tri", 400, 4, seed=0, eps=0.0)
    labels = np.arange(prob.n) % 4
    iw, budget = refinement_budgets(prob, labels)
    assert not budget.any()
    want = ref_refine(rp, labels)
    got = refine(prob, labels, device=CPU)
    _assert_same_result(got, want)
    st = got.stats["refine"]
    assert (st["rounds"], st["moves"], st["converged"]) == (1, 0, True)
    np.testing.assert_array_equal(got.labels, labels)


@pytest.mark.parametrize("k", [2, 9, 40])
def test_refine_with_empty_blocks_and_relabelled_ids(k):
    """Half the blocks empty, then the same labels under a permutation
    of the block ids: equal to the reference, and equivariant."""
    prob, rp = _problems("delaunay2d", 600, k, seed=k)
    labels = _labels(prob.n, k, seed=k, used=max(k // 2, 1))
    sigma = np.random.default_rng(k).permutation(k)
    a = refine(prob, labels, device=CPU)
    b = refine(prob, sigma[labels], device=CPU)
    _assert_same_result(a, ref_refine(rp, labels))
    _assert_same_result(b, ref_refine(rp, sigma[labels]))
    np.testing.assert_array_equal(sigma[a.labels], b.labels)


def test_budget_helpers_equal_reference():
    for weighted in (False, True):
        prob, rp = _problems("climate25d" if weighted else "tri", 300, 5,
                             seed=1)
        labels = _labels(prob.n, 5, seed=1)
        for eps in (None, 0.0, 0.1):
            iw, limit = refinement_quantization(prob, eps)
            r_iw, r_limit = ref_lp.refinement_quantization(rp, eps)
            np.testing.assert_array_equal(iw, r_iw)
            assert limit == r_limit
            iw, budget = refinement_budgets(prob, labels, eps)
            r_iw, r_budget = ref_lp.refinement_budgets(rp, labels, eps)
            np.testing.assert_array_equal(budget, r_budget)
            assert budget.dtype == r_budget.dtype
        with pytest.raises(ValueError, match="eps"):
            refinement_quantization(prob, eps=-0.1)


def test_canonicalize_and_keys_equal_reference():
    prob, rp = _problems("rggpow", 300, 8, seed=5)
    labels = _labels(prob.n, 8, seed=5, used=6)
    for order in (None, np.random.default_rng(1).permutation(prob.n)):
        keys = lp._node_keys(prob, order)
        np.testing.assert_array_equal(keys, ref_lp._node_keys(rp, order))
        got = lp._canonicalize(labels, keys, 8)
        want = ref_lp._canonicalize(labels, keys, 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_the_unbalanced_aniso_instance():
    """ROADMAP queue 3: geographer ends this instance at imbalance
    0.06499991 > eps; refinement only moves into blocks with room, so it
    brings it down (to ~0.035), the same bits as the reference's."""
    m = meshes.REGISTRY["aniso"](400, seed=278670)
    prob = PartitionProblem.from_mesh(m, k=6, seed=278670)
    rp = RefProblem.from_mesh(ref_meshes.REGISTRY["aniso"](400,
                                                           seed=278670),
                              k=6, seed=278670)
    base = partition(prob, device=CPU)
    want = ref_partition(rp, refine=True)
    got = partition(prob, device=CPU, refine=True)
    assert base.imbalance() == pytest.approx(0.06499991, abs=1e-6)
    _assert_same_result(got, want)
    assert got.imbalance() == pytest.approx(0.035, abs=2e-3)
    assert got.imbalance() < base.imbalance()


# ---------------------------------------------------------------------------
# the front doors

@pytest.mark.parametrize("method", ["sfc", "rcb", "geographer"])
def test_partition_refine_composition(method):
    prob, rp = _problems("tri", 300, 6, seed=2)
    base = partition(prob, method=method, device=CPU)
    comp = partition(prob, method=method, device=CPU, refine=True,
                     refine_eps=0.05)
    assert comp.method == f"{base.method}+lp"
    _assert_same_result(comp, refine(prob, base, device=CPU, eps=0.05))
    want = ref_refine(rp, np.asarray(base.labels), eps=0.05)
    np.testing.assert_array_equal(comp.labels, want.labels)
    assert comp.stats["refine"] == want.stats["refine"]
    if method != "geographer":        # host baselines: the same base bits
        _assert_same_result(comp, ref_partition(rp, method=method,
                                                refine="lp",
                                                refine_eps=0.05))
    off = partition(prob, method=method, device=CPU, refine=False)
    assert off.method == method and "refine" not in off.stats


def test_partition_hierarchy_then_refine():
    prob, rp = _problems("delaunay2d", 800, 4, seed=3)
    base = partition(prob, device=CPU, hierarchy=(2, 2))
    got = partition(prob, device=CPU, hierarchy="2x2", refine=True)
    assert got.method == f"{base.method}+lp"
    want = ref_refine(rp, np.asarray(base.labels))
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.stats["refine"] == want.stats["refine"]
    assert got.stats["k1"] == 2 and got.imbalance() <= prob.epsilon + 1e-6


def test_repartition_refines_before_migration_accounting():
    prob, rp = _problems("tri", 300, 6, seed=4)
    ref_prev = ref_partition(rp)
    prev = result_from_numpy(prob, ref_prev.labels, ref_prev.centers,
                             ref_prev.influence)
    w = np.random.default_rng(5).uniform(0.5, 1.5, prob.n)
    prob2, rp2 = prob.replace(weights=w), rp.replace(weights=w)
    base = repartition(prob2, prev, device=CPU)
    got = repartition(prob2, prev, device=CPU, refine=True)
    want = ref_repartition(rp2, ref_prev, refine=True)
    assert got.method.endswith("+lp") and "migration" in got.stats
    np.testing.assert_array_equal(base.labels,
                                  ref_repartition(rp2, ref_prev).labels)
    _assert_same_result(got, want)
    # migration is measured on the refined labels
    expect = metrics.migration_fraction(prev.labels, got.labels, w)
    assert got.stats["migration"]["fraction"] == pytest.approx(expect)
    assert got.stats["migration"] == pytest.approx(
        want.stats["migration"])
    cold = repartition(prob2, prev, "rcb", device=CPU, refine=True)
    want = ref_repartition(rp2, ref_prev, "rcb", refine=True)
    _assert_same_result(cold, want)


def test_result_refine_and_plumbing():
    prob, rp = _problems("tri", 200, 4, seed=0)
    labels = _labels(prob.n, 4, seed=0)
    res = partition(prob, method="sfc", device=CPU)
    out = res.refine(device=CPU)
    assert isinstance(out, PartitionResult) and out.method == "sfc+lp"
    _assert_same_result(out, ref_partition(rp, method="sfc").refine())
    st = out.stats["refine"]
    assert st["method"] == "label_prop" and st["devices"] is None
    assert st["eps"] == prob.epsilon
    assert refine(prob, labels, device=CPU).method == "labels+lp"
    ev = refine(prob, res, device=CPU, evaluate=True)
    assert ev.quality is not None and "totalCommVol" in ev.quality
    assert ev.quality == ref_refine(rp, ref_partition(rp, method="sfc"),
                                    evaluate=True).quality
    assert resolve_refiner("lp") == resolve_refiner("labelprop") == \
        resolve_refiner(True) == "label_prop"
    assert available_refiners() == ["label_prop"]
    assert refiner_short_name("label_prop") == "lp"
    with pytest.raises(UnknownRefinerError):
        refine(prob, res, "nope", device=CPU)
    with pytest.raises(UnknownRefinerError):
        partition(prob, method="sfc", device=CPU, refine="nope")
    with pytest.raises(UnknownRefinerError):
        repartition(prob, res, device=CPU, refine="nope")


def _error_cases(Problem, Result, refine_fn, **kw):
    """The reference's error paths, as (name, call) pairs."""
    mesh = ref_meshes.REGISTRY["tri"](150, seed=0)
    prob = Problem.from_mesh(mesh, k=4, seed=0)
    labels = np.zeros(prob.n, np.int64)
    nograph = Problem(points=prob.points, k=4, seed=0)
    return {
        "nograph": lambda: refine_fn(nograph, labels, **kw),
        "type": lambda: refine_fn("not a problem", labels, **kw),
        "labels": lambda: refine_fn(prob, labels[:-1], **kw),
        "max_rounds": lambda: refine_fn(prob, labels, max_rounds=0, **kw),
        "unique": lambda: refine_fn(prob, labels, **kw,
                                    node_order=np.zeros(prob.n, np.int64)),
        "shape": lambda: refine_fn(prob, labels, **kw,
                                   node_order=np.arange(prob.n - 1)),
        "int32": lambda: refine_fn(
            prob, labels, **kw,
            node_order=np.arange(prob.n, dtype=np.int64) + 2 ** 40),
        "eps": lambda: refine_fn(prob, labels, eps=-0.5, **kw),
        "no_problem": lambda: Result(labels=labels, k=4,
                                     method="x").refine(**kw),
    }


@pytest.mark.parametrize("case", ["eps", "int32", "labels", "max_rounds",
                                  "no_problem", "nograph", "shape", "type",
                                  "unique"])
def test_refine_error_paths(case):
    def raised(call):
        try:
            call()
        except Exception as e:          # noqa: BLE001 - the type is the test
            return type(e), str(e)
        return None, ""

    from repro.partition import PartitionResult as RefResult
    want = raised(_error_cases(RefProblem, RefResult, ref_refine)[case])
    got = raised(_error_cases(PartitionProblem, PartitionResult, refine,
                              device=CPU)[case])
    assert want[0] is not None and got[0] is want[0]
    assert got[1] == want[1]


def test_sharded_options_raise_and_the_default_device(monkeypatch):
    """The sharded options run (``tests/test_torch_refine_sharded.py``
    holds them against the reference's): ``devices=`` on every front door
    refines to the single-device labels, and ``graph=`` without
    ``devices=`` is ignored, as in the reference. Without a card every
    front door raises instead of running on the CPU."""
    prob, rp = _problems("tri", 200, 4, seed=0)
    labels = _labels(prob.n, 4, seed=0)
    res = partition(prob, method="sfc", device=CPU)
    single = refine(prob, labels, device=CPU)

    def ranks(fn, *args, **kwargs):
        return launch.launch(fn, 2, args=args, kwargs=kwargs, device=CPU,
                             threads=True, timeout=120)

    ignored = refine(prob, labels, device=CPU, graph=object())
    _assert_same_result(ignored, single)
    _assert_same_result(ref_refine(rp, labels, graph=object()),
                        ref_refine(rp, labels))
    sharded = ranks(refine, prob, labels, device=CPU, devices=2)
    np.testing.assert_array_equal(sharded.labels, single.labels)
    assert sharded.stats["refine"] == dict(single.stats["refine"],
                                           devices=2)
    out, info = ranks(lp.label_prop_refine, prob, labels, device=CPU,
                      devices=2)
    np.testing.assert_array_equal(out, single.labels)
    np.testing.assert_array_equal(
        ranks(res.refine, device=CPU, devices=2).labels,
        res.refine(device=CPU).labels)
    solved = ranks(partition, prob, device=CPU, devices=2)
    np.testing.assert_array_equal(
        ranks(partition, prob, device=CPU, devices=2, refine=True).labels,
        refine(prob, solved, device=CPU).labels)
    step = ranks(repartition, prob, res, device=CPU, devices=2)
    np.testing.assert_array_equal(
        ranks(repartition, prob, res, device=CPU, devices=2,
              refine=True).labels,
        refine(prob, step, device=CPU).labels)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: refine(prob, labels),
                 lambda: res.refine(),
                 lambda: lp._lp_rounds(
                     *_round_inputs(rp, labels, np.arange(prob.n)), 4),
                 lambda: partition(prob, method="sfc", refine=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
