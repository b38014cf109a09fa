"""The port's multi-device path against the reference's, on the CPU.

The port runs one rank per process (or, here, per thread: gloo groups
over one in-memory store, ``dist.launch.launch(..., threads=True)``); the
reference runs ``shard_map`` over 8 virtual host devices. Contracts:
- the deal (``gather``, ``valid``, points, weights, ``deal``,
  ``scatter_labels``), the streamed deal against the one-shot deal, a
  rank's own shard, ``check_index_capacity`` and its error: exact;
- the int32 Hilbert keys: exact; the ``bootstrap="device"`` centers:
  equal with unit weights, within ``BOOT_TOL`` (a fraction of the box)
  with lognormal weights, whose float32 bucket sums the port adds in
  another order;
- ``devices=1``: bit-equal to ``partition()``; ``(2, 2)`` bit-equal to
  ``4``; ``devices=P`` (P = 2, 4) with ``warmup=False``: at least
  ``AGREE`` of the labels equal to the reference's ``devices=P`` (the
  contract of ``test_geographer_matches_reference_across_zoo``), and
  balanced with the default warm-up;
- ``repartition``, ``simulate_loadbalance``, ``hierarchy`` and
  ``sharded_batched_balanced_kmeans`` with ``devices=``;
- the launcher: the backend rule, errors and deadlines (every multi-rank
  run here has its own deadline, ``DEADLINE`` seconds).

The reference's sharded calls run with its ``DeprecationWarning`` of the
``shard_map`` import silenced (``reference_calls``; ROADMAP.md, queue 3
item 3).
"""
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch
from reference_calls import reference as _reference

from repro.core import meshes as ref_meshes
from repro.core.balanced_kmeans import BKMConfig as RefBKMConfig
from repro.core.sfc import hilbert_index_jnp
from repro.core.sfc import sfc_initial_centers_sharded as ref_boot
from repro.partition import PartitionProblem as RefProblem
from repro.partition import partition as ref_partition
from repro.partition import repartition as ref_repartition
from repro.partition.batched import \
    batched_balanced_kmeans as ref_batched
from repro.partition.distributed import \
    ShardedPartitionProblem as RefSharded
from repro.partition.distributed import \
    check_index_capacity as ref_capacity
from repro_torch.convert import result_from_numpy
from repro_torch.core import meshes
from repro_torch.core.balanced_kmeans import BKMConfig
from repro_torch.core.sfc import hilbert_index_int32
from repro_torch.core.timeseries import simulate_loadbalance
from repro_torch.dist import Communicator, launch, rules
from repro_torch.dist.comm import current
from repro_torch.partition import (PartitionProblem, partition,
                                   repartition, supports_devices)
from repro_torch.partition import batched as port_batched
from repro_torch.partition.distributed import (ShardedPartitionProblem,
                                               check_index_capacity,
                                               deal_shard,
                                               partition_sharded)

torch.set_num_threads(1)

CPU = "cpu"
EPS = 0.03
AGREE = 0.99
BOOT_TOL = 1e-6
DEADLINE = 120.0


def _ranks(fn, nranks, *args, **kwargs):
    """``fn(*args, **kwargs)`` on ``nranks`` thread ranks (gloo, CPU),
    rank 0's value, within ``DEADLINE`` seconds."""
    return launch.launch(fn, nranks, args=args, kwargs=kwargs, device=CPU,
                         threads=True, timeout=DEADLINE)


def _points(n, d=3, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, d))


def _problems(n=2400, k=8, d=3, seed=0, weights=None):
    pts = _points(n, d, seed)
    return (PartitionProblem(points=pts, k=k, weights=weights, epsilon=EPS,
                             seed=seed),
            RefProblem(points=pts, k=k, weights=weights, epsilon=EPS,
                       seed=seed))


def _size(devices):
    return rules.mesh_size(devices)


# ---------------------------------------------------------------------------
# the deal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("devices", [1, 3, 4, (2, 2)])
@pytest.mark.parametrize("chunk", [None, 5])
def test_deal_equals_reference(devices, chunk):
    w = np.random.default_rng(3).lognormal(0.0, 0.5, 103)
    pts = _points(103, 2, seed=3).astype(np.float32)
    port = ShardedPartitionProblem.from_problem(
        PartitionProblem(points=pts, k=4, weights=w, seed=7), devices,
        chunk=chunk)
    ref = RefSharded.from_problem(
        RefProblem(points=pts, k=4, weights=w, seed=7), devices, chunk=chunk)
    assert port.devices == ref.devices and port.cap == ref.cap
    for name in ("points", "weights", "gather", "valid"):
        a, b = getattr(port, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    values = np.arange(103) * 3
    np.testing.assert_array_equal(port.deal(values, chunk=chunk),
                                  ref.deal(values, chunk=chunk))
    labels = port.deal(np.random.default_rng(1).integers(0, 4, 103))
    np.testing.assert_array_equal(port.scatter_labels(labels, chunk=chunk),
                                  ref.scatter_labels(labels, chunk=chunk))


def test_streamed_deal_equals_one_shot_and_a_rank_builds_its_own_shard():
    prob, _ = _problems(n=1001, d=3, seed=2)
    whole = ShardedPartitionProblem.from_problem(prob, 3)
    for chunk in (1, 7, 334, 10_000):
        part = ShardedPartitionProblem.from_problem(prob, 3, chunk=chunk)
        for name in ("points", "weights", "gather", "valid"):
            np.testing.assert_array_equal(getattr(part, name),
                                          getattr(whole, name))
    for p in range(3):
        for chunk in (None, 9):
            pts, w, gather, valid = deal_shard(prob, 3, p, chunk=chunk)
            np.testing.assert_array_equal(pts, whole.points[p])
            np.testing.assert_array_equal(w, whole.weights[p])
            np.testing.assert_array_equal(gather, whole.gather[p])
            np.testing.assert_array_equal(valid, whole.valid[p])
    pts, w, *_ = deal_shard(prob, 3, 1, dtype=np.float32)
    assert pts.dtype == w.dtype == np.float32
    with pytest.raises(ValueError, match="shard"):
        deal_shard(prob, 3, 3)


def test_index_capacity_and_its_error_equal_reference():
    limit = np.iinfo(np.int32).max
    for n, devices in ((10, 3), (2 * limit, 2), (limit, (1, 1))):
        assert check_index_capacity(n, devices) == ref_capacity(n, devices)
    for n, devices in ((limit + 1, 1), (3 * limit, (1, 2))):
        with pytest.raises(ValueError) as port_err:
            check_index_capacity(n, devices)
        with pytest.raises(ValueError) as ref_err:
            ref_capacity(n, devices)
        assert str(port_err.value) == str(ref_err.value)
    prob, _ = _problems(n=10)
    for bad in (0, 11, (2, 0), (1, 2, 3)):
        with pytest.raises(ValueError):
            ShardedPartitionProblem.from_problem(prob, bad)


def test_problem_views():
    mesh = meshes.REGISTRY["tri"](300, seed=1)
    prob = PartitionProblem.from_mesh(mesh, k=4)
    sp = prob.to_sharded(3, chunk=11)
    ref = RefProblem.from_mesh(ref_meshes.REGISTRY["tri"](300, seed=1),
                               k=4).to_sharded(3, chunk=11)
    np.testing.assert_array_equal(sp.gather, ref.gather)
    np.testing.assert_array_equal(sp.points, ref.points)
    graph = prob.to_sharded_graph(3)
    assert graph.devices == 3 and graph.problem is prob


# ---------------------------------------------------------------------------
# int32 Hilbert keys and the distributed bootstrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [2, 3])
def test_int32_keys_equal_reference(d):
    import jax.numpy as jnp
    pts = _points(5000, d, seed=d).astype(np.float32)
    lo, hi = pts.min(0) - 0.25, pts.max(0) + 0.5      # a wider global box
    want = np.asarray(hilbert_index_jnp(jnp.asarray(pts)))
    got = hilbert_index_int32(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(hilbert_index_jnp(jnp.asarray(pts), lo=jnp.asarray(lo),
                                        hi=jnp.asarray(hi)))
    got = hilbert_index_int32(torch.from_numpy(pts), lo=torch.from_numpy(lo),
                              hi=torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def _ref_device_centers(sp, k):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.dist.rules import partition_mesh
    cap, dim = sp.cap, sp.points.shape[2]

    def local(p, w):
        return ref_boot(p.reshape(cap, dim), w.reshape(cap), k, "shard")

    fn = shard_map(local, mesh=partition_mesh(sp.devices),
                   in_specs=(P("shard"), P("shard")), out_specs=P(),
                   check_rep=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(sp.points, jnp.float32),
                                  jnp.asarray(sp.weights, jnp.float32)))


def _port_device_centers(prob, k):
    from repro_torch.core.sfc import sfc_initial_centers_sharded
    comm = current()
    pts, w, _, _ = deal_shard(prob, comm.size, comm.rank, dtype=np.float32)
    return sfc_initial_centers_sharded(torch.from_numpy(pts),
                                       torch.from_numpy(w), k,
                                       comm).numpy()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [2, 3])
def test_device_bootstrap_centers_equal_reference(weighted, d):
    n, k, P = 3001, 16, 4
    w = (np.random.default_rng(5).lognormal(0.0, 0.5, n) if weighted
         else None)
    prob, rprob = _problems(n=n, k=k, d=d, seed=4, weights=w)
    want = _reference(_ref_device_centers, RefSharded.from_problem(rprob, P),
                      k)
    got = _ranks(_port_device_centers, P, prob, k)
    if weighted:
        np.testing.assert_allclose(got, want, rtol=0, atol=BOOT_TOL)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# partition(devices=)
# ---------------------------------------------------------------------------

def test_registry_declares_the_multi_device_path():
    assert supports_devices("geographer") and supports_devices("bkm")
    assert not supports_devices("rcb")
    prob, _ = _problems(n=200)
    with pytest.raises(ValueError, match="multi-device"):
        partition(prob, method="rcb", device=CPU, devices=2)
    for bad in ({"bootstrap": "host"}, {"chunk": 8}):
        with pytest.raises(TypeError):
            partition(prob, device=CPU, **bad)


@pytest.mark.parametrize("weighted", [False, True])
def test_devices_one_equals_partition_bit_for_bit(weighted):
    w = np.random.default_rng(2).lognormal(0.0, 0.5, 2400) if weighted \
        else None
    prob, _ = _problems(weights=w)
    single = partition(prob, device=CPU)
    one = _ranks(partition, 1, prob, device=CPU, devices=1)
    np.testing.assert_array_equal(one.labels, single.labels)
    np.testing.assert_array_equal(one.centers, single.centers)
    np.testing.assert_array_equal(one.influence, single.influence)
    assert one.stats["devices"] == 1 and one.stats["backend"] == "gloo"
    assert one.problem is prob


@pytest.mark.parametrize("devices", [2, 4])
def test_sharded_agrees_with_reference_sharded(devices):
    prob, rprob = _problems(n=3000, k=8)
    ref = _reference(ref_partition, rprob, devices=devices, warmup=False)
    got = _ranks(partition, _size(devices), prob, device=CPU,
                 devices=devices, warmup=False)
    agree = float(np.mean(got.labels == ref.labels))
    assert agree >= AGREE, agree
    assert got.imbalance() <= EPS + 1e-6
    assert got.stats["devices"] == devices
    lvl = got.stats["levels"][0]
    # the sweeps' all-reduces plus the bootstrap's none ("host")
    assert lvl["collectives"]["all_reduces"] > lvl["iters"]


def test_mesh_2d_equals_flat_and_default_warmup_balances():
    prob, _ = _problems(n=3000, k=8, seed=1)
    flat = _ranks(partition, 4, prob, device=CPU, devices=4)
    mesh = _ranks(partition, 4, prob, device=CPU, devices=(2, 2))
    again = _ranks(partition, 4, prob, device=CPU, devices=4)
    for other in (mesh, again):
        np.testing.assert_array_equal(other.labels, flat.labels)
        np.testing.assert_array_equal(other.centers, flat.centers)
        np.testing.assert_array_equal(other.influence, flat.influence)
    assert mesh.stats["devices"] == [2, 2]
    assert flat.imbalance() <= EPS + 1e-6
    assert len(np.unique(flat.labels)) == prob.k


def test_streamed_deal_and_device_bootstrap_solve():
    w = np.random.default_rng(8).lognormal(0.0, 0.5, 2501)
    prob, rprob = _problems(n=2501, k=8, weights=w)
    whole = _ranks(partition, 3, prob, device=CPU, devices=3)
    chunked = _ranks(partition, 3, prob, device=CPU, devices=3, chunk=100)
    np.testing.assert_array_equal(chunked.labels, whole.labels)
    boot = _ranks(partition, 4, prob, device=CPU, devices=4,
                  bootstrap="device")
    ref = _reference(ref_partition, rprob, devices=4, bootstrap="device")
    assert boot.imbalance() <= EPS + 1e-6 and ref.imbalance() <= EPS + 1e-6
    assert len(np.unique(boot.labels)) == prob.k
    assert boot.stats["bootstrap"] == "device"


def test_partition_sharded_returns_the_same_result_on_every_rank():
    prob, _ = _problems(n=900, k=4)

    def every_rank():
        res = partition_sharded(prob, 3, device=CPU, max_iter=5)
        comm = current()
        # the labels' sum and their spread over the ranks
        s = torch.tensor([int(res.labels.sum())])
        return (comm.all_reduce(s, "max").item(),
                comm.all_reduce(s, "min").item(), int(res.labels.sum()))

    hi, lo, mine = _ranks(every_rank, 3)
    assert hi == lo == mine


# ---------------------------------------------------------------------------
# repartition, the time series, hierarchy, the split lanes
# ---------------------------------------------------------------------------

def test_repartition_sharded_against_reference():
    pts = _points(2000, 2, seed=6)
    wl = ref_meshes.WORKLOADS["drifting_hotspot"]()
    w0, w1 = (np.asarray(wl.weights_at(pts, t)) for t in (0, 1))
    rprev = _reference(ref_partition, RefProblem(points=pts, k=8,
                                                 weights=w0), devices=2)
    rprob = RefProblem(points=pts, k=8, weights=w1)
    ref = _reference(ref_repartition, rprob, rprev, devices=2)
    prob = PartitionProblem(points=pts, k=8, weights=w1)
    prev = result_from_numpy(prob.replace(weights=w0), rprev.labels,
                             rprev.centers, rprev.influence)
    got = _ranks(repartition, 2, prob, prev, device=CPU, devices=2)
    one = _ranks(repartition, 1, prob, prev, device=CPU, devices=1)
    single = repartition(prob, prev, device=CPU)
    np.testing.assert_array_equal(one.labels, single.labels)
    assert got.stats["warm_start"] and got.stats["iters"] == \
        ref.stats["iters"]
    assert float(np.mean(got.labels == ref.labels)) >= AGREE
    assert got.imbalance() <= EPS + 1e-6
    assert got.stats["migration"]["fraction"] == pytest.approx(
        ref.stats["migration"]["fraction"], abs=0.01)
    # an unchanged problem is a strict fixed point on the sharded path
    fixed = _ranks(repartition, 2, got.problem, got, device=CPU, devices=2)
    assert fixed.stats["iters"] == 0
    np.testing.assert_array_equal(fixed.labels, got.labels)


def test_simulate_loadbalance_sharded():
    prob, _ = _problems(n=1500, k=4, d=2, seed=3)
    wl = meshes.DriftingHotspot()
    got = _ranks(simulate_loadbalance, 2, prob, wl, 2, device=CPU,
                 devices=2)
    one = _ranks(simulate_loadbalance, 1, prob, wl, 2, device=CPU,
                 devices=1)
    single = simulate_loadbalance(prob, wl, 2, device=CPU)
    for a, b in zip(one["per_step"], single["per_step"]):
        assert a["iters"] == b["iters"]
        assert a["migration_fraction"] == b["migration_fraction"]
    assert got["devices"] == 2 and got["summary"]["all_balanced"]
    assert len(got["per_step"]) == 2


def test_hierarchy_over_the_mesh():
    prob, rprob = _problems(n=2400, k=16, d=2, seed=9)
    flat = _ranks(partition, 4, prob, device=CPU, hierarchy=(4, 4),
                  devices=4)
    mesh = _ranks(partition, 4, prob, device=CPU, hierarchy=(4, 4),
                  devices=(2, 2))
    np.testing.assert_array_equal(mesh.labels, flat.labels)
    np.testing.assert_array_equal(mesh.centers, flat.centers)
    lv = mesh.stats["levels"]
    assert lv[0]["devices"] == [2, 2] and lv[1]["refine_devices"] == [2, 2]
    assert flat.stats["levels"][1]["refine_devices"] is None
    assert mesh.imbalance() <= EPS + 1e-6
    ref = _reference(ref_partition, rprob, hierarchy=(4, 4), devices=(2, 2))
    assert ref.imbalance() <= EPS + 1e-6
    # the reference composes its coarse near-ties (ROADMAP.md queue 3
    # item 10): the coarse labels are held, not the composition
    got_coarse, ref_coarse = flat.labels // 4, ref.labels // 4
    assert float(np.mean(got_coarse == ref_coarse)) >= AGREE


@pytest.mark.parametrize("p2,lanes", [(2, 4), (3, 4), (2, 1)])
def test_split_lanes_equal_batched_bit_for_bit(p2, lanes):
    rng = np.random.default_rng(lanes)
    pts = rng.uniform(0, 1, (lanes, 200, 2))
    w = rng.uniform(0.5, 1.5, (lanes, 200))
    w[:, 190:] = 0.0                        # padded slots at weight 0
    c0 = pts[:, :5]
    cfg = BKMConfig(k=5, warmup=False, max_iter=8)
    want = port_batched.batched_balanced_kmeans(pts, w, c0, cfg,
                                                device=CPU)
    got = _ranks(port_batched.sharded_batched_balanced_kmeans, 2 * p2, pts,
                 w, c0, cfg, devices=(2, p2), device=CPU)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    for key, val in want[3].items():
        if isinstance(val, dict):
            for name in val:
                assert torch.equal(got[3][key][name], val[name])
        else:
            assert torch.equal(got[3][key], val), key
    ref = ref_batched(pts, w, c0, RefBKMConfig(k=5, warmup=False,
                                               max_iter=8))
    agree = float(np.mean(got[0].numpy() == np.asarray(ref[0])))
    assert agree >= AGREE
    with pytest.raises(ValueError, match="P1, P2"):
        port_batched.sharded_batched_balanced_kmeans(
            pts, w, c0, cfg, devices=2, device=CPU)


# ---------------------------------------------------------------------------
# the launcher and the communicator
# ---------------------------------------------------------------------------

def test_backend_rule_and_rank_devices():
    assert launch.choose_backend(CPU, 4) == "gloo"
    assert launch.choose_backend(CPU, 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="card per rank"):
        launch.choose_backend(CPU, 1, "nccl")
    with pytest.raises(ValueError, match="backend"):
        launch.choose_backend(CPU, 1, "mpi")
    assert launch.rank_device(CPU, 3) == torch.device(CPU)
    assert launch.rank_device("cuda:1", 3) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="threads"):
        launch.launch(time.sleep, 1, args=(0,), device="cuda",
                      backend="gloo", threads=True)


def _mesh_facts():
    comm = current()
    mesh = rules.partition_mesh2d(2, 2)
    row = mesh.refine_group()
    total = mesh.all_reduce(torch.tensor([comm.rank + 1.0]))
    row_max = row.all_reduce(torch.tensor([comm.rank]), "max")
    flags = mesh.all_reduce(torch.tensor([comm.rank == 2]), "max")
    return (mesh.shape, mesh.coarse_index, mesh.refine_index, row.size,
            total.item(), row_max.item(), flags.dtype, bool(flags),
            rules.partition_mesh().shape, mesh.counters()["all_reduces"])


def test_communicator_mesh_views():
    facts = _ranks(_mesh_facts, 4)
    assert facts == ((2, 2), 0, 0, 2, 10.0, 1, torch.bool, True, (4,), 2)
    with pytest.raises(ValueError, match="needs 3 ranks"):
        _ranks(rules.comm_for, 2, 3)
    with pytest.raises(RuntimeError, match="not a rank"):
        rules.partition_mesh()
    assert rules.comm_for(2) is None
    with pytest.raises(ValueError, match="op must be"):
        Communicator(None, 0, 1, backend="gloo").all_reduce(
            torch.ones(1), "mean")
    with pytest.raises(ValueError, match="does not cover"):
        Communicator(None, 0, 4, backend="gloo", shape=(3, 2))


def _fails_on_rank_one():
    comm = current()
    if comm.rank == 1:
        raise KeyError("rank one fails on purpose")
    comm.all_reduce(torch.ones(1))        # the others wait for rank 1
    return comm.rank


def test_thread_ranks_raise_the_first_error_at_once():
    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="on purpose") as err:
        # a short timeout: the freed ranks' gloo operations linger until it
        launch.launch(_fails_on_rank_one, 3, device=CPU, threads=True,
                      timeout=5)
    assert time.perf_counter() - t0 < 4
    assert isinstance(err.value.__cause__, launch.RankError)


def test_spawned_ranks_from_the_front_door(monkeypatch):
    """Outside a process group ``partition(devices=2)`` spawns its ranks;
    the result equals the thread ranks' and carries the caller's
    problem."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", DEADLINE)
    prob, _ = _problems(n=1200, k=4)
    spawned = partition(prob, device=CPU, devices=2)
    threads = _ranks(partition, 2, prob, device=CPU, devices=2)
    np.testing.assert_array_equal(spawned.labels, threads.labels)
    np.testing.assert_array_equal(spawned.centers, threads.centers)
    assert spawned.problem is prob
    assert not multiprocessing.active_children()


def test_spawned_rank_errors_and_deadline():
    prob, _ = _problems(n=200, k=4)
    t0 = time.perf_counter()
    with pytest.raises(TypeError, match="unknown BKMConfig") as err:
        launch.launch(partition, 2, args=(prob,),
                      kwargs={"device": CPU, "devices": 2, "bogus": 1},
                      device=CPU, timeout=DEADLINE)
    assert isinstance(err.value.__cause__, launch.RankError)
    assert "Traceback" in str(err.value.__cause__)
    with pytest.raises(TimeoutError, match="exceeded"):
        launch.launch(time.sleep, 2, args=(60,), device=CPU, timeout=8)
    # a rank that dies without a word
    with pytest.raises(launch.RankError, match="exit code 3"):
        launch.launch(os._exit, 2, args=(3,), device=CPU, timeout=DEADLINE)
    assert time.perf_counter() - t0 < 50
    assert not multiprocessing.active_children()
