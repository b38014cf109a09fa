"""The port's distributed partitioner (``core/partitioner.py``:
``make_distributed_partitioner`` and the SFC redistribution under it) and
the communicator's ``all_gather`` / ``all_to_all``, against the reference
on the CPU.

The port's ranks are threads with their own gloo groups over one
in-memory store (``dist.launch.launch(..., threads=True)``); the
reference runs ``shard_map`` over the first P of 8 virtual host devices,
or ``jax.vmap`` with an axis name. Contracts:
- ``_sample_indices``: equal to ``jnp.linspace(0, n - 1, m)
  .astype(int32)`` (eager and under ``jit``) at every size tried,
  2^21 and 3 * 2^19 among them, where numpy's float64 ``linspace``
  differs;
- ``all_gather`` / ``all_to_all``: equal to a numpy model at P = 1, 2, 4
  for float32, int32 and bool, counted by kind; the all-reduces of a
  sharded solve keep their count;
- ``_sfc_redistribute``: every output bit-equal at P = 1, 2, 4, 8, in 2-D
  and 3-D, unit and lognormal weights, points away from the origin, and
  for curve-ordered input, where half the points are dropped (the
  reference's capacity rule, kept);
- ``_strided_centers``: bit-equal wherever k * N < 2^31; at k = 1024,
  N = 2^22 the reference's int32 positions wrap and leave 512 centers at
  the origin, where the port's int64 ones pick all 1024 points (ROADMAP.md
  queue 3 item 15, a deliberate departure);
- ``make_distributed_partitioner`` on the reference test's instance
  (n=16384, k=16, d=2, P=8, ``max_iter=20``): the redistribution
  bit-equal; with ``warmup=False`` at least ``AGREE`` of the labels equal
  to the reference's (the contract of ``test_torch_sharded.py``) and
  balanced to the reference test's 0.05; with the warm-up the two agree
  on at least ``AGREE`` of the labels after 5 iterations, their centers
  within ``CENTER_TOL`` (float sums in another order), and after 20 both
  balance to 0.05 and agree on at least ``AGREE_WARMUP``, the reference's
  own contract between ``devices=1`` and ``devices=P``: from there on the
  warm-up's clustered per-rank prefix samples let the trajectories drift
  apart (0.985 read on this instance), as the sharded tests of
  ``test_torch_sharded.py`` allow for;
- over a (2, 2) ``("data", "model")`` mesh sharded over ``data``: every
  replica bit-equal to ``devices=2``, and against the reference's
  partitioner on ``make_compat_mesh((2, 2), ("data", "model"))`` the
  redistribution bit-equal and the labels agreeing on at least ``AGREE``
  (``warmup=False``, as above).

The reference's sharded calls run with its ``DeprecationWarning`` of the
``shard_map`` import silenced (``reference_calls``; ROADMAP.md, queue 3
item 3).
"""
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as PS
from reference_calls import reference as _reference

from repro.core import partitioner as ref
from repro.core.balanced_kmeans import BKMConfig as RefBKMConfig
from repro.core.sfc import hilbert_index_jnp
from repro.launch.mesh import make_compat_mesh
from repro_torch.core import partitioner as port
from repro_torch.core.balanced_kmeans import BKMConfig
from repro_torch.dist import launch
from repro_torch.dist.comm import current
from repro_torch.launch.mesh import make_mesh
from repro_torch.partition import PartitionProblem, partition

torch.set_num_threads(1)

CPU = "cpu"
AGREE = 0.99
AGREE_WARMUP = 0.97
CENTER_TOL = 1e-5
DEADLINE = 120.0
AXIS = "data"


def _ranks(fn, nranks, *args, **kwargs):
    """``fn(*args, **kwargs)`` on ``nranks`` thread ranks (gloo, CPU),
    rank 0's value, within ``DEADLINE`` seconds."""
    return launch.launch(fn, nranks, args=args, kwargs=kwargs, device=CPU,
                         threads=True, timeout=DEADLINE)


def _every_rank(fn, nranks, *args):
    """``fn(comm, *args)`` on every thread rank; the list of their values
    in rank order (threads share this process, so each writes its own)."""
    out = [None] * nranks

    def body():
        comm = current()
        out[comm.rank] = fn(comm, *args)

    _ranks(body, nranks)
    return out


def _mesh(P):
    return Mesh(np.array(jax.devices()[:P]), (AXIS,))


def _shard(x, comm):
    rows = x.shape[0] // comm.size
    return x[comm.rank * rows:(comm.rank + 1) * rows]


def _numpy(values):
    return [v.numpy() if isinstance(v, torch.Tensor) else v for v in values]


def _instance(n, d, P, weights="unit", shift=0.0):
    rng = np.random.default_rng(100 * P + 10 * d + (weights != "unit"))
    pts = (rng.uniform(0.0, 1.0, (n, d)) + shift).astype(np.float32)
    w = (np.ones(n, np.float32) if weights == "unit" else
         rng.lognormal(0.0, 0.5, n).astype(np.float32))
    return pts, w


# ---------------------------------------------------------------------------
# the sample indices
# ---------------------------------------------------------------------------

SIZES = sorted(set(range(1, 2049)) | {2 ** 21, 3 * 2 ** 19, 2 ** 20,
                                      2 ** 22, 2 ** 23} |
               {int(s) for s in np.random.default_rng(0).integers(
                   2049, 1 << 24, 300)})


@pytest.mark.parametrize("oversample", [32, 2, 7, 64])
def test_sample_indices_equal_reference(oversample):
    linspace = jax.jit(lambda n: jnp.linspace(0, n - 1, oversample)
                       .astype(jnp.int32), static_argnums=0)
    differs64 = []
    for n in SIZES:
        want = np.asarray(jnp.linspace(0, n - 1, oversample)
                          .astype(jnp.int32))
        got = port._sample_indices(n, oversample)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")
        if n in (2 ** 21, 3 * 2 ** 19):
            np.testing.assert_array_equal(got, np.asarray(linspace(n)))
        if not np.array_equal(np.linspace(0, n - 1, oversample)
                              .astype(np.int32), want):
            differs64.append(n)
    if oversample == 32:
        # the sizes where a float64 linspace would pick other samples
        assert {2 ** 21, 3 * 2 ** 19} <= set(differs64)
    np.testing.assert_array_equal(port._sample_indices(5, 1), [0])
    with pytest.raises(ValueError, match="oversample"):
        port._sample_indices(5, 0)


# ---------------------------------------------------------------------------
# the communicator: all_gather and all_to_all
# ---------------------------------------------------------------------------

def _collect(comm):
    """Each rank's inputs (rank-dependent values, uneven across ranks),
    its all_gather and all_to_all of them, and the counters they moved."""
    P, r = comm.size, comm.rank
    rng = np.random.default_rng(r)
    x32 = rng.normal(0.0, 10.0 ** r, (3, 2)).astype(np.float32)
    xi = (rng.integers(-2 ** 31, 2 ** 31 - 1, 5 * P) // (r + 1)).astype(
        np.int32)
    xb = rng.random((2 * P, 3)) < 0.3 + 0.1 * r
    before = comm.counters()
    gathered = [comm.all_gather(torch.from_numpy(x))
                for x in (x32, xi, xb)]
    exchanged = [comm.all_to_all(torch.from_numpy(x))
                 for x in (x32.repeat(P, 0), xi, xb)]
    after = comm.counters()
    return ((x32, xi, xb), _numpy(gathered), _numpy(exchanged),
            {key: after[key] - before[key] for key in after})


@pytest.mark.parametrize("P", [1, 2, 4])
def test_all_gather_and_all_to_all_equal_numpy(P):
    out = _every_rank(_collect, P)
    inputs = [o[0] for o in out]
    for r, (_, gathered, exchanged, moved) in enumerate(out):
        for i, got in enumerate(gathered):
            want = np.stack([inputs[s][i] for s in range(P)])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        for i, got in enumerate(exchanged):
            src = [inputs[s][i].repeat(P, 0) if i == 0 else inputs[s][i]
                   for s in range(P)]
            m = src[0].shape[0] // P
            want = np.concatenate([src[s][r * m:(r + 1) * m]
                                   for s in range(P)])
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        x32, xi, xb = inputs[r]
        assert (moved["all_reduces"], moved["seconds"], moved["bytes"]) \
            == (0, 0.0, 0)
        assert moved["all_gathers"] == moved["all_to_alls"] == 3
        assert moved["all_gather_bytes"] == x32.nbytes + xi.nbytes + xb.size
        assert moved["all_to_all_bytes"] == \
            P * x32.nbytes + xi.nbytes + xb.size
        assert moved["all_gather_seconds"] > 0
        assert moved["all_to_all_seconds"] > 0


def test_all_to_all_refuses_uneven_chunks():
    def body(comm):
        with pytest.raises(ValueError, match="equal chunks"):
            comm.all_to_all(torch.zeros(3))
        return True

    assert _every_rank(body, 2) == [True, True]


def test_a_sharded_solve_counts_its_all_reduces_as_before():
    """``partition(devices=2)``: the all-reduces of the solve, one by one
    at the reference's call sites (the total weight and the box; a round's
    sampled weight, its balance iterations' sizes, their skips, the
    moments; the final pass; the pruned fraction; the labels home), and no
    other collective."""
    pts = np.random.default_rng(0).uniform(0.0, 1.0, (1200, 2))
    prob = PartitionProblem(points=pts, k=4, seed=0)
    res = _ranks(partition, 2, prob, device=CPU, devices=2, max_iter=6)
    st = res.stats["levels"][0]
    it = int(st["iters"])
    balance = int(st["history"]["balance_iters"][:it].sum())
    want = 3 + 4 * it + balance + int(st["final_balance_iters"]) + 1 + 1 + 1
    moved = st["collectives"]
    assert moved["all_reduces"] == want
    assert moved["all_gathers"] == moved["all_to_alls"] == 0
    assert moved["all_gather_bytes"] == moved["all_to_all_bytes"] == 0


# ---------------------------------------------------------------------------
# the redistribution
# ---------------------------------------------------------------------------

def _ref_redistribute(pts, w, P):
    """The reference's ``_sfc_redistribute`` on P shards of rows: its six
    outputs, each stacked over the shards."""
    from jax.experimental.shard_map import shard_map

    def local(p, w):
        return tuple(x[None] for x in
                     ref._sfc_redistribute(p, w, AXIS, P))

    fn = shard_map(local, mesh=_mesh(P), in_specs=(PS(AXIS, None),
                                                   PS(AXIS)),
                   out_specs=(PS(AXIS),) * 6, check_rep=False)
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(pts),
                                               jnp.asarray(w))]


def _port_redistribute(comm, pts, w):
    return _numpy(port._sfc_redistribute(
        torch.from_numpy(_shard(pts, comm)), torch.from_numpy(_shard(w, comm)),
        comm))


def _assert_redistribution_equal(got, want):
    names = ("points", "weights", "valid", "my_count", "my_offset",
             "n_dropped")
    for r, rank in enumerate(got):
        for name, a, b in zip(names, rank, want):
            a = np.asarray(a)
            assert a.shape == b[r].shape, (r, name)
            assert a.dtype == b[r].dtype or a.ndim == 0, (r, name)
            np.testing.assert_array_equal(a, b[r], err_msg=f"{r} {name}")


@pytest.mark.parametrize("weights,shift", [("unit", 0.0),
                                           ("lognormal", 5.0)])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_redistribution_equals_reference(P, d, weights, shift):
    pts, w = _instance(4096, d, P, weights, shift)
    want = _reference(_ref_redistribute, pts, w, P)
    got = _every_rank(_port_redistribute, P, pts, w)
    _assert_redistribution_equal(got, want)
    assert int(want[5][0]) == 0 and sum(g[3] for g in got) == 4096


def test_curve_ordered_input_drops_as_the_reference_does():
    """Points sorted by the reference's own key and dealt in contiguous
    blocks: each rank's points all go to about one rank, past its
    capacity of 2 * n_local / P, so half of them are dropped and only
    counted (finding 3; the reference's contract, kept)."""
    P = 4
    pts, w = _instance(4096, 2, P)
    pts = pts[np.argsort(np.asarray(hilbert_index_jnp(jnp.asarray(pts))),
                         kind="stable")]
    want = _reference(_ref_redistribute, pts, w, P)
    got = _every_rank(_port_redistribute, P, pts, w)
    _assert_redistribution_equal(got, want)
    assert int(got[0][5]) == 2048
    # random order loses none
    shuffled = np.random.default_rng(0).permutation(4096)
    got = _every_rank(_port_redistribute, P, pts[shuffled], w)
    assert int(got[0][5]) == 0


# ---------------------------------------------------------------------------
# the strided centers
# ---------------------------------------------------------------------------

def _ref_strided(pts, w, P, k):
    from jax.experimental.shard_map import shard_map

    def local(p, w):
        rp, rw, rv, cnt, off, _ = ref._sfc_redistribute(p, w, AXIS, P)
        return ref._strided_centers(rp, rw, rv, cnt, off, k, AXIS)

    fn = shard_map(local, mesh=_mesh(P), in_specs=(PS(AXIS, None),
                                                   PS(AXIS)),
                   out_specs=PS(), check_rep=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(pts), jnp.asarray(w)))


def _port_strided(comm, pts, w, k):
    rp, _, _, count, offset, _ = port._sfc_redistribute(
        torch.from_numpy(_shard(pts, comm)), torch.from_numpy(_shard(w, comm)),
        comm)
    return port._strided_centers(rp, count, offset, k, comm).numpy()


@pytest.mark.parametrize("P,k", [(1, 16), (2, 7), (4, 64), (8, 33)])
def test_strided_centers_equal_reference(P, k):
    pts, w = _instance(4096, 3, P, "lognormal", 2.0)
    want = _reference(_ref_strided, pts, w, P, k)
    got = _every_rank(_port_strided, P, pts, w, k)
    for rank in got:
        np.testing.assert_array_equal(rank, want)
    assert (want != 0).any(axis=1).all()


def test_strided_centers_int64_where_the_reference_wraps():
    """k = 1024, N = 2^22 on 4 shards (k * N = 2^32): the reference's
    int32 positions wrap from center 512 on, no rank owns them, and they
    stay at the origin; the port's int64 positions pick every point
    (ROADMAP.md queue 3 item 15). Point g is (g, 1, 2), so a center names
    its position."""
    P, k, n = 4, 1024, 1 << 22
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = np.arange(n)
    pts[:, 1:] = (1.0, 2.0)
    shards = pts.reshape(P, n // P, 3)
    count = np.full(P, n // P, np.int32)
    offset = (np.arange(P) * (n // P)).astype(np.int32)
    want = _reference(jax.vmap(
        lambda p, c, o: ref._strided_centers(p, None, None, c, o, k, AXIS),
        axis_name=AXIS), jnp.asarray(shards), jnp.asarray(count),
        jnp.asarray(offset))
    want = np.asarray(want)[0]
    zero = ~(want != 0).any(axis=1)
    assert zero.sum() == 512 and zero[512:].all()
    gpos = np.arange(k, dtype=np.int64) * n // k + n // (2 * k)
    np.testing.assert_array_equal(want[:512], pts[gpos[:512]])

    def body(comm):
        return port._strided_centers(torch.from_numpy(shards[comm.rank]),
                                     n // P, comm.rank * (n // P), k,
                                     comm).numpy()

    got = _every_rank(body, P)
    for rank in got:
        np.testing.assert_array_equal(rank, pts[gpos])
        np.testing.assert_array_equal(rank[:512], want[:512])


# ---------------------------------------------------------------------------
# make_distributed_partitioner
# ---------------------------------------------------------------------------

def _reference_instance():
    """``tests/test_distributed_partitioner.py``'s instance."""
    rng = np.random.default_rng(0)
    pts = np.asarray(jnp.asarray(rng.uniform(0, 1, (16384, 2)), jnp.float32))
    w = np.asarray(jnp.asarray(rng.uniform(0.5, 2.0, (16384,)),
                               jnp.float32))
    return pts, w


def _ref_run(pts, w, P, **cfg):
    run = ref.make_distributed_partitioner(_mesh(P),
                                           RefBKMConfig(**cfg))
    return [np.asarray(x) for x in run(jnp.asarray(pts), jnp.asarray(w))]


def _port_run(pts, w, P, **cfg):
    """The partitioner called inside thread ranks, each with its own rows;
    the global arrays all-gathered."""
    def body():
        comm = current()
        run = port.make_distributed_partitioner(P, BKMConfig(**cfg),
                                                device=CPU)
        A, rp, rv, centers, infl, imb, dropped, st = run(
            _shard(pts, comm), _shard(w, comm), return_stats=True)
        whole = [comm.all_gather(torch.from_numpy(x)).flatten(0, 1).numpy()
                 for x in (A, rp, rv)]
        return (*whole, centers, infl, imb, dropped, st)

    return _ranks(body, P)


@pytest.mark.parametrize("warmup,max_iter", [(False, 20), (True, 5),
                                            (True, 20)])
def test_partitioner_on_the_reference_instance(warmup, max_iter):
    pts, w = _reference_instance()
    P, k = 8, 16
    want = _reference(_ref_run, pts, w, P, k=k, max_iter=max_iter,
                      warmup=warmup)
    got = _port_run(pts, w, P, k=k, max_iter=max_iter, warmup=warmup)
    A, rp, rv, centers, infl, imb, dropped, st = got
    for a, b in zip((A, rp, rv, centers, infl), want):
        assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(rp, want[1])
    np.testing.assert_array_equal(rv, want[2])
    assert dropped == int(want[6]) == 0
    assert (A[~rv] == -1).all() and (want[0][~rv] == -1).all()
    agree = float(np.mean(A[rv] == want[0][rv]))
    drifted = warmup and max_iter > 5
    assert agree >= (AGREE_WARMUP if drifted else AGREE), agree
    if max_iter == 20:
        # the reference test's bound
        assert imb <= 0.05 and float(want[5]) <= 0.05
    else:
        np.testing.assert_allclose(centers, want[3], rtol=0, atol=CENTER_TOL)
    assert st["redistribution"]["cap"] == 2 * 16384 // P // P
    moved = st["collectives"]
    assert moved["all_to_alls"] == 4 and moved["all_gathers"] == 2


def test_inside_a_rank_run_returns_the_ranks_slice_of_the_launch():
    pts, w = _instance(2048, 3, 4, "lognormal")
    cfg = {"k": 8, "max_iter": 4}
    whole = _port_run(pts, w, 4, **cfg)

    def body():
        return port._partition_launched(pts, w, BKMConfig(**cfg), device=CPU,
                                        return_stats=False)

    launched = _ranks(body, 4)
    for a, b in zip(launched, whole):
        np.testing.assert_array_equal(a, b)


def test_spawned_ranks_from_the_entry_point(monkeypatch):
    """Outside a process group ``run`` spawns its ranks (two processes)
    and returns the global result, equal to the thread ranks'."""
    monkeypatch.setattr(launch, "DEFAULT_TIMEOUT", DEADLINE)
    pts, w = _instance(2048, 2, 2, "lognormal", 1.0)
    cfg = {"k": 6, "max_iter": 5}
    run = port.make_distributed_partitioner(2, BKMConfig(**cfg), device=CPU)
    spawned = run(pts, w)
    threads = _port_run(pts, w, 2, **cfg)
    assert len(spawned) == 7
    for a, b in zip(spawned, threads):
        np.testing.assert_array_equal(a, b)
    assert not multiprocessing.active_children()


def test_mesh_and_uneven_rows_raise(monkeypatch):
    """A mesh without the axis to shard over raises (a (P1, P2) mesh is
    taken since the 2-D mesh was ported: its parity tests are below);
    so do rows that do not split into P shards, and a missing card
    before any launch."""
    with pytest.raises(ValueError, match="no axis 'shard'"):
        port.make_distributed_partitioner((2, 2), BKMConfig(k=4),
                                          axis_name="shard")
    run = port.make_distributed_partitioner(4, BKMConfig(k=4), device=CPU)
    with pytest.raises(ValueError, match="4 equal shards"):
        run(np.zeros((10, 2), np.float32), np.ones(10, np.float32))
    # no card: the default device raises before any launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "run", lambda *a, **k: pytest.fail(
        "launched without a device"))
    run = port.make_distributed_partitioner(2, BKMConfig(k=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(np.zeros((8, 2), np.float32))


# ---------------------------------------------------------------------------
# make_distributed_partitioner over a 2-D mesh
# ---------------------------------------------------------------------------

MESH_CFG = {"k": 16, "max_iter": 20, "warmup": False}


def _port_mesh_run(pts, w, **cfg):
    """The port on a (2, 2) ``("data", "model")`` mesh sharded over
    ``data``, inside four thread ranks: rank (d, m) passes the rows of
    its data coordinate d. Every rank's result, its slots gathered over
    its data group (the global arrays of its replica)."""
    out = {}

    def body():
        mesh = make_mesh((2, 2), ("data", "model"), device=CPU)
        run = port.make_distributed_partitioner(mesh, BKMConfig(**cfg),
                                                axis_name="data")
        d, rows = mesh.coordinate("data"), pts.shape[0] // 2
        mine = slice(d * rows, (d + 1) * rows)
        A, rp, rv, centers, infl, imb, dropped = run(pts[mine], w[mine])
        group = mesh.axis_comm("data")
        whole = [group.all_gather(torch.from_numpy(x)).flatten(0, 1).numpy()
                 for x in (A, rp, rv)]
        out[current().rank] = (*whole, centers, infl, imb, dropped,
                               (d, mesh.coordinate("model"), group.size))

    _ranks(body, 4)
    return [out[r] for r in range(4)]


def test_mesh_replicas_equal_devices_p_bit_for_bit():
    """Every replica of the (2, 2) mesh returns the bits of
    ``devices=2`` (the same solve over the data axis), and the ranks sit
    at the row-major coordinates."""
    pts, w = _reference_instance()
    want = _port_run(pts, w, 2, **MESH_CFG)
    got = _port_mesh_run(pts, w, **MESH_CFG)
    assert [g[-1] for g in got] == [(0, 0, 2), (0, 1, 2), (1, 0, 2),
                                    (1, 1, 2)]
    for rank in got:
        for a, b in zip(rank[:7], want[:7]):
            np.testing.assert_array_equal(a, b)


def test_mesh_matches_the_reference_2d_mesh():
    """The reference's partitioner on ``make_compat_mesh((2, 2),
    ("data", "model"))`` with ``axis_name="data"``: the redistribution
    bit-equal on every replica (the reference's ``out_specs``: block ids,
    points and valid flags over 2 * 2 * cap slots), the labels agreeing
    on at least ``AGREE`` of the valid slots, both balanced to the
    reference test's 0.05."""
    pts, w = _reference_instance()
    run = ref.make_distributed_partitioner(
        make_compat_mesh((2, 2), ("data", "model")),
        RefBKMConfig(**MESH_CFG), axis_name="data")
    want = [np.asarray(x) for x in _reference(run, jnp.asarray(pts),
                                              jnp.asarray(w))]
    for A, rp, rv, centers, infl, imb, dropped, _ in _port_mesh_run(
            pts, w, **MESH_CFG):
        for a, b in zip((A, rp, rv, centers, infl), want):
            assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(rp, want[1])
        np.testing.assert_array_equal(rv, want[2])
        assert dropped == int(want[6]) == 0
        assert float(np.mean(A[rv] == want[0][rv])) >= AGREE
        assert imb <= 0.05 and float(want[5]) <= 0.05


def test_mesh_launched_body_returns_the_replicas_global_result():
    """``run``'s launched body on a (2, 2) mesh (what ``run`` outside a
    rank starts on four ranks): every rank returns the global arrays of
    its replica, equal to ``devices=2``'s launched body."""
    pts, w = _instance(2048, 3, 4, "lognormal")
    cfg = BKMConfig(k=8, max_iter=4)
    flat = _ranks(lambda: port._partition_launched(
        pts, w, cfg, device=CPU, return_stats=False), 2)
    out = {}

    def body():
        out[current().rank] = port._partition_launched(
            pts, w, cfg, device=CPU, return_stats=False,
            mesh=make_mesh((2, 2), ("data", "model"), device=CPU),
            axis_name="data")

    _ranks(body, 4)
    for r in range(4):
        for a, b in zip(out[r], flat):
            np.testing.assert_array_equal(a, b)
