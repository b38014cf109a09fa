"""The production mesh and the per-rank dry run (``launch.mesh.
make_production_mesh``, ``launch.dryrun`` over ``pod`` and ``multi``):
the communicator's groups over any axes of an N-D mesh on thread ranks
(the 1-D and 2-D groups as they were), a dimension split over two mesh
axes (pod-major, reduced over exactly those axes), the meta
communicator, and the dry run's records: ``(1, 1)`` through the new path
is the ``single`` record, every rank of ``(2, 2, 2)`` holds the same
memory and wire, the wire extrapolated from 1x and 2x the pattern period
is the full depth's, and ``main`` writes ``pod`` and ``multi`` records.

The argument bytes against the reference's per-device ones:
tests/test_torch_dryrun_mesh_arguments.py; the meta log against real
ranks' counters: tests/test_torch_dryrun_mesh_collectives.py."""
import itertools
import json

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.dist import launch
from repro_torch.dist.comm import (KINDS, current, log_counters,
                                   meta_communicator, using)
from repro_torch.dist.rules import (NamedSharding, local_range,
                                    resolve_rules)
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeCell, input_specs

from test_torch_dryrun import SMOKE_CELLS, smoke_overrides

torch.set_num_threads(1)

POD3 = ("pod", "data", "model")
GRANITE = "granite_moe_3b_a800m"


def _threads(fn, n):
    out = {}

    def body():
        out[current().rank] = fn()

    launch.launch(body, n, device="cpu", threads=True, timeout=120.0)
    return [out[r] for r in range(n)]


# ---------------------------------------------------------------------------
# the production mesh and the communicator over N-D meshes
# ---------------------------------------------------------------------------

def test_production_mesh_shapes():
    pod = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert pod.shape == {"data": 16, "model": 16} and pod.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and multi.device.type == "meta"


def _lines(shape, axes):
    """Each rank's expected group over ``axes`` of the row-major mesh
    ``shape``: the flat ranks that share its other coordinates, in the
    row-major order of their coordinates on ``axes``."""
    flat = np.arange(int(np.prod(shape))).reshape(shape)
    out = {}
    for r in range(flat.size):
        at = np.unravel_index(r, shape)
        idx = tuple(slice(None) if a in axes else at[a]
                    for a in range(len(shape)))
        out[r] = flat[idx].reshape(-1).tolist()
    return out


def test_axes_groups_on_thread_ranks():
    """Every axis and pair of axes of ``(2, 2, 2)`` and both axes of
    ``(2, 4)`` and ``(4,)`` gather each rank's flat rank in the expected
    order; the ranks made the subgroups in one order; a rank's counters
    of its subgroups' collectives add up."""
    shapes = [(2, 2, 2), (2, 4), (4, 2), (8,)]

    def body():
        comm = current()
        got = {}
        me = torch.tensor([comm.rank])
        before = comm.counters(rank=True)
        n = 0
        for shape in shapes:
            view = comm.with_shape(shape)
            for k in range(1, len(shape) + 1):
                for axes in itertools.combinations(range(len(shape)), k):
                    group = view.axes_group(axes)
                    got[shape, axes] = (group.rank, group.all_gather(
                        me).reshape(-1).tolist())
                    n += 1
            if len(shape) == 2:     # the 2-D groups as the partitioner's
                got[shape, "refine"] = view.refine_group().all_gather(
                    me).reshape(-1).tolist()
                n += 1
        after = comm.counters(rank=True)
        return got, after["all_gathers"] - before["all_gathers"], n

    for r, (got, gathers, n) in enumerate(_threads(body, 8)):
        assert gathers == n
        for key, value in got.items():
            shape, axes = key
            if axes == "refine":
                assert value == _lines(shape, (1,))[r]
                continue
            index, line = value
            assert line == _lines(shape, axes)[r]
            assert line[index] == r


def test_mesh_coordinates_and_axis_comms():
    comm, log = meta_communicator((2, 2, 2), 6)      # at (1, 1, 0)
    mesh = make_mesh((2, 2, 2), POD3, device="meta")
    with using(comm):
        assert [mesh.coordinate(a) for a in POD3] == [1, 1, 0]
        assert mesh.coordinate(("pod", "data")) == 3
        assert mesh.coordinate(("data", "pod")) == 3     # mesh order
        assert mesh.extent(("pod", "data")) == 4
        batch = mesh.axis_comm(("pod", "data"))
        assert (batch.size, batch.rank) == (4, 3)
        assert mesh.axis_comm("model").size == 2
        assert mesh.axis_comm(POD3).size == 8
        assert mesh.axis_comm(()) is None
        x = torch.empty(8, device="meta")
        batch.all_reduce(x)
        mesh.axis_comm("model").gather_along(x, 0)
    assert log == [("all_reduce", 32, 4), ("all_gather", 32, 2)]
    assert log_counters(log)["all_gather_bytes"] == 32


def test_meta_reduce_scatter_as_the_card_or_as_cpu_gloo():
    """As the card (NCCL on CUDA): one native reduce-scatter; as CPU
    gloo: the all-reduce of the whole tensor."""
    x = torch.empty(4, 6, device="meta")
    card, card_log = meta_communicator((2,), 0)
    cpu, cpu_log = meta_communicator((2,), 1, backend="gloo",
                                     device_type=None)
    assert card.reduce_scatter(x, 0).shape == (2, 6)
    assert cpu.reduce_scatter(x, 1).shape == (4, 3)
    assert card_log == [("reduce_scatter", 96, 2)]
    assert cpu_log == [("all_reduce", 96, 2)]


# ---------------------------------------------------------------------------
# a dimension over two mesh axes
# ---------------------------------------------------------------------------

def test_dimension_over_pod_and_data_on_thread_ranks():
    """``("pod", "data")`` cuts a dimension into pod x data shards,
    pod-major, whole again by ``whole``; ``act_batch``'s reduction runs
    over exactly those axes (not over ``model``)."""
    def body():
        mesh = make_mesh((2, 2, 2), POD3, device="cpu")
        sh = NamedSharding(mesh, (("pod", "data"), None))
        x = torch.arange(24.0).reshape(8, 3)
        part = sh.local(x)
        rules = resolve_rules(mesh, configs.get_config(GRANITE, smoke=True),
                              "train", batch_size=8)
        total = rules.reduce(torch.tensor([float(current().rank)]),
                             "act_batch")
        return (sh.split_dims(x.shape), sh.shard_shape(x.shape),
                part[:, 0].tolist(), torch.equal(sh.whole(part, x.shape), x),
                local_range(rules, "act_batch", 8), float(total))

    for r, (dims, shard, rows, same, rng, total) in enumerate(
            _threads(body, 8)):
        p, d, m = np.unravel_index(r, (2, 2, 2))
        k = 2 * p + d
        assert dims == [(0, ("pod", "data"))] and shard == (2, 3)
        assert rows == [6.0 * k, 6.0 * k + 3] and same
        assert rng == (2 * k, 2 * k + 2)
        # the ranks of this model coordinate: m, m + 2, m + 4, m + 6
        assert total == 4 * m + 12


def test_dimension_held_whole_where_the_product_does_not_divide():
    mesh = make_mesh((2, 2, 2), POD3, device="meta")
    sh = NamedSharding(mesh, (("pod", "data"), "model"))
    assert sh.split_dims((6, 4)) == [(1, "model")]
    assert sh.shard_shape((6, 4)) == (6, 2)


def test_prefill_batch_argument_is_the_ranks_rows():
    cfg = configs.get_config(GRANITE, smoke=True)
    cell = ShapeCell("prefill_b4", 64, 4, "prefill")
    comm, _ = meta_communicator((2, 2, 2), 5)
    mesh = make_mesh((2, 2, 2), POD3, device="meta")
    rules = resolve_rules(mesh, cfg, "prefill", batch_size=4)
    with using(comm):
        assert input_specs(cfg, cell, rules)["tokens"].shape == (1, 64)
        train = input_specs(cfg, SHAPES["train_4k"], rules)
    assert train["tokens"].shape == (256, 4096)      # the global batch


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", SMOKE_CELLS, ids=lambda c: c.mode)
def test_one_rank_mesh_is_the_single_record(cell):
    ov = smoke_overrides(GRANITE)
    # the first step in a process makes values that later ones reuse
    # (16 bytes of a train step): warm up, then compare
    D.run_cell(GRANITE, cell, "single", do_roofline=False,
               cfg_overrides=ov)
    one = D.run_cell(GRANITE, cell, make_mesh((1, 1), ("data", "model"),
                                              device="meta"),
                     cfg_overrides=ov)
    single = D.run_cell(GRANITE, cell, "single", cfg_overrides=ov)
    assert one["mesh"] == "1x1" and single["mesh"] == "single"
    for rec in (one, single):
        assert rec["n_devices"] == 1 and rec["rank"] == 0
    assert one["memory"] == single["memory"]
    assert one["collectives"] == single["collectives"] == log_counters([])
    assert one["cost"]["wire_per_dev"]["total"] == 0.0
    for key in ("flops_per_dev", "bytes_per_dev", "wire_per_dev"):
        assert one["cost"][key] == single["cost"][key]
    assert one["roofline"] == single["roofline"]


def _same(rec):
    """What every rank holds alike. Not the bytes the ops touch, nor the
    sum of every storage made (``temp_size_in_bytes``): a train step's
    global norm sums a leaf's squares on the ranks at coordinate 0 of
    the axes it is held whole over, and only there."""
    mem = {k: v for k, v in rec["memory"].items()
           if k not in ("largest_at_peak", "temp_size_in_bytes")}
    return (mem, rec["collectives"], rec["cost"]["wire_per_dev"],
            rec["cost"]["flops_per_dev"])


@pytest.mark.parametrize("cell", SMOKE_CELLS, ids=lambda c: c.mode)
def test_every_rank_of_the_pod_mesh_holds_the_same(cell):
    """Every rank of ``(2, 2, 2)``: the same memory (arguments, outputs,
    the liveness peak, the fit), collectives, wire and FLOPs; the wire
    extrapolated from 1x and 2x the pattern period equals the full
    depth's."""
    mesh = make_mesh((2, 2, 2), POD3, device="meta")
    ov = smoke_overrides(GRANITE)
    D.run_cell(GRANITE, cell, mesh, 0, do_roofline=False,
               cfg_overrides=ov)                  # warm: as above
    recs = [D.run_cell(GRANITE, cell, mesh, r, cfg_overrides=ov)
            for r in range(8)]
    assert [r["rank"] for r in recs] == list(range(8))
    assert all(_same(r) == _same(recs[0]) for r in recs[1:])
    rec = recs[0]
    wire = rec["cost"]["wire_per_dev"]
    assert wire["total"] > 0 and sum(wire["counts"].values()) == sum(
        rec["collectives"][key] for _, key in KINDS)
    g, g2 = (rec["unrolled_cost"][k]["wire"] for k in ("g", "2g"))
    reps = rec["n_layers"] // configs.get_config(GRANITE, smoke=True).period
    for k in RL.KINDS + ("total",):
        assert D._extrap(g[k], g2[k], reps) == pytest.approx(wire[k])


def test_main_writes_pod_and_multi_records(tmp_path):
    """``--mesh both``: rank 3 of the 16 x 16 pod with its roofline and
    of the 2 x 16 x 16 mesh with its memory and wire only, as the
    reference's multi records hold no cost."""
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
                "both", "--rank", "3", "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    pod = json.loads((tmp_path /
                      "gemma3_1b__decode_32k__pod.json").read_text())
    multi = json.loads((tmp_path /
                        "gemma3_1b__decode_32k__multi.json").read_text())
    assert (pod["n_devices"], multi["n_devices"]) == (256, 512)
    assert pod["rank"] == multi["rank"] == 3
    for rec in (pod, multi):
        assert rec["ok"] and rec["memory"]["fits_hbm_80g"]
        assert rec["cost"]["wire_per_dev"]["total"] > 0
        assert rec["collectives"]["all_reduces"] > 0
    assert pod["roofline"]["bound_s"] > 0 and "flops_per_dev" in pod["cost"]
    assert "roofline" not in multi and "flops_per_dev" not in multi["cost"]


def test_main_multi_writes_its_record(tmp_path):
    out = tmp_path / "rec.json"
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "rwkv6-3b", "--shape", "long_500k", "--mesh",
                "multi", "--out", str(out)])
    assert e.value.code == 0
    rec = json.loads(out.read_text())
    assert rec["mesh"] == "multi" and rec["n_devices"] == 512
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    assert rec["batch_argument"] == "global"
