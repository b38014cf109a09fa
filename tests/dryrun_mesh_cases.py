"""Shared set-up of the per-rank dry run's tests against the reference
(tests/test_torch_dryrun_mesh_arguments*.py): rank 0 of a ``(data,
model)`` or ``(pod, data, model)`` mesh of the 8 virtual CPU devices, the
port's ``launch.dryrun.build_cell`` on ``meta`` tensors against the
reference's step jitted with ``build_cell``'s placements
(``tests/reference_calls.py::dryrun_argument_bytes``).

Where the reference compiles, a device's argument bytes are the port's
rank's, two parts apart, each computed here and pinned:

* the batch argument (``launch.shapes.BATCH_ARGUMENT``): the port's train
  and serve steps are handed the global batch, the reference's the rows'
  shard; the prefill's are the same rows;
* RWKV's decode state ``s``: a port rank holds its own heads, where the
  reference's spec holds every head (ROADMAP.md queue 3 item 27).

Where the reference's ``jit`` refuses an argument whose dimension the
mesh extent does not divide (``ValueError``), the port holds that
dimension whole and traces the rank (ROADMAP.md departure 28): the
refusal is pinned beside the port's record.
"""
import re

from reference_calls import dryrun_argument_bytes

from repro_torch import configs
from repro_torch.dist.rules import resolve_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.live_mem import tensors
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M

from test_torch_dryrun import SMOKE_CELLS, smoke_overrides  # noqa: F401

MESHES = {(2, 4): ("data", "model"), (2, 2, 2): ("pod", "data", "model")}

# the configs whose every SMOKE cell the reference refuses on each mesh:
# their KV heads (starcoder2 and gemma3 SMOKE 1, the others 2) are not a
# multiple of model = 4, or of model = 2 for one KV head (departure 28)
REFUSED = {(2, 4): {"starcoder2_7b", "phi4_mini_3p8b", "gemma3_1b",
                    "jamba_1p5_large_398b", "llama4_maverick_400b_a17b",
                    "granite_moe_3b_a800m", "internvl2_76b"},
           (2, 2, 2): {"starcoder2_7b", "gemma3_1b",
                       "llama4_maverick_400b_a17b"}}

# the refusal: the argument's key path, its spec and the dimension
REFUSAL = re.compile(r"key path (\S+) was given the sharding .*? which "
                     r"implies that the global size of its dimension (\d+) "
                     r"should be divisible by (\d+), but it is equal to "
                     r"(\d+)", re.S)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def port_rank(arch, cell, shape):
    """(rank 0's record, its batch argument's bytes, the bytes by which
    the reference's spec of RWKV's ``s`` exceeds the port's cut, the
    rank's rules) on the mesh ``shape``."""
    mesh = make_mesh(shape, MESHES[shape], device="meta")
    ov = smoke_overrides(arch)
    rec = D.run_cell(arch, cell, mesh, 0, do_roofline=False,
                     cfg_overrides=ov)
    built, _, cfg = D.build_cell(arch, cell, mesh, 0, cfg_overrides=ov)
    batch = built.args[2] if cell.mode == "decode" else built.args[1]
    s_extra = 0
    if cell.mode == "decode":
        heads = cfg.d_model // cfg.rwkv_head_dim
        for c in built.args[1].values():
            if "s" in c:
                s_extra += _nbytes(c["s"]) * (heads - c["s"].shape[2]) \
                    // c["s"].shape[2]
    rules = resolve_rules(mesh, cfg, cell.mode, batch_size=cell.batch,
                          overrides=configs.sharding_overrides(arch,
                                                               cell.mode))
    return rec, _nbytes(batch), s_extra, rules, cfg


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def check_cell(arch, cell, shape):
    """Rank 0's argument bytes against a device's of the reference on
    the mesh ``shape``, or the reference's refusal beside the port's
    record."""
    rec, batch, s_extra, rules, cfg = port_rank(arch, cell, shape)
    assert rec["ok"] and rec["n_devices"] == 8 and rec["rank"] == 0
    got = rec["memory"]["argument_size_in_bytes"]
    try:
        want, want_batch = dryrun_argument_bytes(arch, cell.seq, cell.batch,
                                                 cell.mode, shape)
    except ValueError as e:
        m = REFUSAL.search(str(e))
        assert m, str(e)
        path, dim, ext, n = m.group(1), *map(int, m.groups()[1:])
        assert n % ext
        keys = re.findall(r"\['([^']+)'\]", path)
        keys = keys[keys.index("layers"):] if "layers" in keys else \
            keys[-1:]
        # the port holds the dimension whole on the rank
        whole = _leaf(M.abstract_params(cfg), keys)
        mine = _leaf(M.abstract_params(cfg, rules), keys)
        assert whole.shape[dim] == mine.shape[dim] == n
        assert rec["memory"]["fits_hbm_80g"] and got > 0
        assert arch in REFUSED[shape] and keys[-1] == "wk"
        return
    assert arch not in REFUSED[shape]
    if D.BATCH_ARGUMENT[cell.mode] == "rank rows":
        assert batch == want_batch
    else:
        assert batch == want_batch * rules.extent("act_batch")
    assert got - batch + s_extra == want - want_batch

